"""The port's configuration.

Two layers:
  * `default_cfg()`, the config tree the dataset CLI reads, with the key
    names of the JAX package's `cfg` and `cfg_from_list` to override its
    entries from `--set KEY VALUE` pairs.  The card machine has no YAML
    reader, so the values of `cfgs/res50.yml` are built in, and
    `LARGE_SCALE` holds what `cfgs/res101_ls.yml` (the CLIs' `--ls`)
    changes on top of them; tests hold both to the JAX package's `cfg`
    after it loads each file.  The JAX CLIs read no other file: `--ls`
    picks res101_ls.yml whatever the backbone, and everything else
    res50.yml (vgg16.yml and res101.yml are never read);
  * module constants, read by the predictor, the trainer and the scripts:
    the tree's defaults (derived from it), and the constants the tree does
    not hold, at the JAX package's defaults.

`postprocess_kwargs(tree)` is the detection postprocess policy.

`dana_config(tree, way, shot, net, backbone)` builds a detector's config
from a tree, as the root `utils.py model_config_kwargs` and `get_model`
do: the trunk of `backbone` (or of `net` where that names one), the
tree's POOLING_MODE, the precision recipe of TPU.COMPUTE_DTYPE,
TPU.ATTENTION_DTYPE and TPU.HEAD_DTYPE (`dtype_or_none`); for DAnA the BA
block on and concat attention, for `cisa` the BA block off;
`config.framework` names the detector.  `get_model(name, way, shot, seed,
net)` mirrors the root `utils.get_model` on the default tree (9 anchors,
before any `--ascale` preset).
"""

from __future__ import annotations

from ast import literal_eval

import numpy as np
import torch

FEAT_STRIDE = 16
# training: optimizer (torch SGD semantics, per-group bias rules)
TRAIN_LEARNING_RATE = 0.001
TRAIN_MOMENTUM = 0.9
TRAIN_WEIGHT_DECAY = 0.0005
TRAIN_DOUBLE_BIAS = True
TRAIN_BIAS_DECAY = False
FIXED_BLOCKS = 1                  # conv1/bn1 and layer1 frozen (RESNET)

# --backbone values -> the trunk
BACKBONES = {'res50': 'resnet50', 'res101': 'resnet101', 'vgg16': 'vgg16'}
# --net values -> the detector: a backbone name is DAnA on that backbone
NETS = {'DAnA': 'DAnA', 'cisa': 'cisa', 'frcnn': 'frcnn', 'fsod': 'fsod',
        'meta': 'meta', 'fgn': 'fgn', **{b: 'DAnA' for b in BACKBONES}}


class AttrDict(dict):
    """dict with attribute access; nested dicts are converted."""

    def __init__(self, d=None):
        super().__init__()
        for k, v in (d or {}).items():
            self[k] = AttrDict(v) if isinstance(v, dict) else v

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value


def default_cfg() -> AttrDict:
    """A fresh config tree: the keys the dataset CLIs read, at the JAX
    package's defaults with `cfgs/res50.yml` applied, except the entries
    marked below.  The file sets TRAIN.WEIGHT_DECAY 1e-4 and DOUBLE_BIAS
    False, where the module constants above keep the engine's defaults."""
    return AttrDict({
        'TRAIN': {
            'LEARNING_RATE': 0.001,
            'MOMENTUM': 0.9,
            'WEIGHT_DECAY': 0.0001,
            'DOUBLE_BIAS': False,
            'BIAS_DECAY': False,
            'USE_FLIPPED': True,
            'SCALES': (600,),
            'MAX_SIZE': 1000,
            'BATCH_SIZE': 128,
            'RPN_BATCHSIZE': 256,
            'RPN_PRE_NMS_TOP_N': 12000,
            'RPN_POST_NMS_TOP_N': 2000,
            'BBOX_NORMALIZE_MEANS': (0.0, 0.0, 0.0, 0.0),
            'BBOX_NORMALIZE_STDS': (0.1, 0.1, 0.2, 0.2),
            'BN_TRAIN': False,
        },
        'TEST': {
            'SCALES': (600,),
            'MAX_SIZE': 1000,
            'NMS': 0.3,
            'RPN_PRE_NMS_TOP_N': 6000,
            'RPN_POST_NMS_TOP_N': 300,
        },
        'TPU': {
            'SIZE_BUCKETS': [(608, 1024), (1024, 608), (704, 704),
                             (608, 1216), (1216, 608)],
            'NMS_MAX_INPUT': 12000,
            'EXACT_QUERY_SCALE': True,
            'EXACT_SUPPORT_SCALE': True,
            'SHIP_UINT8': False,
            # A small cache: each process holds its own, and the JAX
            # package's 2048 MB of decoded images come to GBs of host RAM
            # a process.  The eval path decodes only its support crops
            # through it (several crops may share an image); query images
            # are read once each and bypass it.
            'IMAGE_CACHE_MB': 256,
            # the ResNet stem on host-packed 2x2 space-to-depth queries and
            # supports (data/blob.py s2d_pack, models/resnet.py conv1_s2d):
            # the JAX package's default is True, chosen for its TPU's
            # 128-lane tiles.  The port keeps the direct 7x7/2 stem by
            # default until a benchmark decides: on an H100 cuDNN runs both
            # conv1s at the same speed in float32 and in bf16, a request
            # takes the same time on either stem, and the pack adds host
            # work (PERF.md, "the space-to-depth stem")
            'STEM_S2D': False,
            # int8 serving (dana_tpu_torch/quant.py): the trunk's convs in
            # QUANT_SCOPE ('tail': layer4; 'all': every conv) quantized
            # after the checkpoint loads, and RoIAlign on a map that is not
            # float32 in int8; the dataset CLI only (training runs float)
            'QUANT_INT8': False,
            'QUANT_SCOPE': 'tail',
            # decoded training support crops kept by the episodic loaders
            'SUPPORT_CACHE': 2048,
            # the precision recipe, at the JAX package's defaults: the trunk
            # in COMPUTE_DTYPE, the attention sites in ATTENTION_DTYPE ('':
            # follow COMPUTE_DTYPE), the RPN heads and the R-CNN head in
            # HEAD_DTYPE, float32 parameters throughout.  The JAX package
            # reads PARAM_DTYPE nowhere; the port carries it and ignores it
            'COMPUTE_DTYPE': 'float32',
            'ATTENTION_DTYPE': '',
            'HEAD_DTYPE': 'float32',
            'PARAM_DTYPE': 'float32',
            # recompute the trunk's activations in the training backward
            # (DanaConfig.remat_backbone): less peak memory, the same step
            'REMAT_BACKBONE': False,
        },
        'RESNET': {'FIXED_BLOCKS': 1},
        'MAX_NUM_GT_BOXES': 20,
        'ANCHOR_SCALES': [8, 16, 32],
        'ANCHOR_RATIOS': [0.5, 1, 2],
        'PIXEL_MEANS': np.array([[[102.9801, 115.9465, 122.7717]]]),
        'POOLING_MODE': 'align',
        'POOLING_SIZE': 7,
        'DATA_DIR': 'data',
    })


# what cfgs/res101_ls.yml sets beyond cfgs/res50.yml's values (--ls)
LARGE_SCALE = ['TRAIN.SCALES', '(800,)', 'TEST.SCALES', '(800,)',
               'TEST.MAX_SIZE', '1200', 'TEST.RPN_POST_NMS_TOP_N', '1000']


# The tree's defaults as the constants the predictor, the trainer and the
# scripts read: derived, so that the tree is the one place they are set.
_DEFAULTS = default_cfg()
# BGR Caffe pixel means, subtracted from raw uint8 queries on the device
PIXEL_MEANS = tuple(float(v) for v in _DEFAULTS.PIXEL_MEANS.ravel())
POOLING_SIZE = _DEFAULTS.POOLING_SIZE             # RoIAlign bins a side
TEST_RPN_POST_NMS_TOP_N = _DEFAULTS.TEST.RPN_POST_NMS_TOP_N
TRAIN_BATCH_SIZE = _DEFAULTS.TRAIN.BATCH_SIZE     # rois per image


def postprocess_kwargs(c: AttrDict | None = None) -> dict:
    """The detection postprocess of the tree `c` (the built-in tree when
    None): NMS at TEST.NMS, and the JAX package's fixed score threshold and
    detections per image, which its config does not expose."""
    c = _DEFAULTS if c is None else c
    return dict(score_thresh=0.05, nms_thresh=c.TEST.NMS, max_per_image=100)


def cfg_from_list(c: AttrDict, cfg_list) -> None:
    """Set entries of the tree `c` from a flat [key, value, ...] list, each
    value coerced by `ast.literal_eval` as the JAX package's
    `cfg_from_list` does (a string that is no literal stays a string)."""
    if len(cfg_list) % 2:
        raise ValueError(f'config overrides come in KEY VALUE pairs: '
                         f'{cfg_list}')
    for k, v in zip(cfg_list[0::2], cfg_list[1::2]):
        *path, leaf = k.split('.')
        d = c
        for sub in path:
            if not isinstance(d.get(sub), dict):
                raise KeyError(f'{k} is not a config key of the port')
            d = d[sub]
        if leaf not in d or isinstance(d[leaf], dict):
            raise KeyError(f'{k} is not a config key of the port')
        try:
            value = literal_eval(v)
        except (ValueError, SyntaxError):
            value = v
        old = d[leaf]
        if isinstance(old, tuple) and isinstance(value, list):
            value = tuple(value)
        if isinstance(old, float) and isinstance(value, int):
            value = float(value)
        if type(value) is not type(old):
            raise ValueError(f'type {type(value).__name__} does not match '
                             f'{type(old).__name__} for config key {k}')
        d[leaf] = value


# TPU.*_DTYPE names -> torch dtype names (the root `utils.py` `_dt_or_none`
# table)
DTYPE_NAMES = {'bfloat16': 'bfloat16', 'bf16': 'bfloat16', 'float32': 'float32',
          'f32': 'float32'}


def dtype_or_none(name: str):
    """A TPU.*_DTYPE value -> its torch dtype; '' -> None (follow
    COMPUTE_DTYPE).  An unknown name raises: a mistyped precision setting
    must not run in float32 unnoticed."""
    if not name:
        return None
    if name not in DTYPE_NAMES:
        raise ValueError(f'unknown dtype {name!r} for a TPU.*_DTYPE setting '
                         f'(use one of {sorted(DTYPE_NAMES)})')
    return getattr(torch, DTYPE_NAMES[name])


def dana_config(c: AttrDict, way: int, shot: int, net: str = 'DAnA',
                backbone: str = 'res50'):
    """The config of the detector `net` (a key of NETS) on the trunk
    `backbone` (a key of BACKBONES; a backbone name as `net` overrides it)
    from the tree `c` (root `utils.py` `model_config_kwargs` and
    `get_model` for the fields the port has)."""
    from dana_tpu_torch.models import dana
    if net not in NETS:
        raise ValueError(f'network {net!r} is not part of the port '
                         f'(have {sorted(NETS)})')
    if net in BACKBONES:
        backbone = net
    if backbone not in BACKBONES:
        raise ValueError(f'backbone {backbone!r} is not one of '
                         f'{sorted(BACKBONES)}')
    framework = NETS[net]
    return dana.DanaConfig(
        n_way=way, n_shot=shot, arch=BACKBONES[backbone],
        framework=framework, semantic_enhance=framework == 'DAnA',
        pooling_mode=c.POOLING_MODE,
        anchor_scales=tuple(c.ANCHOR_SCALES),
        anchor_ratios=tuple(c.ANCHOR_RATIOS),
        pooling_size=c.POOLING_SIZE,
        train_pre_nms=c.TRAIN.RPN_PRE_NMS_TOP_N,
        train_post_nms=c.TRAIN.RPN_POST_NMS_TOP_N,
        test_pre_nms=c.TEST.RPN_PRE_NMS_TOP_N,
        test_post_nms=c.TEST.RPN_POST_NMS_TOP_N,
        nms_cap=c.TPU.NMS_MAX_INPUT,
        rois_per_image=c.TRAIN.BATCH_SIZE,
        rpn_batchsize=c.TRAIN.RPN_BATCHSIZE,
        bbox_normalize_means=tuple(c.TRAIN.BBOX_NORMALIZE_MEANS),
        bbox_normalize_stds=tuple(c.TRAIN.BBOX_NORMALIZE_STDS),
        bn_train=c.TRAIN.BN_TRAIN,
        compute_dtype=dtype_or_none(c.TPU.COMPUTE_DTYPE) or torch.float32,
        attention_dtype=dtype_or_none(c.TPU.ATTENTION_DTYPE),
        head_dtype=dtype_or_none(c.TPU.HEAD_DTYPE),
        remat_backbone=c.TPU.REMAT_BACKBONE,
        roi_align_int8=bool(c.TPU.QUANT_INT8),
        pixel_means=tuple(np.asarray(c.PIXEL_MEANS).ravel().tolist()))


def get_model(name='res50', way=2, shot=3, seed=1996):
    """-> (DanaConfig, numpy param tree in the JAX layout), the `way`-way
    `shot`-shot detector `name` (a key of NETS; `config.framework` names
    it, and a backbone name such as 'res101' or 'vgg16' picks DAnA on that
    trunk) on the default tree with random weights from `seed`, drawn as
    the JAX package draws them.  The target-layer fields the tree does not
    set keep DanaConfig's defaults, which are the JAX package's."""
    from dana_tpu_torch.models import frameworks
    config = dana_config(default_cfg(), way, shot, name)
    return config, frameworks.init_params(config, seed=seed)
