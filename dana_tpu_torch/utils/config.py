"""The port's configuration.

Two layers:
  * `default_cfg()`, the config tree the dataset CLI reads, with the key
    names of the JAX package's `cfg` and `cfg_from_list` to override its
    entries from `--set KEY VALUE` pairs.  The card machine has no YAML
    reader, so the values of `cfgs/res50.yml` are built in (`--ls`, the
    ResNet-101 file, is refused by the CLI); tests hold the tree to the JAX
    package's `cfg` after it loads that file;
  * module constants, read by the predictor, the trainer and the scripts:
    the tree's defaults (derived from it), and the constants the tree does
    not hold, at the JAX package's defaults.

`postprocess_kwargs(tree)` is the detection postprocess policy.

`dana_config(tree, way, shot)` builds the DAnA detector's config from a
tree, as the root `utils.py model_config_kwargs` does: ResNet-50 trunk, BA
block on, concat attention, RoIAlign pooling, float32 compute.
`get_model('res50', way, shot)` mirrors the root `utils.get_model` on the
default tree (9 anchors, before any `--ascale` preset).
"""

from __future__ import annotations

from ast import literal_eval

import numpy as np

FEAT_STRIDE = 16
# training: optimizer (torch SGD semantics, per-group bias rules)
TRAIN_LEARNING_RATE = 0.001
TRAIN_MOMENTUM = 0.9
TRAIN_WEIGHT_DECAY = 0.0005
TRAIN_DOUBLE_BIAS = True
TRAIN_BIAS_DECAY = False
FIXED_BLOCKS = 1                  # conv1/bn1 and layer1 frozen (RESNET)

_ARCHS = {'res50': 'resnet50'}


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
    """A fresh config tree: the keys the dataset inference path reads, at
    the JAX package's defaults with `cfgs/res50.yml` applied, except the
    entries marked below."""
    return AttrDict({
        'TRAIN': {
            'SCALES': (600,),
            'MAX_SIZE': 1000,
            'BATCH_SIZE': 128,
            'RPN_BATCHSIZE': 256,
            'RPN_PRE_NMS_TOP_N': 12000,
            'RPN_POST_NMS_TOP_N': 2000,
            'BBOX_NORMALIZE_MEANS': (0.0, 0.0, 0.0, 0.0),
            'BBOX_NORMALIZE_STDS': (0.1, 0.1, 0.2, 0.2),
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
            # the port has no space-to-depth stem: False here (the JAX
            # package defaults to True), and the CLI refuses True
            'STEM_S2D': False,
            'QUANT_INT8': False,
        },
        'MAX_NUM_GT_BOXES': 20,
        'ANCHOR_SCALES': [8, 16, 32],
        'ANCHOR_RATIOS': [0.5, 1, 2],
        'PIXEL_MEANS': np.array([[[102.9801, 115.9465, 122.7717]]]),
        'POOLING_MODE': 'align',
        'POOLING_SIZE': 7,
        'DATA_DIR': 'data',
    })


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


def dana_config(c: AttrDict, way: int, shot: int, name: str = 'res50'):
    """The DAnA detector's DanaConfig from the tree `c` (root `utils.py`
    `model_config_kwargs` for the fields the port has)."""
    from dana_tpu_torch.models import dana
    if name not in _ARCHS:
        raise ValueError(f'network {name!r} is not part of the port '
                         f'(have {sorted(_ARCHS)})')
    if c.POOLING_MODE != 'align':
        raise ValueError(f'POOLING_MODE {c.POOLING_MODE!r}: the port pools '
                         'with RoIAlign only')
    return dana.DanaConfig(
        n_way=way, n_shot=shot, arch=_ARCHS[name], semantic_enhance=True,
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
        pixel_means=tuple(np.asarray(c.PIXEL_MEANS).ravel().tolist()))


def get_model(name='res50', way=2, shot=3, seed=1996):
    """-> (DanaConfig, numpy param tree in the JAX layout), the `way`-way
    `shot`-shot DAnA detector on the default tree with random weights from
    `seed`.  The target-layer fields the tree does not set keep
    DanaConfig's defaults, which are the JAX package's."""
    from dana_tpu_torch.models import dana
    config = dana_config(default_cfg(), way, shot, name)
    return config, dana.init_params(config, seed=seed)
