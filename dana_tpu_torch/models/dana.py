"""DAnA (Dual-Awareness Attention) few-shot detector, eval and training
forward (port of dana_tpu/models/dana.py).

`DAnA` holds the weights as modules named after the reference torch
modules (`backbone.layer1.0.conv1`, `rpn_adapt_q_layer`,
`output_score_layer.linear1`, ...).  The functions mirror the JAX ones
and take NHWC tensors: queries [B,H,W,3], support images [B,n,H,W,3],
support features [B,n,h,w,C], C = `DanaConfig.feat_dim` (1024 on a
bottleneck ResNet, 512 on VGG16).  `trunk` (the RPN, proposals, target
layers and RoI pooling), `query_features`, `support_maps`, `roi_tail` and
`rcnn_losses` are shared with the other frameworks (models/frameworks.py);
`DanaConfig.framework` names the detector a config belongs to (`cisa` is
DAnA without the BA block).

The trunk is a bottleneck ResNet (50, 101, 152) or VGG16 (`arch`, a key
of TRUNKS): its module's `base` gives the stride-16 base features, its
`tail` the RoI tail (layer4 and its spatial mean, or fc6 / fc7).  The rois
are pooled by `pooling_mode`: RoIAlign (K2 when serving; in training K3 on
a float32 map, K2-bf16 on a bf16 one), RoIPool (ops/roi_pool.py) or the
affine crop (ops/grid_sample.py).

Supports are 320 px: stride-16 features give 20x20 = 400 support tokens
at the RPN site; RoIs and pooled supports give 7x7 = 49 tokens at the
RoI site.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from dana_tpu_torch.core.anchors import generate_anchors, shifted_anchors
from dana_tpu_torch.models import layers as L
from dana_tpu_torch.models import resnet, vgg
from dana_tpu_torch.models import rpn as rpn_lib
from dana_tpu_torch.models.losses import (hard_mined_pair_ce,
                                          masked_cross_entropy,
                                          smooth_l1_loss)
from dana_tpu_torch.ops.cisa_attention import cisa_attention_shots
from dana_tpu_torch.ops.grid_sample import roi_crop_pool
from dana_tpu_torch.ops.roi_align import (roi_align, roi_align_int8,
                                          roi_align_train)
from dana_tpu_torch.ops.roi_pool import roi_pool
from dana_tpu_torch.parallel.distributed import current_group
from dana_tpu_torch.utils.device import device_table, host_table


FRAMEWORKS = ('DAnA', 'cisa', 'frcnn', 'fsod', 'meta', 'fgn')
# the detectors that encode each class's supports once and serve from
# that cache; the others take each request's support images
CACHED_SUPPORTS = ('DAnA', 'cisa')


class Trunk(NamedTuple):
    """A trunk of the detector: its module (members `base(x)`,
    `tail(pooled)`, `feat_dim`, `tail_dim`, `tail_range` and
    `freeze(fixed_blocks)`), its numpy tree from a seed drawn as the JAX
    package draws it, and its base and RoI-tail channels."""
    module: Callable[[], nn.Module]
    init_params: Callable[[int], dict]
    feat_dim: int
    tail_dim: int


# the detector's trunks: the bottleneck ResNets (the heads take 1024 base
# channels, which a basic-block ResNet's layer3 does not give) and VGG16
TRUNKS = {a: Trunk(functools.partial(resnet.ResNet, a),
                   functools.partial(resnet.init_params, a), *resnet.dims(a))
          for a, (kind, _) in resnet.ARCH_LAYERS.items()
          if kind == 'bottleneck'}
TRUNKS['vgg16'] = Trunk(vgg.VGG16, vgg.init_params, vgg.FEAT_DIM,
                        vgg.TAIL_DIM)
ARCHES = tuple(TRUNKS)
POOLING_MODES = ('align', 'pool', 'crop')
# how an attention site merges the query map with its attended supports:
# concatenated channels (2C) or their product (C)
ATTENTION_TYPES = ('concat', 'product')


# the activation dtypes the precision recipe takes
DTYPES = (torch.float32, torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class DanaConfig:
    """Model configuration (field names and defaults of the JAX
    DanaConfig).

    `attention_type` 'concat' feeds the RPN and the R-CNN head's transform
    the query map concatenated with its attended supports (2C channels),
    'product' their elementwise product (C channels).  `pos_encoding` adds
    the sinusoidal tables to the support tokens at both sites and to the
    RoI tokens.  `remat_backbone` recomputes the trunk's activations in
    the training backward instead of keeping them (DAnA and cisa, as in
    the JAX package): the same losses and gradients for less memory.

    Precision (the JAX package's recipe): the parameters stay float32 and
    every layer casts them to its input's dtype.  The trunk runs in
    `compute_dtype`; both attention sites (projections and the CISA core)
    in `attention_dt`; the RPN heads and the whole R-CNN head (RoI tail
    included) in `head_dt`; None follows compute_dtype.  Each is float32
    or bfloat16.  The proposal layer and the postprocess take float32."""
    n_way: int = 2
    n_shot: int = 3
    attention_type: str = 'concat'          # one of ATTENTION_TYPES
    rpn_reduce_dim: int = 256
    rcnn_reduce_dim: int = 256
    gamma: float = 0.1                      # channel_gamma (BA block)
    unary_gamma: float = 0.1
    semantic_enhance: bool = False          # use_BA_block
    pos_encoding: bool = True
    arch: str = 'resnet50'                  # one of ARCHES
    pooling_size: int = 7
    pooling_mode: str = 'align'             # one of POOLING_MODES
    anchor_scales: tuple = (4, 8, 16, 32)
    anchor_ratios: tuple = (0.5, 1.0, 2.0)
    feat_stride: int = 16
    train_pre_nms: int = 12000
    train_post_nms: int = 2000
    test_pre_nms: int = 6000
    test_post_nms: int = 300
    rpn_nms_thresh: float = 0.7
    nms_cap: int = 12000
    pixel_means: tuple = (102.9801, 115.9465, 122.7717)
    # target layers (training)
    rpn_batchsize: int = 256
    rpn_fg_fraction: float = 0.5
    rpn_pos_overlap: float = 0.7
    rpn_neg_overlap: float = 0.3
    rois_per_image: int = 128
    fg_fraction: float = 0.25
    fg_thresh: float = 0.5
    bg_thresh_hi: float = 0.5
    bg_thresh_lo: float = 0.1
    bbox_normalize_means: tuple = (0.0, 0.0, 0.0, 0.0)
    bbox_normalize_stds: tuple = (0.1, 0.1, 0.2, 0.2)
    # FGN's head BatchNorms normalise with batch statistics in training
    # (cfg.TRAIN.BN_TRAIN)
    bn_train: bool = False
    # the detector these weights and this forward belong to: 'DAnA',
    # 'cisa' (DAnA without the BA block), or a sibling of
    # models/frameworks.py ('frcnn', 'fsod', 'meta', 'fgn')
    framework: str = 'DAnA'
    compute_dtype: torch.dtype = torch.float32
    attention_dtype: torch.dtype | None = None
    head_dtype: torch.dtype | None = None
    remat_backbone: bool = False
    # int8 serving (TPU.QUANT_INT8): RoIAlign on a map that is not float32
    # takes the JAX package's int8 path (`ops/roi_align.py roi_align_int8`)
    roi_align_int8: bool = False

    def __post_init__(self):
        for name in ('compute_dtype', 'attention_dtype', 'head_dtype'):
            dt = getattr(self, name)
            if dt not in DTYPES and (dt is not None
                                     or name == 'compute_dtype'):
                raise ValueError(f'{name} {dt} is not one of {DTYPES}')
        if self.arch not in ARCHES:
            raise NotImplementedError(
                f'the detector has no {self.arch} trunk (have {ARCHES}; a '
                'basic-block ResNet\'s layer3 gives 256 channels, the heads '
                'take 1024)')
        if self.framework not in FRAMEWORKS:
            raise ValueError(f'framework {self.framework!r} is not one of '
                             f'{FRAMEWORKS}')
        if self.attention_type not in ATTENTION_TYPES:
            raise ValueError(f'attention_type {self.attention_type!r} is not '
                             f'one of {ATTENTION_TYPES}')
        if self.pooling_mode not in POOLING_MODES:
            raise ValueError(f'pooling_mode {self.pooling_mode!r} is not one '
                             f'of {POOLING_MODES}')
        if self.arch == 'vgg16' and self.framework not in CACHED_SUPPORTS:
            raise ValueError(
                f'{self.framework} on vgg16: the siblings are ResNet-only, as '
                'in the JAX package, whose sibling inits draw '
                'resnet.init_params(config.arch) with 1024 channels '
                '(dana_tpu/models/frameworks.py) and raise KeyError for '
                'vgg16')

    @property
    def attention_dt(self):
        return (self.compute_dtype if self.attention_dtype is None
                else self.attention_dtype)

    @property
    def head_dt(self):
        return (self.compute_dtype if self.head_dtype is None
                else self.head_dtype)

    @property
    def num_anchors(self):
        return len(self.anchor_scales) * len(self.anchor_ratios)

    @property
    def feat_dim(self):
        """Base-feature channels: 512 for VGG16, 1024 for the ResNets."""
        return TRUNKS[self.arch].feat_dim

    @property
    def tail_dim(self):
        """RoI-tail features: fc7's 4096 for VGG16, layer4's 2048 else."""
        return TRUNKS[self.arch].tail_dim

    @property
    def rpn_din(self):
        """Channels into the RPN and the R-CNN head's transform."""
        return 2 * self.feat_dim if self.attention_type == 'concat' \
            else self.feat_dim


class DAnA(nn.Module):
    """The detector's weights; `forward` below runs them."""

    def __init__(self, config: DanaConfig):
        super().__init__()
        d = config.feat_dim
        self.backbone = TRUNKS[config.arch].module()
        self.rpn_unary_layer = L.Linear(d, 1)
        self.rcnn_unary_layer = L.Linear(d, 1)
        self.rpn_adapt_q_layer = L.Linear(d, config.rpn_reduce_dim)
        self.rpn_adapt_k_layer = L.Linear(d, config.rpn_reduce_dim)
        self.rcnn_adapt_q_layer = L.Linear(d, config.rcnn_reduce_dim)
        self.rcnn_adapt_k_layer = L.Linear(d, config.rcnn_reduce_dim)
        self.RCNN_rpn = rpn_lib.RPN(config.rpn_din, config.num_anchors)
        self.rcnn_transform_layer = L.Linear(config.rpn_din, 64)
        self.output_score_layer = nn.Module()
        self.output_score_layer.linear1 = L.Linear(
            64 * config.pooling_size ** 2, 1024)
        self.output_score_layer.linear2 = L.Linear(1024, 2)
        self.RCNN_bbox_pred = L.Linear(config.tail_dim, 4)
        if config.semantic_enhance:
            self.rpn_channel_k_layer = L.Linear(d, 1)


@functools.lru_cache(maxsize=8)
def positional_encoding(length: int, d_model: int = 1024) -> np.ndarray:
    """Sinusoidal PE table [length, d_model] float32 (cached: never
    write to it)."""
    pe = np.zeros((length, d_model), np.float32)
    position = np.arange(length, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                 * -(math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


def init_params(config: DanaConfig, seed: int = 0,
                backbone_params=None) -> dict:
    """Random-init numpy param tree in the JAX layout, drawn exactly as
    the JAX package draws it (normal std 0.01 heads, bbox_pred std 0.001,
    zero biases, torch-default uniform FFN linears)."""
    rng = np.random.default_rng(seed)
    d = config.feat_dim

    def lin(cin, cout, std=0.01):
        return L.init_linear(rng, cin, cout, std=std)

    if backbone_params is None:
        backbone_params = TRUNKS[config.arch].init_params(seed)
    p = {
        'backbone': backbone_params,
        'rpn_unary_layer': lin(d, 1),
        'rcnn_unary_layer': lin(d, 1),
        'rpn_adapt_q_layer': lin(d, config.rpn_reduce_dim),
        'rpn_adapt_k_layer': lin(d, config.rpn_reduce_dim),
        'rcnn_adapt_q_layer': lin(d, config.rcnn_reduce_dim),
        'rcnn_adapt_k_layer': lin(d, config.rcnn_reduce_dim),
        'RCNN_rpn': rpn_lib.init_rpn_params(rng, config.rpn_din,
                                            config.num_anchors),
        'rcnn_transform_layer': L.init_linear_uniform(rng, config.rpn_din, 64),
        'output_score_layer': {
            'linear1': L.init_linear_uniform(
                rng, 64 * config.pooling_size ** 2, 1024),
            'linear2': L.init_linear_uniform(rng, 1024, 2),
        },
        'RCNN_bbox_pred': lin(config.tail_dim, 4, std=0.001),
    }
    if config.semantic_enhance:
        p['rpn_channel_k_layer'] = lin(d, 1)
    return p


def _pe(length, like, dtype):
    """The positional table [length, C] of like's channels C, computed on
    like's device as `positional_encoding` computes it (float64, then
    float32; equal to its table on the CPU, tests/test_torch_port_serve.py)
    and rounded to `dtype` (the JAX tables are in attention_dt); kept per
    device (`device_table`)."""
    d, dev = like.shape[-1], like.device

    def build():
        position = torch.arange(length, dtype=torch.float64,
                                device=dev)[:, None]
        div = torch.exp(torch.arange(0, d, 2, dtype=torch.float64,
                                     device=dev)
                        * -(math.log(10000.0) / d))
        angle = position * div
        pe = torch.stack([torch.sin(angle), torch.cos(angle)], dim=-1)
        return pe.reshape(length, d).float().to(dtype)
    return device_table(('pe', length, d, dtype), dev, build)


def _token_softmax(x):
    """The softmax over the support tokens (dim -2) in float32, rounded
    once to x's dtype, as XLA computes a bf16 softmax inside one fusion.
    torch's CPU kernel for bf16 over a non-last dim rounds on the way, so
    its probabilities no longer sum to one within an ulp; in training the
    unary layer's weight gradient, a sum over the tokens whose terms cancel
    but for the map's variation, then takes that error times the support
    map's common mode (ten times JAX's own bf16 deviation on the CPU)."""
    return torch.softmax(x.float(), dim=-2).to(x.dtype)


def _cisa_attention(q_tokens, s_tokens, model: DAnA, prefix, reduce_dim,
                    unary_gamma, se_layer=None, gamma=0.1):
    """CISA block: query tokens attend support tokens, mean over shots.

    q_tokens [B, (R,) Nq, C] (q centering per group of Nq tokens);
    s_tokens [B, shot, Ns, C] (PE applied), projected once per shot.
    Returns [B, (R,) Nq, C]."""
    if se_layer is not None:
        # BA block: spatial softmax -> global channel vector -> residual
        w = _token_softmax(se_layer(s_tokens))                  # [B,S,Ns,1]
        glob = torch.sum(w * s_tokens, dim=-2, keepdim=True)     # [B,S,1,C]
        s_tokens = s_tokens + gamma * F.leaky_relu(glob)

    q = getattr(model, f'{prefix}_adapt_q_layer')(q_tokens)
    q = q - q.mean(dim=-2, keepdim=True)
    k = getattr(model, f'{prefix}_adapt_k_layer')(s_tokens)
    k = k - k.mean(dim=-2, keepdim=True)
    unary = getattr(model, f'{prefix}_unary_layer')(s_tokens)
    unary_sm = _token_softmax(unary)[..., 0]                    # [B,S,Ns]

    b, d = q.shape[0], q.shape[-1]
    extra, nq = q.shape[1:-2], q.shape[-2]
    out = cisa_attention_shots(
        q.reshape(b, -1, d).contiguous(), k.contiguous(),
        s_tokens.contiguous(), unary_sm.contiguous(),
        1.0 / math.sqrt(reduce_dim), unary_gamma)
    return out.reshape(b, *extra, nq, s_tokens.shape[-1])


def _support_tokens(feat, pe):
    """[B, shot, h, w, C] -> [B, shot, h*w, C] (+ PE unless pe is None)."""
    b, s, h, w, c = feat.shape
    tokens = feat.reshape(b, s, h * w, c)
    return tokens if pe is None else tokens + pe[:h * w]


def roi_tail(model, pooled_feat):
    """The trunk's RoI tail: [B,R,7,7,C] -> [B,R,tail_dim] (range
    `dana.rcnn_head.layer4`, or `dana.rcnn_head.fc` on VGG16)."""
    b, r, ph, pw, c = pooled_feat.shape
    with record_function(f'dana.rcnn_head.{model.backbone.tail_range}'):
        tail = model.backbone.tail(pooled_feat.reshape(b * r, ph, pw, c))
    return tail.reshape(b, r, -1)


def rcnn_head(model: DAnA, config: DanaConfig, pooled_feat, support_pooled):
    """pooled_feat [B,R,7,7,C], support_pooled [B,shot,7,7,C] ->
    (bbox_pred [B,R,4], cls_prob [B,R,2], cls_score [B,R,2]), in
    config.head_dt (the RoI tail too)."""
    pooled_feat = pooled_feat.to(config.head_dt)
    bbox_pred = model.RCNN_bbox_pred(roi_tail(model, pooled_feat))
    return (bbox_pred, *rcnn_scores(model, config, pooled_feat,
                                     support_pooled))


def rcnn_scores(model: DAnA, config: DanaConfig, pooled_feat,
                support_pooled):
    """The R-CNN head's attention and score part: pooled_feat
    [B,R,7,7,C] attends support_pooled [B,shot,7,7,C] -> (cls_prob
    [B,R,2], cls_score [B,R,2]): the tokens in config.attention_dt, the
    rest in config.head_dt."""
    b, r, ph, pw, c = pooled_feat.shape
    adt, hdt = config.attention_dt, config.head_dt
    pe = _pe(config.pooling_size ** 2, pooled_feat, adt) \
        if config.pos_encoding else None
    q = pooled_feat.reshape(b, r, ph * pw, c).to(adt)
    if pe is not None:
        q = q + pe[:ph * pw]
    s_tokens = _support_tokens(support_pooled.to(adt), pe)
    dense = _cisa_attention(q, s_tokens, model, 'rcnn',
                            config.rcnn_reduce_dim, config.unary_gamma)
    q, dense = q.to(hdt), dense.to(hdt)
    tw = model.rcnn_transform_layer
    if config.attention_type == 'concat':
        # concat([q, dense]) @ W^T == q @ W[:, :C]^T + dense @ W[:, C:]^T,
        # without the [B,R,49,2C] concat
        w = tw.weight.to(hdt)
        corr = (q @ w[:, :c].T + dense @ w[:, c:].T
                + tw.bias.to(hdt))                              # [B,R,49,64]
    else:
        corr = tw(q * dense)
    x = corr.reshape(b, r, -1)             # token-major: index q*64 + d
    x = F.relu(model.output_score_layer.linear1(x))
    cls_score = model.output_score_layer.linear2(x)
    return torch.softmax(cls_score, dim=-1), cls_score


def support_size(support_ims):
    """The (H, W) the supports [B, n, H, W, C] stand for: their own, or
    for a space-to-depth packing (C 12) the canvas's (H - 3) * 2."""
    sh, sw, c = support_ims.shape[2:]
    return ((sh - 3) * 2, (sw - 3) * 2) if c == 12 else (sh, sw)


def support_maps(model, config: DanaConfig, support_ims, remat=False):
    """support_ims [B, n, H, W, 3] (H, W >= 224), or their space-to-depth
    packing [B, n, H/2+3, W/2+3, 12] (data/blob.py `s2d_pack_any`) -> the
    trunk's maps [B, n, H/16, W/16, C] in config.compute_dtype; `remat`
    as in `trunk_base`."""
    b, n, sh, sw, c = support_ims.shape
    eh, ew = support_size(support_ims)
    if eh < 224 or ew < 224:
        raise ValueError(f'support images must be >= 224px (got {eh}x{ew}):'
                         ' the fixed AvgPool2d(14) needs a >= 14x14 map')
    feats = trunk_base(model, support_ims.reshape(b * n, sh, sw, c)
                       .to(config.compute_dtype), remat)
    return feats.reshape(b, n, *feats.shape[1:])


def pool14(x):
    """AvgPool2d(14, 1) over an NHWC map [N, h, w, C], in x's dtype with
    float32 sums (PyTorch's average pool; XLA on the CPU sums a bfloat16
    window in bfloat16)."""
    return L.nchw_to_nhwc(L.avg_pool(L.nhwc_to_nchw(x), 14, 1))


def extract_support_feats(model: DAnA, config: DanaConfig, support_ims,
                          remat=False):
    """support_ims [B, n, H, W, 3] (H, W >= 224, or packed as
    `support_maps` takes them) -> (feat [B,n,h,w,C],
    pooled [B,n,h-13,w-13,C]): the trunk, then AvgPool2d(14, 1), in
    config.compute_dtype; `remat` as in `trunk_base`."""
    feats = support_maps(model, config, support_ims, remat)
    b, n = feats.shape[:2]
    pooled = pool14(feats.reshape(b * n, *feats.shape[2:]))
    return feats, pooled.reshape(b, n, *pooled.shape[1:])


def rpn_attention(model: DAnA, config: DanaConfig, base_feat, support_feat):
    """base_feat [B,h,w,C] attends support_feat [B,shot,hs,ws,C] (tokens
    in config.attention_dt) -> the correlation feature in config.head_dt:
    the concat [B,h,w,2C], or under product attention base_feat times the
    attended supports [B,h,w,C]."""
    b, h, w, c = base_feat.shape
    adt, hdt = config.attention_dt, config.head_dt
    pe = _pe(20 * 20, base_feat, adt) if config.pos_encoding else None
    s_tokens = _support_tokens(support_feat.to(adt), pe)
    se = model.rpn_channel_k_layer if config.semantic_enhance else None
    dense = _cisa_attention(base_feat.reshape(b, h * w, c).to(adt), s_tokens,
                            model, 'rpn', config.rpn_reduce_dim,
                            config.unary_gamma, se, config.gamma)
    dense = dense.reshape(b, h, w, c).to(hdt)
    if config.attention_type == 'concat':
        return torch.cat([base_feat.to(hdt), dense], dim=-1)
    return base_feat.to(hdt) * dense


def prep_query_images(config: DanaConfig, im_data):
    """uint8 BGR pixels get the Caffe mean subtraction on the device (the
    means tiled 4 times over a space-to-depth packing's 12 channels);
    float inputs pass through."""
    if im_data.dtype == torch.uint8:
        reps = im_data.shape[-1] // 3
        return im_data.float() - host_table(
            np.tile(np.asarray(config.pixel_means, np.float64), reps),
            im_data.device)
    return im_data


def trunk_base(model, x, remat=False):
    """The trunk's base features of x; with `remat`, under activation
    checkpointing: the backward recomputes the trunk's forward instead of
    keeping its activations.  The frozen stages' parameters need no
    gradient either way, so they do no backward work."""
    if remat and torch.is_grad_enabled():
        return checkpoint(model.backbone.base, x, use_reentrant=False)
    return model.backbone.base(x)


def query_features(model, config: DanaConfig, im_data, remat=False):
    """The queries' base features [B, H/16, W/16, C] in
    config.compute_dtype (`dana.trunk` range): the mean subtraction in
    float32, then one cast; `remat` as in `trunk_base`."""
    with record_function('dana.trunk'):
        return trunk_base(model, prep_query_images(config, im_data).float()
                          .to(config.compute_dtype), remat)


def trunk(model, config: DanaConfig, base_feat, corr_feat, im_info,
          training=False, gt_boxes=None, draws=None, rpn_gt_boxes=None):
    """The middle every detector shares (the JAX package's
    `frameworks.trunk`): the RPN on the conditioned map `corr_feat`
    [B,h',w',C'], its anchors on that map's grid, the proposals, at
    training the target layers and the RPN losses, and the rois pooled
    from `base_feat` [B,h,w,C] (`pool_rois`).  The RPN heads run in
    config.head_dt, the proposal layer in float32; the rois are rounded
    to base_feat's dtype for the pooling and the pooled features cross
    into config.head_dt, while the returned rois stay float32.

    Training takes gt_boxes [B,G,5] and the target layers' draws (a dict
    keyed by `rpn.DRAW_KEYS`, or a torch.Generator to draw them from);
    `rpn_gt_boxes` (Meta R-CNN's all-class gt) replaces gt_boxes for the
    anchor targets only.  -> dict(rois, roi_mask, pooled [B,R,P,P,C]; at
    training also rois_label, rois_target, rois_in_w, rois_out_w,
    rpn_loss_cls, rpn_loss_box)."""
    _, fh, fw, _ = corr_feat.shape
    with record_function('dana.rpn_heads'):
        logits, probs_fg, deltas = rpn_lib.rpn_forward(
            corr_feat.to(config.head_dt), model.RCNN_rpn)

    with record_function('dana.proposals'):
        base_anchor = generate_anchors(ratios=config.anchor_ratios,
                                       scales=np.array(config.anchor_scales))
        anchors = shifted_anchors(fh, fw, config.feat_stride, base_anchor,
                                  device=base_feat.device)
        rois, _, roi_mask = rpn_lib.proposal_layer(
            probs_fg.detach().float(), deltas.detach().float(), anchors,
            im_info.float(),
            pre_nms_top_n=(config.train_pre_nms if training
                           else config.test_pre_nms),
            post_nms_top_n=(config.train_post_nms if training
                            else config.test_post_nms),
            nms_thresh=config.rpn_nms_thresh, nms_cap=config.nms_cap)

    if not training:
        return dict(rois=rois, roi_mask=roi_mask,
                    pooled=pool_rois(config, base_feat, rois))

    with record_function('dana.targets'):
        if isinstance(draws, torch.Generator):
            # under data parallelism every rank draws the global batch's
            # draws from the same generator and keeps its rows
            g = current_group()
            draws = rpn_lib.uniform_draws(
                draws, probs_fg.shape[0] * g.size, probs_fg.shape[1],
                rois.shape[1] + gt_boxes.shape[1], config.rois_per_image)
            draws = {k: g.rows(v) for k, v in draws.items()}
        with torch.no_grad():
            labels, at_targets, at_in_w, at_out_w = rpn_lib.anchor_target(
                anchors, gt_boxes if rpn_gt_boxes is None else rpn_gt_boxes,
                im_info, draws['anchor_fg'], draws['anchor_bg'],
                batch_rois=config.rpn_batchsize,
                fg_fraction=config.rpn_fg_fraction,
                pos_overlap=config.rpn_pos_overlap,
                neg_overlap=config.rpn_neg_overlap)
            rois, rois_label, rois_target, rois_in_w, rois_out_w = \
                rpn_lib.proposal_target(
                    rois, gt_boxes, draws['roi_fg_rank'], draws['roi_fg'],
                    draws['roi_bg'], rois_per_image=config.rois_per_image,
                    fg_fraction=config.fg_fraction,
                    fg_thresh=config.fg_thresh,
                    bg_thresh_hi=config.bg_thresh_hi,
                    bg_thresh_lo=config.bg_thresh_lo,
                    bbox_normalize_means=config.bbox_normalize_means,
                    bbox_normalize_stds=config.bbox_normalize_stds)

    pooled = pool_rois(config, base_feat, rois, training=True)
    with record_function('dana.losses'):
        rpn_loss_cls = masked_cross_entropy(logits, labels, labels != -1)
        rpn_loss_box = smooth_l1_loss(deltas, at_targets, at_in_w[..., None],
                                      at_out_w[..., None], sigma=3.0)
    return dict(rois=rois, roi_mask=roi_mask, pooled=pooled,
                rois_label=rois_label, rois_target=rois_target,
                rois_in_w=rois_in_w, rois_out_w=rois_out_w,
                rpn_loss_cls=rpn_loss_cls, rpn_loss_box=rpn_loss_box)


def pool_rois(config: DanaConfig, base_feat, rois, training=False):
    """base_feat [B,h,w,C], float32 rois [B,R,5] -> [B,R,P,P,C] in
    config.head_dt, pooled by config.pooling_mode from the rois rounded to
    base_feat's dtype, each mode in its own range: RoIAlign
    (`dana.roi_align`; K2 when serving, or under config.roi_align_int8 on
    a map that is not float32 the int8 RoIAlign; in training K3 from the
    axis weights on a float32 map, K2-bf16 on a bf16 one), RoIPool
    (`dana.roi_pool`) or the affine crop (`dana.roi_crop`)."""
    p, scale = config.pooling_size, 1.0 / config.feat_stride
    rois = rois.to(base_feat.dtype)
    with record_function(f'dana.roi_{config.pooling_mode}'):
        if config.pooling_mode == 'pool':
            pooled = roi_pool(base_feat, rois, p, scale)
        elif config.pooling_mode == 'crop':
            pooled = roi_crop_pool(base_feat, rois, p, scale)
        elif training:
            pooled = roi_align_train(base_feat, rois, p, scale)
        elif config.roi_align_int8 and base_feat.dtype != torch.float32:
            pooled = roi_align_int8(base_feat, rois, p, scale)
        else:
            pooled = roi_align(base_feat, rois.contiguous(), p, scale)
    return pooled.to(config.head_dt)


def rcnn_losses(out, bbox_pred, cls_score, neg_score):
    """The episodic R-CNN losses every support-conditioned detector shares:
    smooth L1 on the positive branch's boxes, flattened over all rois of
    all images (the reference's default dim=[1] on [B*R, 4]), and the
    hard-mined pair cross-entropy of the positive and negative scores."""
    return dict(
        rcnn_loss_bbox=smooth_l1_loss(
            bbox_pred.reshape(-1, 4), out['rois_target'].reshape(-1, 4),
            out['rois_in_w'].reshape(-1, 4), out['rois_out_w'].reshape(-1, 4),
            sigma=1.0, reduce_dims=(1,)),
        rcnn_loss_cls=hard_mined_pair_ce(cls_score, out['rois_label'],
                                         neg_score))


def forward(model: DAnA, config: DanaConfig, im_data, im_info,
            support_ims=None, support_feats=None, training=False,
            gt_boxes=None, draws=None):
    """The detector's forward, eval (training=False) or the episodic
    training forward with its four losses.

    im_data [B,H,W,3] float (mean-subtracted) or uint8; im_info [B,3]
    (height, width, scale); either support_ims [B, n, H, W, 3] (n =
    n_shot at eval, n_way * n_shot in training: the first n_shot are the
    positive class, the rest negative) or precomputed support_feats
    (feat [B,n,h,w,C], pooled [B,n,7,7,C]).  On a ResNet trunk the
    queries and supports may come as their space-to-depth packing
    [..., H/2+3, W/2+3, 12] (TPU.STEM_S2D): the stem takes either.

    Eval returns dict(rois [B,R,5], cls_prob [B,R,2], bbox_pred [B,R,4],
    cls_score [B,R,2], roi_mask [B,R]).

    Training also takes gt_boxes [B,G,5] (zero rows pad; class column 1)
    and the target layers' uniform draws: a dict keyed by
    `rpn.DRAW_KEYS`, or a torch.Generator to draw them from
    (`rpn.uniform_draws`).  It returns the sampled rois [B,S,5],
    rois_label [B,S], the positive branch's cls_prob / bbox_pred /
    cls_score, the negative branch's neg_cls_score and rpn_loss_cls,
    rpn_loss_box, rcnn_loss_cls, rcnn_loss_bbox.  The RoIs are pooled by
    `pool_rois` (in align mode `roi_align_train`: K3 on the card, or
    K2-bf16 on a bf16 map), and the
    negative supports run only the head's attention and score part: their
    box branch would feed no loss.

    Each stage runs inside a `torch.profiler.record_function` range named
    `dana.<stage>`, so one profiled request gives the time of every stage
    (tools/profile_torch_predict.py); the ranges cost nothing measurable
    when no profiler runs."""
    if training and config.n_way < 2:
        raise ValueError('training needs n_way >= 2: a negative support way '
                         f'feeds the hard-mined loss (got n_way='
                         f'{config.n_way})')
    remat = training and config.remat_backbone
    base_feat = query_features(model, config, im_data, remat)
    if support_feats is None:
        with record_function('dana.support_trunk'):
            support_feats = extract_support_feats(model, config, support_ims,
                                                  remat)
    sup_feat, sup_pooled = support_feats
    pos_feat = sup_feat[:, :config.n_shot]
    pos_pooled = sup_pooled[:, :config.n_shot]

    with record_function('dana.rpn_attention'):
        corr = rpn_attention(model, config, base_feat, pos_feat)
    out = trunk(model, config, base_feat, corr, im_info, training, gt_boxes,
                draws)

    with record_function('dana.rcnn_head'):
        bbox_pred, cls_prob, cls_score = rcnn_head(model, config,
                                                   out['pooled'], pos_pooled)
        if not training:
            return dict(rois=out['rois'], cls_prob=cls_prob,
                        bbox_pred=bbox_pred, cls_score=cls_score,
                        roi_mask=out['roi_mask'])
        neg_pooled = sup_pooled[:, config.n_shot:
                                config.n_way * config.n_shot]
        _, neg_score = rcnn_scores(model, config, out['pooled'], neg_pooled)

    with record_function('dana.losses'):
        losses = rcnn_losses(out, bbox_pred, cls_score, neg_score)
    return dict(losses, rpn_loss_cls=out['rpn_loss_cls'],
                rpn_loss_box=out['rpn_loss_box'], rois=out['rois'],
                rois_label=out['rois_label'], cls_prob=cls_prob,
                bbox_pred=bbox_pred, cls_score=cls_score,
                neg_cls_score=neg_score)
