"""DAnA (Dual-Awareness Attention) few-shot detector, eval path (port of
dana_tpu/models/dana.py).

`DAnA` holds the weights as modules named after the reference torch
modules (`backbone.layer1.0.conv1`, `rpn_adapt_q_layer`,
`output_score_layer.linear1`, ...).  The functions mirror the JAX ones
and take NHWC tensors: queries [B,H,W,3], support images [B,n,H,W,3],
support features [B,n,h,w,1024].

Supports are 320 px: stride-16 features give 20x20 = 400 support tokens
at the RPN site; RoIs and pooled supports give 7x7 = 49 tokens at the
RoI site.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from dana_tpu_torch.core.anchors import generate_anchors, shifted_anchors
from dana_tpu_torch.models import layers as L
from dana_tpu_torch.models import resnet
from dana_tpu_torch.models import rpn as rpn_lib
from dana_tpu_torch.ops.cisa_attention import cisa_attention_shots
from dana_tpu_torch.ops.roi_align import roi_align


@dataclasses.dataclass(frozen=True)
class DanaConfig:
    """Model configuration of the eval path (field names and defaults of
    the JAX DanaConfig).  The port runs float32, concat attention,
    positional encoding on both attention sites and RoIAlign pooling on a
    bottleneck ResNet: the JAX fields that select otherwise are not
    ported."""
    n_way: int = 2
    n_shot: int = 3
    rpn_reduce_dim: int = 256
    rcnn_reduce_dim: int = 256
    gamma: float = 0.1                      # channel_gamma (BA block)
    unary_gamma: float = 0.1
    semantic_enhance: bool = False          # use_BA_block
    arch: str = 'resnet50'
    pooling_size: int = 7
    anchor_scales: tuple = (4, 8, 16, 32)
    anchor_ratios: tuple = (0.5, 1.0, 2.0)
    feat_stride: int = 16
    test_pre_nms: int = 6000
    test_post_nms: int = 300
    rpn_nms_thresh: float = 0.7
    nms_cap: int = 12000
    pixel_means: tuple = (102.9801, 115.9465, 122.7717)
    bbox_normalize_means: tuple = (0.0, 0.0, 0.0, 0.0)
    bbox_normalize_stds: tuple = (0.1, 0.1, 0.2, 0.2)

    def __post_init__(self):
        if self.arch not in resnet.ARCH_LAYERS:
            raise NotImplementedError(f'the port has no {self.arch} trunk')

    @property
    def num_anchors(self):
        return len(self.anchor_scales) * len(self.anchor_ratios)

    feat_dim = 1024     # stride-16 base features of a bottleneck ResNet
    tail_dim = 2048     # layer4

    @property
    def rpn_din(self):
        return 2 * self.feat_dim


class DAnA(nn.Module):
    """The detector's weights; `forward` below runs them."""

    def __init__(self, config: DanaConfig):
        super().__init__()
        d = config.feat_dim
        self.backbone = resnet.ResNet(config.arch)
        self.rpn_unary_layer = nn.Linear(d, 1)
        self.rcnn_unary_layer = nn.Linear(d, 1)
        self.rpn_adapt_q_layer = nn.Linear(d, config.rpn_reduce_dim)
        self.rpn_adapt_k_layer = nn.Linear(d, config.rpn_reduce_dim)
        self.rcnn_adapt_q_layer = nn.Linear(d, config.rcnn_reduce_dim)
        self.rcnn_adapt_k_layer = nn.Linear(d, config.rcnn_reduce_dim)
        self.RCNN_rpn = rpn_lib.RPN(config.rpn_din, config.num_anchors)
        self.rcnn_transform_layer = nn.Linear(config.rpn_din, 64)
        self.output_score_layer = nn.Module()
        self.output_score_layer.linear1 = nn.Linear(
            64 * config.pooling_size ** 2, 1024)
        self.output_score_layer.linear2 = nn.Linear(1024, 2)
        self.RCNN_bbox_pred = nn.Linear(config.tail_dim, 4)
        if config.semantic_enhance:
            self.rpn_channel_k_layer = nn.Linear(d, 1)


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

    def torch_default_lin(cin, cout):
        bound = 1.0 / math.sqrt(cin)
        return {'weight': rng.uniform(-bound, bound, (cin, cout)).astype(np.float32),
                'bias': rng.uniform(-bound, bound, (cout,)).astype(np.float32)}

    if backbone_params is None:
        backbone_params = resnet.init_params(config.arch, seed=seed)
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
        'rcnn_transform_layer': torch_default_lin(config.rpn_din, 64),
        'output_score_layer': {
            'linear1': torch_default_lin(64 * config.pooling_size ** 2,
                                         1024),
            'linear2': torch_default_lin(1024, 2),
        },
        'RCNN_bbox_pred': lin(config.tail_dim, 4, std=0.001),
    }
    if config.semantic_enhance:
        p['rpn_channel_k_layer'] = lin(d, 1)
    return p


def _pe(length, like):
    return torch.tensor(positional_encoding(length), device=like.device,
                        dtype=like.dtype)


def _cisa_attention(q_tokens, s_tokens, model: DAnA, prefix, reduce_dim,
                    unary_gamma, se_layer=None, gamma=0.1):
    """CISA block: query tokens attend support tokens, mean over shots.

    q_tokens [B, (R,) Nq, C] (q centering per group of Nq tokens);
    s_tokens [B, shot, Ns, C] (PE applied), projected once per shot.
    Returns [B, (R,) Nq, C]."""
    if se_layer is not None:
        # BA block: spatial softmax -> global channel vector -> residual
        w = torch.softmax(se_layer(s_tokens), dim=-2)           # [B,S,Ns,1]
        glob = torch.sum(w * s_tokens, dim=-2, keepdim=True)     # [B,S,1,C]
        s_tokens = s_tokens + gamma * F.leaky_relu(glob)

    q = getattr(model, f'{prefix}_adapt_q_layer')(q_tokens)
    q = q - q.mean(dim=-2, keepdim=True)
    k = getattr(model, f'{prefix}_adapt_k_layer')(s_tokens)
    k = k - k.mean(dim=-2, keepdim=True)
    unary = getattr(model, f'{prefix}_unary_layer')(s_tokens)
    unary_sm = torch.softmax(unary, dim=-2)[..., 0]             # [B,S,Ns]

    b, d = q.shape[0], q.shape[-1]
    extra, nq = q.shape[1:-2], q.shape[-2]
    out = cisa_attention_shots(
        q.reshape(b, -1, d).contiguous(), k.contiguous(),
        s_tokens.contiguous(), unary_sm.contiguous(),
        1.0 / math.sqrt(reduce_dim), unary_gamma)
    return out.reshape(b, *extra, nq, s_tokens.shape[-1])


def _support_tokens(feat, pe):
    """[B, shot, h, w, C] -> [B, shot, h*w, C] + PE."""
    b, s, h, w, c = feat.shape
    return feat.reshape(b, s, h * w, c) + pe[:h * w]


def rcnn_head(model: DAnA, config: DanaConfig, pooled_feat, support_pooled):
    """pooled_feat [B,R,7,7,1024], support_pooled [B,shot,7,7,1024] ->
    (bbox_pred [B,R,4], cls_prob [B,R,2], cls_score [B,R,2])."""
    b, r, ph, pw, c = pooled_feat.shape
    with record_function('dana.rcnn_head.layer4'):
        tail = resnet.top_forward(pooled_feat.reshape(b * r, ph, pw, c),
                                  model.backbone).mean(dim=(1, 2))
    bbox_pred = model.RCNN_bbox_pred(tail.reshape(b, r, -1))

    pe = _pe(config.pooling_size ** 2, pooled_feat)
    q = pooled_feat.reshape(b, r, ph * pw, c) + pe[:ph * pw]
    s_tokens = _support_tokens(support_pooled, pe)
    dense = _cisa_attention(q, s_tokens, model, 'rcnn',
                            config.rcnn_reduce_dim, config.unary_gamma)
    # concat([q, dense]) @ W^T == q @ W[:, :C]^T + dense @ W[:, C:]^T,
    # without the [B,R,49,2C] concat
    tw = model.rcnn_transform_layer
    corr = (q @ tw.weight[:, :c].T + dense @ tw.weight[:, c:].T
            + tw.bias)                                          # [B,R,49,64]
    x = corr.reshape(b, r, -1)             # token-major: index q*64 + d
    x = F.relu(model.output_score_layer.linear1(x))
    cls_score = model.output_score_layer.linear2(x)
    return bbox_pred, torch.softmax(cls_score, dim=-1), cls_score


def extract_support_feats(model: DAnA, config: DanaConfig, support_ims):
    """support_ims [B, n, H, W, 3] (H, W >= 224) -> (feat [B,n,h,w,1024],
    pooled [B,n,h-13,w-13,1024]): the trunk, then AvgPool2d(14, 1)."""
    b, n, sh, sw, c = support_ims.shape
    if sh < 224 or sw < 224:
        raise ValueError(f'support images must be >= 224px (got {sh}x{sw}):'
                         ' the fixed AvgPool2d(14) needs a >= 14x14 map')
    feats = resnet.base_forward(
        support_ims.reshape(b * n, sh, sw, c).float(), model.backbone)
    pooled = L.nchw_to_nhwc(L.avg_pool(L.nhwc_to_nchw(feats), 14, 1))
    return (feats.reshape(b, n, *feats.shape[1:]),
            pooled.reshape(b, n, *pooled.shape[1:]))


def rpn_attention(model: DAnA, config: DanaConfig, base_feat, support_feat):
    """base_feat [B,h,w,1024] attends support_feat [B,shot,hs,ws,1024]
    -> concat correlation feature [B,h,w,2048]."""
    b, h, w, c = base_feat.shape
    hs, ws = support_feat.shape[2:4]
    s_tokens = _support_tokens(support_feat, _pe(20 * 20, base_feat))
    se = model.rpn_channel_k_layer if config.semantic_enhance else None
    dense = _cisa_attention(base_feat.reshape(b, h * w, c), s_tokens, model,
                            'rpn', config.rpn_reduce_dim, config.unary_gamma,
                            se, config.gamma)
    return torch.cat([base_feat, dense.reshape(b, h, w, c)], dim=-1)


def prep_query_images(config: DanaConfig, im_data):
    """uint8 BGR pixels get the Caffe mean subtraction on the device;
    float inputs pass through."""
    if im_data.dtype == torch.uint8:
        means = torch.tensor(config.pixel_means, dtype=torch.float32,
                             device=im_data.device)
        return im_data.float() - means
    return im_data


def _pool_rois(config: DanaConfig, base_feat, rois):
    return roi_align(base_feat, rois.contiguous(), config.pooling_size,
                     1.0 / config.feat_stride)


def forward(model: DAnA, config: DanaConfig, im_data, im_info,
            support_ims=None, support_feats=None):
    """Eval forward (training=False of the JAX forward).

    im_data [B,H,W,3] float (mean-subtracted) or uint8; im_info [B,3]
    (height, width, scale); either support_ims [B, n_shot, H, W, 3] or
    precomputed support_feats (feat [B,n,h,w,C], pooled [B,n,7,7,C]).
    Returns dict(rois [B,R,5], cls_prob [B,R,2], bbox_pred [B,R,4],
    cls_score [B,R,2], roi_mask [B,R]).

    Each stage runs inside a `torch.profiler.record_function` range named
    `dana.<stage>`, so one profiled request gives the time of every stage
    (tools/profile_torch_predict.py); the ranges cost nothing measurable
    when no profiler runs."""
    with record_function('dana.trunk'):
        im_data = prep_query_images(config, im_data).float()
        base_feat = resnet.base_forward(im_data, model.backbone)
    _, fh, fw, _ = base_feat.shape

    if support_feats is None:
        with record_function('dana.support_trunk'):
            support_feats = extract_support_feats(model, config, support_ims)
    sup_feat, sup_pooled = support_feats
    pos_feat = sup_feat[:, :config.n_shot]
    pos_pooled = sup_pooled[:, :config.n_shot]

    with record_function('dana.rpn_attention'):
        corr = rpn_attention(model, config, base_feat, pos_feat)
    with record_function('dana.rpn_heads'):
        _, probs_fg, deltas = rpn_lib.rpn_forward(corr, model.RCNN_rpn)

    with record_function('dana.proposals'):
        base_anchor = generate_anchors(ratios=config.anchor_ratios,
                                       scales=np.array(config.anchor_scales))
        anchors = shifted_anchors(fh, fw, config.feat_stride, base_anchor,
                                  device=base_feat.device)
        rois, _, roi_mask = rpn_lib.proposal_layer(
            probs_fg, deltas, anchors, im_info.float(),
            pre_nms_top_n=config.test_pre_nms,
            post_nms_top_n=config.test_post_nms,
            nms_thresh=config.rpn_nms_thresh, nms_cap=config.nms_cap)

    with record_function('dana.roi_align'):
        pooled = _pool_rois(config, base_feat, rois)           # [B,R,7,7,C]
    with record_function('dana.rcnn_head'):
        bbox_pred, cls_prob, cls_score = rcnn_head(model, config, pooled,
                                                   pos_pooled)
    return dict(rois=rois, cls_prob=cls_prob, bbox_pred=bbox_pred,
                cls_score=cls_score, roi_mask=roi_mask)
