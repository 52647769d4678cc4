"""The four sibling detectors DAnA is measured against, on the port (port of
dana_tpu/models/frameworks.py): Faster R-CNN, FSOD (attention RPN and
multi-relation head), Meta R-CNN (PRN channel reweighting) and FGN
(support-gated RPN and convolutional score head).

Each shares DAnA's skeleton through `dana.trunk`: a bottleneck ResNet trunk
(50, 101 or 152; VGG16 is refused, as the JAX package's siblings are
ResNet-only), a detector-specific conditioning of the RPN's input, the
RPN, the proposals and target layers, the rois pooled from the query's
base features by the config's pooling mode (RoIAlign: K2 when serving, K3
in training), and a detector-specific head.  The episodic
siblings run their score head on the positive supports and, in training,
on the negative ones, with DAnA's smooth-L1 and hard-mined pair losses.
Their convolutions and linears are torch's own (cuDNN and cuBLAS on the
card; float32 without TF32 unless the config's precision recipe asks for
bfloat16), as the JAX package computes them in XLA: the trunk, the
support maps and the RPN's conditioning in config.compute_dtype, the RPN
heads and everything after the RoI pooling in config.head_dt.

Modules carry the reference's names (`RCNN_rpn`, `global_fc_1`,
`RCNN_cls_score.0`, `bn1`, ...), so a JAX param tree or a reference state
dict fills them by name (utils/weights.py).  The numpy `init_*` functions
draw as the JAX package's do: the trunk from `resnet.init_params(seed)`,
then the heads from one `default_rng(seed)` in the JAX order.

`build`, `init_params` and `forward` dispatch on `config.framework` over
these and DAnA / cisa (models/dana.py).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from dana_tpu_torch.models import dana
from dana_tpu_torch.models import layers as L
from dana_tpu_torch.models import resnet
from dana_tpu_torch.models import rpn as rpn_lib
from dana_tpu_torch.models.dana import DanaConfig
from dana_tpu_torch.models.losses import smooth_l1_loss

NUM_CLASSES = 2          # Faster R-CNN's classes: background, foreground


def _conv_w(rng, kh, kw, cin, cout):
    return {'weight': rng.normal(0, 0.01, (kh, kw, cin, cout))
            .astype(np.float32)}


def _heads(config: DanaConfig, seed, backbone_params, make):
    rng = np.random.default_rng(seed)
    if backbone_params is None:
        backbone_params = resnet.init_params(config.arch, seed=seed)
    return {'backbone': backbone_params, **make(rng)}


class _Detector(nn.Module):
    """The trunk and RPN every sibling has (RPN on 1024 channels)."""

    def __init__(self, config: DanaConfig):
        super().__init__()
        self.backbone = resnet.ResNet(config.arch)
        self.RCNN_rpn = rpn_lib.RPN(config.feat_dim, config.num_anchors)


def _support_maps(model, config, support_ims):
    with record_function('dana.support_trunk'):
        return dana.support_maps(model, config, support_ims)


def _shot_means(config, maps, training):
    """[B, n, ...] per-shot maps -> (positive mean, negative mean or None):
    the first n_shot shots are the positive class, the next
    (n_way - 1) * n_shot negative."""
    if training and config.n_way < 2:
        raise ValueError('training needs n_way >= 2: a negative support way '
                         f'feeds the hard-mined loss (got n_way='
                         f'{config.n_way})')
    pos = maps[:, :config.n_shot].mean(dim=1)
    neg = maps[:, config.n_shot:config.n_way * config.n_shot].mean(dim=1) \
        if training else None
    return pos, neg


def _finish_episodic(out, config, bbox_pred, score_fn, pos, neg, training):
    """The score head on the positive supports (and at training the
    negative ones), which cross into config.head_dt here, and the shared
    R-CNN losses; the box branch does not depend on the supports, so it
    is computed once, by the caller."""
    with record_function('dana.rcnn_head'):
        cls_score = score_fn(pos.to(config.head_dt))
        res = dict(rois=out['rois'], roi_mask=out['roi_mask'],
                   bbox_pred=bbox_pred, cls_score=cls_score,
                   cls_prob=torch.softmax(cls_score, dim=-1))
        if not training:
            return res
        neg_score = score_fn(neg.to(config.head_dt))
    with record_function('dana.losses'):
        losses = dana.rcnn_losses(out, bbox_pred, cls_score, neg_score)
    return dict(res, **losses, neg_cls_score=neg_score,
                rpn_loss_cls=out['rpn_loss_cls'],
                rpn_loss_box=out['rpn_loss_box'],
                rois_label=out['rois_label'])


# ----------------------------------------------------------------- FSOD

class FSOD(_Detector):
    """Attention-RPN and the global / local / patch relation heads."""

    def __init__(self, config: DanaConfig):
        super().__init__(config)
        d = config.feat_dim
        self.global_fc_1 = L.Linear(2 * d, d)
        self.global_fc_2 = L.Linear(d, d)
        self.global_cls_score = L.Linear(d, 2)
        self.corr_conv = L.Conv2d(d, d, 1, bias=False)
        self.corr_cls_score = L.Linear(d, 2)
        self.patch_conv_1 = L.Conv2d(2 * d, d // 4, 1, bias=False)
        self.patch_conv_2 = L.Conv2d(d // 4, d // 4, 3, bias=False)
        self.patch_conv_3 = L.Conv2d(d // 4, d, 1, bias=False)
        self.patch_cls_score = L.Linear(d, 2)
        self.RCNN_bbox_pred = L.Linear(config.tail_dim, 4)


def init_fsod_params(config: DanaConfig, seed=0, backbone_params=None):
    d = config.feat_dim

    def make(rng):
        def lin(cin, cout, std=0.01):
            return L.init_linear(rng, cin, cout, std=std)
        return {
            'RCNN_rpn': rpn_lib.init_rpn_params(rng, d, config.num_anchors),
            'global_fc_1': lin(2 * d, d), 'global_fc_2': lin(d, d),
            'global_cls_score': lin(d, 2),
            'corr_conv': _conv_w(rng, 1, 1, d, d),
            'corr_cls_score': lin(d, 2),
            'patch_conv_1': _conv_w(rng, 1, 1, 2 * d, d // 4),
            'patch_conv_2': _conv_w(rng, 3, 3, d // 4, d // 4),
            'patch_conv_3': _conv_w(rng, 1, 1, d // 4, d),
            'patch_cls_score': lin(d, 2),
            'RCNN_bbox_pred': lin(config.tail_dim, 4, std=0.001),
        }
    return _heads(config, seed, backbone_params, make)


def fsod_correlation(base_feat, kernels):
    """Each image's base features [B, h, w, C] correlated channel by
    channel with its own 7x7 kernel [B, 7, 7, C], VALID: [B, h-6, w-6, C]
    (one grouped convolution over the batch's B*C channels)."""
    b, h, w, c = base_feat.shape
    kh, kw = kernels.shape[1:3]
    x = base_feat.permute(0, 3, 1, 2).reshape(1, b * c, h, w)
    k = kernels.permute(0, 3, 1, 2).reshape(b * c, 1, kh, kw)
    y = F.conv2d(x, k, groups=b * c)
    return y.reshape(b, c, h - kh + 1, w - kw + 1).permute(0, 2, 3, 1)


def _conv(x, conv):
    """A module's convolution on an NHWC tensor [N, h, w, C] -> NHWC."""
    return L.nchw_to_nhwc(conv(L.nhwc_to_nchw(x)))


def _avg3(x):
    return L.nchw_to_nhwc(L.avg_pool(L.nhwc_to_nchw(x), 3, 1))


def fsod_forward(model: FSOD, config: DanaConfig, im_data, im_info,
                 support_ims, training=False, gt_boxes=None, draws=None):
    """FSOD: the shot-mean support kernels (AvgPool 14 of the mean
    support map) correlated with the query's base features before the RPN,
    whose grid is therefore 6 cells smaller each way (its anchors start at
    the grid's origin, as the reference places them); the three relation
    scores summed and divided by 10."""
    base_feat = dana.query_features(model, config, im_data)
    pos, neg = _shot_means(config, _support_maps(model, config, support_ims),
                           training)
    pos_pooled = dana.pool14(pos)                      # [B, 7, 7, C]
    neg_pooled = dana.pool14(neg) if training else None
    with record_function('dana.rpn_attention'):
        corr = fsod_correlation(base_feat, pos_pooled)
    out = dana.trunk(model, config, base_feat, corr, im_info, training,
                     gt_boxes, draws)
    pooled = out['pooled']
    b, r, ph, pw, c = pooled.shape
    with record_function('dana.rcnn_head'):
        bbox_pred = model.RCNN_bbox_pred(dana.roi_tail(model, pooled))
        roi_corr = _conv(pooled.reshape(b * r, ph, pw, c), model.corr_conv)
        roi_corr = roi_corr.reshape(b, r, ph, pw, c)

    def score(sup):
        s = sup[:, None].expand(b, r, *sup.shape[1:])
        cat = torch.cat([pooled, s], dim=-1)               # [B,R,7,7,2C]
        g = F.relu(model.global_fc_1(cat.mean(dim=(2, 3))))
        g = model.global_cls_score(F.relu(model.global_fc_2(g)))
        corr_vec = torch.einsum('brhwc,bhwc->brc', roi_corr,
                                _conv(sup, model.corr_conv))
        loc = model.corr_cls_score(corr_vec)
        x = cat.reshape(b * r, ph, pw, 2 * c)
        x = _avg3(F.relu(_conv(x, model.patch_conv_1)))
        x = F.relu(_conv(x, model.patch_conv_2))
        x = _avg3(F.relu(_conv(x, model.patch_conv_3)))
        patch = model.patch_cls_score(x.reshape(b, r, -1))
        return (g + loc + patch) / 10.0                    # soft_gamma

    return _finish_episodic(out, config, bbox_pred, score, pos_pooled,
                            neg_pooled, training)


# ----------------------------------------------------------- Meta R-CNN

class MetaRCNN(_Detector):
    """The PRN's channel attention on the 2048-d RoI features."""

    def __init__(self, config: DanaConfig):
        super().__init__(config)
        self.RCNN_cls_score = nn.Sequential(L.Linear(config.tail_dim, 2))
        self.RCNN_bbox_pred = L.Linear(config.tail_dim, 4)


def init_meta_params(config: DanaConfig, seed=0, backbone_params=None):
    def make(rng):
        return {
            'RCNN_rpn': rpn_lib.init_rpn_params(rng, config.feat_dim,
                                                config.num_anchors),
            'RCNN_cls_score': {'0': L.init_linear_uniform(rng, config.tail_dim,
                                                       2)},
            'RCNN_bbox_pred': L.init_linear(rng, config.tail_dim, 4,
                                            std=0.001),
        }
    return _heads(config, seed, backbone_params, make)


def meta_forward(model: MetaRCNN, config: DanaConfig, im_data, im_info,
                 support_ims, training=False, gt_boxes=None,
                 all_gt_boxes=None, draws=None):
    """Meta R-CNN: the PRN (support trunk, a 2x2 / stride 2 max pool,
    layer4, the sigmoid of the spatial mean) gives each shot a 2048-d
    vector; the RPN runs on the plain base features and, in training,
    takes its anchor targets from `all_gt_boxes` (every class's gt), the
    roi sampling from the episode's gt_boxes; the score head reweights
    the RoI features' channels by the shot-mean vector."""
    base_feat = dana.query_features(model, config, im_data)
    maps = _support_maps(model, config, support_ims)
    b, n = maps.shape[:2]
    with record_function('dana.support_trunk'):
        f = F.max_pool2d(L.nhwc_to_nchw(maps.reshape(b * n, *maps.shape[2:])),
                         2, 2)
        f = model.backbone.layer4(f)
        vecs = torch.sigmoid(f.mean(dim=(2, 3))).reshape(b, n, -1)
    pos_vec, neg_vec = _shot_means(config, vecs, training)
    out = dana.trunk(model, config, base_feat, base_feat, im_info, training,
                     gt_boxes, draws, rpn_gt_boxes=all_gt_boxes)
    with record_function('dana.rcnn_head'):
        tail = dana.roi_tail(model, out['pooled'])
        bbox_pred = model.RCNN_bbox_pred(tail)

    def score(vec):
        return model.RCNN_cls_score(tail * vec[:, None, :])

    return _finish_episodic(out, config, bbox_pred, score, pos_vec,
                            neg_vec, training)


# ------------------------------------------------------------------ FGN

class FGN(_Detector):
    """The support-vector gate before the RPN and the conv / BN score head.
    bn1 and bn2 train their affine (unlike the trunk's frozen BNs); their
    running statistics are buffers."""

    def __init__(self, config: DanaConfig):
        super().__init__(config)
        self.cls_conv1 = L.Conv2d(2 * config.feat_dim, 512, 3, bias=False)
        self.bn1 = L.BatchNorm2d(512)
        self.cls_conv2 = L.Conv2d(512, 128, 3, bias=False)
        self.bn2 = L.BatchNorm2d(128)
        # its 1152 inputs in (h, w, c) order: the JAX head's flatten of an
        # NHWC map (load_reference_state_dict permutes the reference's)
        self.RCNN_cls_score = L.Linear(128 * 3 * 3, 2)
        self.RCNN_bbox_pred = L.Linear(config.tail_dim, 4)


def init_fgn_params(config: DanaConfig, seed=0, backbone_params=None):
    def make(rng):
        return {
            'RCNN_rpn': rpn_lib.init_rpn_params(rng, config.feat_dim,
                                                config.num_anchors),
            'cls_conv1': _conv_w(rng, 3, 3, 2 * config.feat_dim, 512),
            'bn1': L.init_bn(512),
            'cls_conv2': _conv_w(rng, 3, 3, 512, 128),
            'bn2': L.init_bn(128),
            'RCNN_cls_score': L.init_linear_uniform(rng, 128 * 3 * 3, 2),
            'RCNN_bbox_pred': L.init_linear(rng, config.tail_dim, 4,
                                            std=0.001),
        }
    return _heads(config, seed, backbone_params, make)


def fgn_forward(model: FGN, config: DanaConfig, im_data, im_info,
                support_ims, training=False, gt_boxes=None, draws=None):
    """FGN: the positive shots' mean support vector (AvgPool 20) gates the
    base features before the RPN; the score head convolves the
    concatenated support and RoI features (conv, BN, ReLU twice, VALID)
    into a 1152-input linear.  With config.bn_train the head's BNs
    normalise with batch statistics in training and update their running
    statistics twice a step, on the positive call and then on the negative
    one; otherwise they use the stored statistics."""
    base_feat = dana.query_features(model, config, im_data)
    pos, neg = _shot_means(config, _support_maps(model, config, support_ims),
                           training)
    pos_rcnn = dana.pool14(pos)
    neg_rcnn = dana.pool14(neg) if training else None
    with record_function('dana.rpn_attention'):
        gated = base_feat * pos.mean(dim=(1, 2), keepdim=True)
    out = dana.trunk(model, config, base_feat, gated, im_info, training,
                     gt_boxes, draws)
    pooled = out['pooled']
    b, r = pooled.shape[:2]
    with record_function('dana.rcnn_head'):
        bbox_pred = model.RCNN_bbox_pred(dana.roi_tail(model, pooled))
    batch_stats = training and config.bn_train

    def score(sup):
        s = sup[:, None].expand(b, r, *sup.shape[1:])
        x = torch.cat([s, pooled], dim=-1).reshape(b * r, *pooled.shape[2:4],
                                                   -1)
        x = L.nhwc_to_nchw(x)
        x = F.relu(model.bn1(model.cls_conv1(x), batch_stats))
        x = F.relu(model.bn2(model.cls_conv2(x), batch_stats))
        return model.RCNN_cls_score(L.nchw_to_nhwc(x).reshape(b, r, -1))

    return _finish_episodic(out, config, bbox_pred, score, pos_rcnn,
                            neg_rcnn, training)


# --------------------------------------------------------- Faster R-CNN

class FasterRCNN(_Detector):
    """The plain detector: no supports, class-specific boxes."""

    def __init__(self, config: DanaConfig, num_classes=NUM_CLASSES):
        super().__init__(config)
        self.RCNN_cls_score = L.Linear(config.tail_dim, num_classes)
        self.RCNN_bbox_pred = L.Linear(config.tail_dim, 4 * num_classes)


def init_frcnn_params(config: DanaConfig, seed=0, backbone_params=None,
                      num_classes=NUM_CLASSES):
    def make(rng):
        return {
            'RCNN_rpn': rpn_lib.init_rpn_params(rng, config.feat_dim,
                                                config.num_anchors),
            'RCNN_cls_score': L.init_linear(rng, config.tail_dim,
                                            num_classes, std=0.01),
            'RCNN_bbox_pred': L.init_linear(rng, config.tail_dim,
                                            4 * num_classes, std=0.001),
        }
    return _heads(config, seed, backbone_params, make)


def frcnn_forward(model: FasterRCNN, config: DanaConfig, im_data, im_info,
                  training=False, gt_boxes=None, draws=None):
    """Faster R-CNN: the RPN on the base features, then class scores and
    class-specific deltas [B, R, 4 * classes] from the RoI tail.  In
    training the deltas of each roi's label are kept ([B, S, 4]) and the
    class loss is the mean negative log-likelihood over every sampled
    roi, in float32 (the box loss too, in `smooth_l1_loss`)."""
    base_feat = dana.query_features(model, config, im_data)
    out = dana.trunk(model, config, base_feat, base_feat, im_info, training,
                     gt_boxes, draws)
    with record_function('dana.rcnn_head'):
        tail = dana.roi_tail(model, out['pooled'])
        bbox_pred = model.RCNN_bbox_pred(tail)
        cls_score = model.RCNN_cls_score(tail)
    res = dict(rois=out['rois'], roi_mask=out['roi_mask'],
               cls_score=cls_score, cls_prob=torch.softmax(cls_score, -1))
    if not training:
        return dict(res, bbox_pred=bbox_pred)
    labels = out['rois_label'].long()
    b, r = labels.shape
    pick = labels[..., None, None].expand(b, r, 1, 4)
    bbox_pred = torch.gather(bbox_pred.reshape(b, r, -1, 4), 2, pick)[:, :, 0]
    with record_function('dana.losses'):
        nll = -torch.gather(torch.log_softmax(cls_score.float(), -1), -1,
                            labels[..., None])[..., 0]
        losses = dict(
            rcnn_loss_cls=nll.mean(),
            rcnn_loss_bbox=smooth_l1_loss(
                bbox_pred.reshape(-1, 4), out['rois_target'].reshape(-1, 4),
                out['rois_in_w'].reshape(-1, 4),
                out['rois_out_w'].reshape(-1, 4), sigma=1.0,
                reduce_dims=(1,)))
    return dict(res, **losses, bbox_pred=bbox_pred,
                rpn_loss_cls=out['rpn_loss_cls'],
                rpn_loss_box=out['rpn_loss_box'], rois_label=out['rois_label'])


# ------------------------------------------------------------- dispatch

_MODULES = {'DAnA': dana.DAnA, 'cisa': dana.DAnA, 'frcnn': FasterRCNN,
            'fsod': FSOD, 'meta': MetaRCNN, 'fgn': FGN}
_INITS = {'DAnA': dana.init_params, 'cisa': dana.init_params,
          'frcnn': init_frcnn_params, 'fsod': init_fsod_params,
          'meta': init_meta_params, 'fgn': init_fgn_params}


def build(config: DanaConfig) -> nn.Module:
    """The module of config.framework, with zero-filled weights."""
    return _MODULES[config.framework](config)


def init_params(config: DanaConfig, seed=0, backbone_params=None) -> dict:
    """Random-init numpy tree of config.framework in the JAX layout, drawn
    as the JAX package draws it."""
    return _INITS[config.framework](config, seed=seed,
                                    backbone_params=backbone_params)


def forward(model, config: DanaConfig, im_data, im_info, support_ims=None,
            support_feats=None, training=False, gt_boxes=None,
            all_gt_boxes=None, draws=None):
    """config.framework's forward (the JAX package's `loss_fn` dispatch).
    DAnA and cisa take support_ims or their cached support_feats; FSOD, Meta
    R-CNN and FGN take support_ims [B, n, H, W, 3]; Faster R-CNN none.
    `all_gt_boxes` is read by Meta R-CNN alone."""
    name = config.framework
    kw = dict(training=training, gt_boxes=gt_boxes, draws=draws)
    if name in dana.CACHED_SUPPORTS:
        return dana.forward(model, config, im_data, im_info, support_ims,
                            support_feats, **kw)
    if name == 'frcnn':
        return frcnn_forward(model, config, im_data, im_info, **kw)
    if name == 'meta':
        return meta_forward(model, config, im_data, im_info, support_ims,
                            all_gt_boxes=all_gt_boxes, **kw)
    fn = fsod_forward if name == 'fsod' else fgn_forward
    return fn(model, config, im_data, im_info, support_ims, **kw)
