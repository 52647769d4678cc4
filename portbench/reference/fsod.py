"""The plain reference of FSOD (Fan et al., CVPR 2020, arXiv:1908.01998) on
the ResNet-50 C4 trunk, as the program's models/frameworks.py defines it:
the attention RPN (each query's map correlated channel by channel with
the 7x7 kernel of its supports' mean map, VALID, so the RPN grid is 6
cells smaller each way and its anchors start at the grid's origin), the
shared proposals, RoIAlign and layer4 box branch, and the three relation
heads (global, local correlation, patch) summed and divided by 10.

`serve` returns the record of every stage; with `follow` the stages after
the proposals pool that record's rois (see reference/dana.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import detector as D
from portbench.reference.dana import box_branch, supports

C = 1024


def spec(cfg):
    """[(name, shape, mean, std)] of the detector's weights, scaled so that
    the correlation's RPN scores and the relation scores stay off
    saturation on the random trunk's maps."""
    m = cfg['model']
    a = len(m['anchor_scales']) * len(m['anchor_ratios'])
    return (D.resnet50_spec() + D.rpn_spec(C, a, gain=0.005)
            + D.linear_spec('global_fc_1', C, 2 * C)
            + D.linear_spec('global_fc_2', C, C)
            + D.linear_spec('global_cls_score', 2, C, gain=4.0)
            + D.conv_spec('corr_conv', C, C, 1, bias=False)
            + D.linear_spec('corr_cls_score', 2, C, gain=0.02)
            + D.conv_spec('patch_conv_1', C // 4, 2 * C, 1, gain=1.4,
                          bias=False)
            + D.conv_spec('patch_conv_2', C // 4, C // 4, 3, gain=1.4,
                          bias=False)
            + D.conv_spec('patch_conv_3', C, C // 4, 1, gain=1.4, bias=False)
            + D.linear_spec('patch_cls_score', 2, C, gain=4.0)
            + D.linear_spec('RCNN_bbox_pred', 4, 2 * C, gain=0.1))


def correlation(feat, kernels):
    """feat [B, C, h, w], kernels [B, C, 7, 7] -> [B, C, h-6, w-6]: each
    image's channels convolved with its own kernels (one grouped conv)."""
    b, c, h, w = feat.shape
    kh, kw = kernels.shape[2:]
    y = F.conv2d(feat.reshape(1, b * c, h, w),
                 kernels.reshape(b * c, 1, kh, kw), groups=b * c)
    return y.reshape(b, c, h - kh + 1, w - kw + 1)


def relation_scores(w, pooled, sup):
    """pooled [B, R, C, P, P], the shot-mean kernel sup [B, C, P, P] ->
    cls_score [B, R, 2]."""
    b, r, c, p, _ = pooled.shape
    flat = pooled.reshape(b * r, c, p, p)
    roi_corr = D.conv(flat, w, 'corr_conv').reshape(b, r, c, p, p)
    cat = torch.cat([pooled, sup[:, None].expand(b, r, c, p, p)], dim=2)
    g = F.relu(D.linear(cat.mean(dim=(3, 4)), w, 'global_fc_1'))
    g = D.linear(F.relu(D.linear(g, w, 'global_fc_2')), w, 'global_cls_score')
    corr_vec = torch.einsum('brchw,bchw->brc', roi_corr,
                            D.conv(sup, w, 'corr_conv'))
    loc = D.linear(corr_vec, w, 'corr_cls_score')
    x = cat.reshape(b * r, 2 * c, p, p)
    x = F.avg_pool2d(F.relu(D.conv(x, w, 'patch_conv_1')), 3, 1)
    x = F.relu(D.conv(x, w, 'patch_conv_2'))
    x = F.avg_pool2d(F.relu(D.conv(x, w, 'patch_conv_3')), 3, 1)
    patch = D.linear(x.reshape(b, r, c), w, 'patch_cls_score')
    return (g + loc + patch) / 10.0


def serve(w, cfg, im, im_info, support_ims, follow=None, keep_rois=16):
    """One request: uint8 queries [B, H, W, 3], im_info [B, 3], each
    query's supports [B, S, H, W, 3] (mean-subtracted) -> the record of
    every stage (`support`: the shot-mean kernels NHWC [B, 7, 7, C];
    `attn`: the correlation map NHWC)."""
    m = cfg['model']
    a = len(m['anchor_scales']) * len(m['anchor_ratios'])
    feat = D.resnet_base(D.query_images(im, m['pixel_means']), w)
    sup_f, _ = supports(w, support_ims[:, :m['n_shot']])
    kern = D.avg_pool14(sup_f.mean(dim=1))
    corr = correlation(feat, kern)
    _, probs, deltas = D.rpn(corr, w, a)
    grid = D.anchors(corr.shape[2], corr.shape[3], m['anchor_scales'],
                     m['anchor_ratios'], feat.device)
    rois, mask = D.proposals(probs, deltas, grid, im_info, m['test_pre_nms'],
                             m['test_post_nms'], m['rpn_nms_thresh'])
    own_rois, own_mask = rois, mask
    if follow is not None:
        rois, mask = follow['rois'], follow['mask']
    pooled = D.roi_align(feat, rois, m['pooling_size'])
    bbox_pred = box_branch(w, pooled)
    cls_prob = torch.softmax(relation_scores(w, pooled, kern), dim=-1)
    post = cfg['postprocess']
    dets, valid = D.postprocess(rois, cls_prob, bbox_pred, im_info,
                                stds=m['bbox_normalize_stds'],
                                score_thresh=post['score_thresh'],
                                nms_thresh=post['nms_thresh'],
                                max_per_image=post['max_per_image'])
    return dict(
        feat=feat.permute(0, 2, 3, 1), support=kern.permute(0, 2, 3, 1),
        attn=corr.permute(0, 2, 3, 1), probs=probs, deltas=deltas, rois=rois,
        mask=mask, own_rois=own_rois, own_mask=own_mask,
        pooled=pooled[:, :keep_rois].permute(0, 1, 3, 4, 2),
        cls_prob=cls_prob, bbox_pred=bbox_pred, dets=dets, valid=valid)
