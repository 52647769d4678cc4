"""Region Proposal Network heads, proposal layer and training target
layers (port of dana_tpu/models/rpn.py).

The cls head's 2A channels are bg [0:A] and fg [A:2A], the order of the
reference's [B, 2A, H, W] tensor; flattened anchors run in (h, w, a)
order.

The target layers sample without host loops: a uniform draw per
candidate, ranked among the candidates of its kind, picks them.  They
take their uniform draws as tensors, in the shapes and order in which
the JAX package draws them (`uniform_draws`), so a test can hand both
packages the same numbers: torch cannot replay the JAX generator.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dana_tpu_torch.core.boxes import (clip_boxes, decode_boxes,
                                       encode_boxes, iou_matrix_masked)
from dana_tpu_torch.models import layers as L
from dana_tpu_torch.ops.nms import nms_fixed_tiled

# the uniform draws of one training step, in the JAX package's order:
# anchor_target's fg and bg ranks [B,N], then proposal_target's fg rank
# [B,T] and its with-replacement fg and bg picks [B,S]
DRAW_KEYS = ('anchor_fg', 'anchor_bg', 'roi_fg_rank', 'roi_fg', 'roi_bg')


class RPN(nn.Module):
    """RPN_Conv 3x3 -> 512, then 1x1 cls (2A) and bbox (4A) heads."""

    def __init__(self, din: int, num_anchors: int):
        super().__init__()
        self.num_anchors = num_anchors
        self.RPN_Conv = L.Conv2d(din, 512, 3, 1, 1)
        self.RPN_cls_score = L.Conv2d(512, 2 * num_anchors, 1)
        self.RPN_bbox_pred = L.Conv2d(512, 4 * num_anchors, 1)


def init_rpn_params(rng: np.random.Generator, din: int, num_anchors: int):
    """numpy tree in the JAX layout, drawn as the JAX package draws it."""
    return {
        'RPN_Conv': L.init_conv(rng, 3, 3, din, 512, bias=True, std=0.01),
        'RPN_cls_score': L.init_conv(rng, 1, 1, 512, num_anchors * 2,
                                     bias=True, std=0.01),
        'RPN_bbox_pred': L.init_conv(rng, 1, 1, 512, num_anchors * 4,
                                     bias=True, std=0.01),
    }


def rpn_forward(base_feat, rpn: RPN):
    """base_feat [B,H,W,din] -> (cls logits [B,N,2], fg probs [B,N],
    deltas [B,N,4]), N = H*W*A in (h, w, a) order."""
    b, h, w, _ = base_feat.shape
    a = rpn.num_anchors
    x = F.relu(rpn.RPN_Conv(L.nhwc_to_nchw(base_feat)))
    raw = rpn.RPN_cls_score(x).permute(0, 2, 3, 1)             # [B,H,W,2A]
    logits = torch.stack([raw[..., :a], raw[..., a:]], dim=-1)
    logits = logits.reshape(b, h * w * a, 2)
    probs_fg = torch.softmax(logits, dim=-1)[..., 1]
    deltas = rpn.RPN_bbox_pred(x).permute(0, 2, 3, 1).reshape(b, h * w * a, 4)
    return logits, probs_fg, deltas


def proposal_layer(probs_fg, deltas, anchors, im_info, *, pre_nms_top_n,
                   post_nms_top_n, nms_thresh, nms_cap=6000):
    """Decode + clip + top-k + NMS -> (rois [B, post, 5] with the batch
    index in column 0 and zero padding, scores [B, post], mask [B, post]).

    The top-k is a stable descending sort, so equal scores keep the lower
    anchor index first, as the JAX top_k does."""
    b, n = probs_fg.shape
    k = min(pre_nms_top_n, nms_cap, n)
    proposals = decode_boxes(anchors[None], deltas)
    proposals = clip_boxes(proposals, im_info[:, None, :2])

    top_scores, order = torch.sort(probs_fg, dim=1, descending=True,
                                   stable=True)
    top_scores, order = top_scores[:, :k], order[:, :k]
    boxes = proposals.gather(1, order[..., None].expand(-1, -1, 4))
    idx, mask = nms_fixed_tiled(boxes, top_scores, nms_thresh,
                                post_nms_top_n)
    kept = boxes.gather(1, idx[..., None].expand(-1, -1, 4))
    kept = torch.where(mask[..., None], kept, 0.0)
    scores = torch.where(mask, top_scores.gather(1, idx), 0.0)
    batch_col = torch.arange(b, device=kept.device, dtype=kept.dtype)
    batch_col = batch_col[:, None, None].expand(b, kept.shape[1], 1)
    return torch.cat([batch_col, kept], dim=-1), scores, mask


def uniform_draws(gen: torch.Generator, b: int, n: int, t: int, s: int):
    """The uniform [0, 1) draws of one training step from `gen`, on its
    device: anchors N per image, proposal-target candidates T (proposals
    plus gt slots) and S sampled rois per image."""
    shapes = {'anchor_fg': (b, n), 'anchor_bg': (b, n),
              'roi_fg_rank': (b, t), 'roi_fg': (b, s), 'roi_bg': (b, s)}
    return {k: torch.rand(shapes[k], generator=gen, device=gen.device)
            for k in DRAW_KEYS}


def _random_rank(u, mask):
    """Rank of each True element of `mask` among the True elements, in the
    order of its draw `u`; False elements rank after every True one.  rank
    < limit picks `limit` elements uniformly without replacement.  Both
    sorts are stable: the False entries tie at inf."""
    r = torch.where(mask, u, torch.inf)
    order = torch.argsort(r, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True)


def _take(x, idx):
    """x [B,T,...] at idx [B,S] along axis 1 -> [B,S,...]."""
    idx = idx.reshape(*idx.shape, *([1] * (x.dim() - 2)))
    return x.gather(1, idx.expand(*idx.shape[:2], *x.shape[2:]))


def anchor_target(anchors, gt_boxes, im_info, u_fg, u_bg, *, batch_rois=256,
                  fg_fraction=0.5, pos_overlap=0.7, neg_overlap=0.3):
    """RPN training targets.

    anchors [N,4], gt_boxes [B,G,5] (zero rows pad), im_info [B,3],
    u_fg / u_bg [B,N] uniform draws.  Anchors that leave the image keep
    label -1; at most fg_fraction * batch_rois fg anchors are kept and bg
    anchors fill the batch, each drawn uniformly without replacement.
    -> labels [B,N] int64 in {-1,0,1}, bbox_targets [B,N,4], inside_w
    [B,N], outside_w [B,N] (1 / the image's labelled count)."""
    inside = ((anchors[:, 0] >= 0) & (anchors[:, 1] >= 0)
              & (anchors[:, 2] < im_info[:, None, 1])
              & (anchors[:, 3] < im_info[:, None, 0]))          # [B,N]

    ov = iou_matrix_masked(anchors[None], gt_boxes)            # [B,N,G]
    ov = torch.where(inside[..., None], ov, -1.0)
    max_ov = ov.max(dim=2).values
    argmax_ov = ov.argmax(dim=2)
    gt_max = ov.max(dim=1).values                              # [B,G]
    gt_max = torch.where(gt_max == 0.0, 1e-5, gt_max)
    is_best = (ov == gt_max[:, None, :]).any(dim=2)            # best per gt

    labels = torch.full_like(max_ov, -1, dtype=torch.long)
    labels = torch.where(max_ov < neg_overlap, 0, labels)
    labels = torch.where(is_best, 1, labels)
    labels = torch.where(max_ov >= pos_overlap, 1, labels)
    labels = torch.where(inside, labels, -1)

    fg = labels == 1
    fg_keep = _random_rank(u_fg, fg) < int(fg_fraction * batch_rois)
    labels = torch.where(fg & ~fg_keep, -1, labels)
    num_bg = batch_rois - (labels == 1).sum(dim=1, keepdim=True)
    bg = labels == 0
    bg_keep = _random_rank(u_bg, bg) < num_bg
    labels = torch.where(bg & ~bg_keep, -1, labels)

    assigned_gt = _take(gt_boxes[..., :4], argmax_ov)
    targets = encode_boxes(anchors[None].expand_as(assigned_gt), assigned_gt)
    targets = torch.where(inside[..., None], targets, 0.0)

    inside_w = (labels == 1).to(targets.dtype)
    num_examples = (labels >= 0).sum(dim=1, keepdim=True)
    outside_w = torch.where(labels >= 0,
                            1.0 / num_examples.clamp(min=1).to(targets.dtype),
                            0.0)
    return labels, targets, inside_w, outside_w


def iou_anchor_target(anchors, gt_boxes, im_info, u_fg, u_bg, **kw):
    """`anchor_target`'s four outputs and each anchor's best IoU with a gt
    box [B,N], over all anchors, with no inside-image filter (reference
    iou_anchor_target_layer.py:193-196; no framework calls it, in the
    reference or the JAX package)."""
    out = anchor_target(anchors, gt_boxes, im_info, u_fg, u_bg, **kw)
    ov = iou_matrix_masked(anchors[None], gt_boxes)
    return (*out, ov.max(dim=2).values)


def proposal_target(rois, gt_boxes, u_fg_rank, u_fg, u_bg, *,
                    rois_per_image=128, fg_fraction=0.25, fg_thresh=0.5,
                    bg_thresh_hi=0.5, bg_thresh_lo=0.1,
                    bbox_normalize_means=(0., 0., 0., 0.),
                    bbox_normalize_stds=(0.1, 0.1, 0.2, 0.2)):
    """Sample S = rois_per_image rois per image, at most a fg_fraction of
    them fg, with their regression targets.

    rois [B,R,5] proposals, gt_boxes [B,G,5]; the gt boxes join the
    candidates (T = R + G).  u_fg_rank [B,T], u_fg / u_bg [B,S] uniform
    draws.  With both fg and bg candidates, fg are drawn without
    replacement and bg with replacement (floor(u * n_bg)); with only one
    kind, that kind fills every slot with replacement; fg slots come
    first.  An image with neither gets all-zero rois and weights.
    -> rois [B,S,5], labels [B,S] int64, bbox_targets, inside_w,
    outside_w [B,S,4]."""
    b = rois.shape[0]
    s = rois_per_image
    fg_per_image = int(round(fg_fraction * rois_per_image)) or 1
    gt_as_rois = torch.cat([gt_boxes.new_zeros(*gt_boxes.shape[:2], 1),
                            gt_boxes[..., :4]], dim=-1)
    all_rois = torch.cat([rois, gt_as_rois], dim=1)            # [B,T,5]
    t = all_rois.shape[1]

    ov = iou_matrix_masked(all_rois[..., 1:5], gt_boxes)       # [B,T,G]
    max_ov = ov.max(dim=2).values
    gt_assignment = ov.argmax(dim=2)
    labels_all = gt_boxes[..., 4].gather(1, gt_assignment)

    fg_mask = max_ov >= fg_thresh
    bg_mask = (max_ov < bg_thresh_hi) & (max_ov >= bg_thresh_lo)
    n_fg = fg_mask.sum(dim=1)                                   # [B]
    n_bg = bg_mask.sum(dim=1)

    fg_rank = _random_rank(u_fg_rank, fg_mask)
    fg_order = torch.argsort(torch.where(fg_mask, fg_rank, t), dim=1,
                             stable=True)
    # candidate indices of each kind first, in index order
    bg_positions = torch.argsort((~bg_mask).long(), dim=1, stable=True)
    fg_positions = torch.argsort((~fg_mask).long(), dim=1, stable=True)

    both = (n_fg > 0) & (n_bg > 0)
    only_fg = (n_fg > 0) & (n_bg == 0)
    valid_img = n_fg + n_bg > 0

    zero = torch.zeros_like(n_fg)
    fg_count = torch.where(both, n_fg.clamp(max=fg_per_image),
                           torch.where(only_fg, s, zero))       # [B]
    slot = torch.arange(s, device=rois.device)
    is_fg_slot = slot[None, :] < fg_count[:, None]              # [B,S]

    # (u * n) truncates to an index in [0, n), as astype(int32) does
    fg_wr = fg_positions.gather(1, (u_fg * n_fg[:, None]).long())
    fg_sel = torch.where(both[:, None], fg_order[:, :s], fg_wr)
    bg_slot = (slot[None, :] - fg_count[:, None]) % s
    u_bg_s = u_bg.gather(1, bg_slot)
    bg_sel = bg_positions.gather(
        1, (u_bg_s * n_bg.clamp(min=1)[:, None]).long())
    sel = torch.where(is_fg_slot, fg_sel, bg_sel)              # [B,S]

    out_rois = _take(all_rois, sel)
    batch_col = torch.arange(b, device=rois.device, dtype=rois.dtype)
    out_rois = torch.cat([batch_col[:, None, None].expand(b, s, 1),
                          out_rois[..., 1:]], dim=-1)
    labels = labels_all.gather(1, sel)
    labels = torch.where(is_fg_slot, labels, 0.0).long()
    labels = torch.where(valid_img[:, None], labels, 0)

    gt_sel = _take(gt_boxes[..., :4], gt_assignment.gather(1, sel))
    targets = encode_boxes(out_rois[..., 1:5], gt_sel)
    means = targets.new_tensor(bbox_normalize_means)
    stds = targets.new_tensor(bbox_normalize_stds)
    targets = (targets - means) / stds

    pos = ((labels > 0) & valid_img[:, None])[..., None]
    targets = torch.where(pos, targets, 0.0)
    inside_w = pos.to(targets.dtype).expand(-1, -1, 4)
    outside_w = inside_w.clone()
    out_rois = torch.where(valid_img[:, None, None], out_rois, 0.0)
    return out_rois, labels, targets, inside_w, outside_w
