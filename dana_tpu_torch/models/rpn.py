"""Region Proposal Network heads and proposal layer (port of
dana_tpu/models/rpn.py, eval path).

The cls head's 2A channels are bg [0:A] and fg [A:2A], the order of the
reference's [B, 2A, H, W] tensor; flattened anchors run in (h, w, a)
order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dana_tpu_torch.core.boxes import clip_boxes, decode_boxes
from dana_tpu_torch.models import layers as L
from dana_tpu_torch.ops.nms import nms_fixed_tiled


class RPN(nn.Module):
    """RPN_Conv 3x3 -> 512, then 1x1 cls (2A) and bbox (4A) heads."""

    def __init__(self, din: int, num_anchors: int):
        super().__init__()
        self.num_anchors = num_anchors
        self.RPN_Conv = nn.Conv2d(din, 512, 3, 1, 1)
        self.RPN_cls_score = nn.Conv2d(512, 2 * num_anchors, 1)
        self.RPN_bbox_pred = nn.Conv2d(512, 4 * num_anchors, 1)


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
