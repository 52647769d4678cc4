"""Box math over arbitrary leading axes (port of dana_tpu/core/boxes.py).

Keeps the legacy Faster R-CNN +1 width/height convention and the
zero-area masking of the reference's bbox_overlaps_batch.
"""

from __future__ import annotations

import torch


def _wh_ctr(boxes):
    """width/height (+1 convention) and center of [..., 4] x1y1x2y2 boxes."""
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h
    return w, h, cx, cy


def encode_boxes(ex_rois, gt_rois):
    """Regression targets (dx, dy, dw, dh) from example rois to gt rois."""
    ew, eh, ecx, ecy = _wh_ctr(ex_rois)
    gw, gh, gcx, gcy = _wh_ctr(gt_rois)
    return torch.stack([(gcx - ecx) / ew, (gcy - ecy) / eh,
                        torch.log(gw / ew), torch.log(gh / eh)], dim=-1)


def decode_boxes(boxes, deltas):
    """Apply [..., 4k] deltas ((dx, dy, dw, dh) interleaved) to [..., 4]
    boxes -> [..., 4k] x1y1x2y2."""
    w, h, cx, cy = _wh_ctr(boxes)
    pcx = deltas[..., 0::4] * w[..., None] + cx[..., None]
    pcy = deltas[..., 1::4] * h[..., None] + cy[..., None]
    pw = torch.exp(deltas[..., 2::4]) * w[..., None]
    ph = torch.exp(deltas[..., 3::4]) * h[..., None]
    out = torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph,
                       pcx + 0.5 * pw, pcy + 0.5 * ph], dim=-1)
    return out.reshape(deltas.shape)


def clip_boxes(boxes, im_hw):
    """Clip [..., 4k] boxes to [0, W-1] x [0, H-1]; `im_hw` (..., 2) holds
    (height, width), broadcast against the boxes' leading axes."""
    h = im_hw[..., 0:1]
    w = im_hw[..., 1:2]
    zero = torch.zeros_like(w)
    x = boxes[..., 0::2].clamp(min=zero, max=w - 1)
    y = boxes[..., 1::2].clamp(min=zero, max=h - 1)
    return torch.stack([x, y], dim=-1).reshape(boxes.shape)


def iou_matrix(a, b):
    """Pairwise IoU of [..., N, 4] vs [..., K, 4] -> [..., N, K]."""
    area_a = (a[..., 2] - a[..., 0] + 1.0) * (a[..., 3] - a[..., 1] + 1.0)
    area_b = (b[..., 2] - b[..., 0] + 1.0) * (b[..., 3] - b[..., 1] + 1.0)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:4], b[..., None, :, 2:4])
    wh = (rb - lt + 1.0).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union


def iou_matrix_masked(anchors, gt_boxes):
    """IoU where zero-area gt boxes (padded slots) give 0 and zero-area
    anchors give -1, the anchor rule applied second."""
    gt = gt_boxes[..., :4]
    ov = iou_matrix(anchors, gt)
    gt_zero = ((gt[..., 2] - gt[..., 0] + 1.0) == 1.0) & \
              ((gt[..., 3] - gt[..., 1] + 1.0) == 1.0)
    an_zero = ((anchors[..., 2] - anchors[..., 0] + 1.0) == 1.0) & \
              ((anchors[..., 3] - anchors[..., 1] + 1.0) == 1.0)
    ov = torch.where(gt_zero[..., None, :], 0.0, ov)
    return torch.where(an_zero[..., :, None], -1.0, ov)
