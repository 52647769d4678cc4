"""Detection post-processing (port of dana_tpu/engine/postprocess.py):
denormalise the bbox deltas, decode, clip, rescale to raw-image
coordinates, score threshold, class-agnostic NMS, keep the top
`max_per_image` — batched over images, fixed-slot output."""

from __future__ import annotations

import torch

from dana_tpu_torch.core.boxes import clip_boxes, decode_boxes
from dana_tpu_torch.ops.nms import nms_fixed
from dana_tpu_torch.utils.device import host_table


def postprocess_batch(rois, cls_prob, bbox_pred, im_info,
                      bbox_stds=(0.1, 0.1, 0.2, 0.2),
                      bbox_means=(0.0, 0.0, 0.0, 0.0),
                      score_thresh: float = 0.05, nms_thresh: float = 0.3,
                      max_per_image: int = 100):
    """-> (dets [B, max_per_image, 5] (x1, y1, x2, y2, score) in raw-image
    coordinates, valid [B, max_per_image])."""
    dev = rois.device
    stds = host_table(bbox_stds, dev)
    means = host_table(bbox_means, dev)
    im_info = im_info.float()
    deltas = bbox_pred.float() * stds + means
    boxes = decode_boxes(rois[..., 1:5].float(), deltas)
    boxes = clip_boxes(boxes, im_info[:, None, :2])
    boxes = boxes / im_info[:, None, 2:3]
    scores = cls_prob[..., 1].float()

    idx, mask = nms_fixed(boxes, scores, nms_thresh, max_per_image,
                          scores > score_thresh)
    out = torch.cat([boxes.gather(1, idx[..., None].expand(-1, -1, 4)),
                     scores.gather(1, idx)[..., None]], dim=-1)
    return torch.where(mask[..., None], out, 0.0), mask
