"""Anchor generation (port of dana_tpu/core/anchors.py).

`generate_anchors` is numpy (the golden py-faster-rcnn table);
`shifted_anchors` lays it over the feature grid in (h, w, a) order.
"""

from __future__ import annotations

import numpy as np
import torch

from dana_tpu_torch.utils.device import device_table, host_table


def _wh_ctr(anchor):
    w = anchor[2] - anchor[0] + 1
    h = anchor[3] - anchor[1] + 1
    return w, h, anchor[0] + 0.5 * (w - 1), anchor[1] + 0.5 * (h - 1)


def _make(ws, hs, cx, cy):
    ws = ws[:, None]
    hs = hs[:, None]
    return np.hstack([cx - 0.5 * (ws - 1), cy - 0.5 * (hs - 1),
                      cx + 0.5 * (ws - 1), cy + 0.5 * (hs - 1)])


def generate_anchors(base_size=16, ratios=(0.5, 1, 2),
                     scales=2 ** np.arange(3, 6)):
    """Anchor windows by aspect-ratio x scale enumeration around a base
    (0, 0, base_size-1, base_size-1) window. Returns float64 [A, 4]."""
    ratios = np.asarray(ratios, dtype=np.float64)
    scales = np.asarray(scales, dtype=np.float64)
    base = np.array([1, 1, base_size, base_size], dtype=np.float64) - 1
    w, h, cx, cy = _wh_ctr(base)
    ws = np.round(np.sqrt(w * h / ratios))
    hs = np.round(ws * ratios)
    ratio_anchors = _make(ws, hs, cx, cy)
    out = []
    for i in range(ratio_anchors.shape[0]):
        w, h, cx, cy = _wh_ctr(ratio_anchors[i])
        out.append(_make(w * scales, h * scales, cx, cy))
    return np.vstack(out)


def shifted_anchors(feat_h: int, feat_w: int, stride: int,
                    base_anchors: np.ndarray, device='cpu') -> torch.Tensor:
    """Full anchor grid [feat_h*feat_w*A, 4] float32, shift-major and
    anchor-minor: the flattened order is (h, w, a).  Built on `device`
    (the base table through `host_table`, the shifts from `arange`), in
    float64 as the numpy grid was, and kept per device
    (`device_table`)."""
    base_anchors = np.asarray(base_anchors, np.float64)

    def build():
        base = host_table(base_anchors, device, torch.float64)
        sx = torch.arange(feat_w, dtype=torch.float64, device=device)
        sy = torch.arange(feat_h, dtype=torch.float64, device=device)
        sy, sx = torch.meshgrid(sy * stride, sx * stride, indexing='ij')
        shifts = torch.stack([sx, sy, sx, sy], dim=-1).reshape(-1, 4)
        return (base[None, :, :] + shifts[:, None, :]).reshape(-1, 4).float()
    return device_table(('anchors', feat_h, feat_w, stride,
                         base_anchors.shape, base_anchors.tobytes()),
                        device, build)
