"""Box validation and conversion helpers for the datasets, ported from the
JAX package's `data/ds_utils.py` (reference ds_utils.py:13-49)."""

from __future__ import annotations

import numpy as np


def unique_boxes(boxes, scale=1.0):
    """Sorted indices of the first of each distinct box (hashed after
    rounding boxes * scale)."""
    v = np.array([1, 1e3, 1e6, 1e9])
    hashes = np.round(boxes * scale).dot(v)
    _, index = np.unique(hashes, return_index=True)
    return np.sort(index)


def xywh_to_xyxy(boxes):
    """(x, y, w, h) -> (x1, y1, x2, y2), the +1 pixel convention."""
    return np.hstack((boxes[:, 0:2], boxes[:, 0:2] + boxes[:, 2:4] - 1))


def xyxy_to_xywh(boxes):
    return np.hstack((boxes[:, 0:2], boxes[:, 2:4] - boxes[:, 0:2] + 1))


def validate_boxes(boxes, width=0, height=0):
    """Assert that every box lies ordered inside a width x height image."""
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    assert (x1 >= 0).all()
    assert (y1 >= 0).all()
    assert (x2 >= x1).all()
    assert (y2 >= y1).all()
    assert (x2 < width).all()
    assert (y2 < height).all()


def filter_small_boxes(boxes, min_size):
    """Indices of the boxes with w >= min_size and h > min_size (the
    reference's asymmetric comparison)."""
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    return np.where((w >= min_size) & (h > min_size))[0]
