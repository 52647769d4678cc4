"""The support database of the episodic loaders, ported from the JAX
package's `data/fs_loader.py` (`build_support_db`).  The training loader
and its batcher are not ported yet (ROADMAP Queue A 3)."""

from __future__ import annotations

import numpy as np


def build_support_db(roidb, num_classes, size_threshold=64):
    """class idx -> [{'roidb_idx', 'box'}]: the reference's filters
    (fs_loader.py:58-78): non-flipped entries, non-crowd boxes, both sides
    >= size_threshold px, aspect ratio <= 2."""
    db = [[] for _ in range(num_classes)]
    for roidb_idx, entry in enumerate(roidb):
        if entry.get('flipped'):
            continue
        overlaps = entry['gt_overlaps']
        overlaps = overlaps.toarray() if hasattr(overlaps, 'toarray') \
            else overlaps
        gt_inds = np.where((entry['gt_classes'] != 0)
                           & np.all(overlaps > -1.0, axis=1))[0]
        for i in gt_inds:
            box = entry['boxes'][i].astype(np.float32)
            cls = int(entry['gt_classes'][i])
            w, h = box[2] - box[0], box[3] - box[1]
            if w < size_threshold or h < size_threshold \
                    or w > 2 * h or h > 2 * w:
                continue
            db[cls].append({'roidb_idx': roidb_idx, 'box': box})
    return db
