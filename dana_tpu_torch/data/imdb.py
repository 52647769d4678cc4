"""Dataset (imdb) base class and roidb preparation, ported from the JAX
package's `data/imdb.py` (reference imdb.py and roidb.py semantics: gt
proposals only, flipped-image doubling, the empty-image filter and the
aspect-ratio ranking).
"""

from __future__ import annotations

import numpy as np


class imdb:
    def __init__(self, name, classes=None):
        self._name = name
        self._classes = classes or []
        self._image_index = []
        self._roidb = None

    name = property(lambda self: self._name)
    classes = property(lambda self: self._classes)
    num_classes = property(lambda self: len(self._classes))
    image_index = property(lambda self: self._image_index)
    num_images = property(lambda self: len(self._image_index))

    @property
    def roidb(self):
        if self._roidb is None:
            self._roidb = self.gt_roidb()
        return self._roidb

    def gt_roidb(self):
        raise NotImplementedError

    def image_path_at(self, i):
        raise NotImplementedError

    def image_id_at(self, i):
        return i

    def evaluate_detections(self, all_boxes, output_dir=None):
        raise NotImplementedError

    def append_flipped_images(self):
        """Double the roidb with horizontally flipped entries
        (imdb.py:115-135): boxes mirrored with the +1 pixel convention."""
        num = self.num_images
        for i in range(num):
            entry = self.roidb[i]
            boxes = entry['boxes'].copy()
            width = entry['width']
            oldx1 = boxes[:, 0].copy()
            oldx2 = boxes[:, 2].copy()
            boxes[:, 0] = width - oldx2 - 1
            boxes[:, 2] = width - oldx1 - 1
            assert (boxes[:, 2] >= boxes[:, 0]).all()
            flipped = dict(entry, boxes=boxes, flipped=True)
            self.roidb.append(flipped)
        self._image_index = self._image_index * 2


def prepare_roidb(ds: imdb):
    """Attach per-entry metadata (roidb.py:13-46): image path, width,
    height, max_classes/max_overlaps from gt_overlaps."""
    roidb = ds.roidb
    for i, entry in enumerate(roidb):
        entry.setdefault('img_id', ds.image_id_at(i % ds.num_images))
        entry.setdefault('image', ds.image_path_at(i % ds.num_images))
        overlaps = entry['gt_overlaps']
        entry['max_overlaps'] = overlaps.max(axis=1) if overlaps.size else \
            np.zeros((0,), np.float32)
        entry['max_classes'] = overlaps.argmax(axis=1) if overlaps.size else \
            np.zeros((0,), np.int64)


def filter_roidb(roidb):
    """Drop entries with NO boxes at all (roidb.py:83-87: the filter is
    `len(boxes) == 0` — an image whose only boxes are crowd regions
    (overlap -1) is KEPT; the episodic loaders' valid_indices() decide
    whether it can actually seed an episode)."""
    return [e for e in roidb if len(e['boxes'])]


def rank_roidb_ratio(roidb):
    """Aspect ratio (w/h) clamped to [0.5, 2] with need_crop flags,
    sorted ascending (roidb.py:49-77)."""
    ratio_large, ratio_small = 2.0, 0.5
    ratios = []
    for entry in roidb:
        ratio = entry['width'] / float(entry['height'])
        if ratio > ratio_large:
            entry['need_crop'] = 1
            ratio = ratio_large
        elif ratio < ratio_small:
            entry['need_crop'] = 1
            ratio = ratio_small
        else:
            entry['need_crop'] = 0
        ratios.append(ratio)
    ratios = np.array(ratios)
    index = np.argsort(ratios)
    return ratios[index], index


def combined_roidb(imdb_name, training=True, use_flipped=True,
                   data_dir='data'):
    """Build the (imdb, roidb, ratio_list, ratio_index) tuple
    (roidb.py:92-137); `data_dir` is the config's DATA_DIR."""
    from dana_tpu_torch.data.factory import get_imdb
    ds = get_imdb(imdb_name, data_dir)
    if training and use_flipped:
        ds.append_flipped_images()
    prepare_roidb(ds)
    roidb = ds.roidb
    if training:
        roidb = filter_roidb(roidb)
    ratio_list, ratio_index = rank_roidb_ratio(roidb)
    return ds, roidb, ratio_list, ratio_index
