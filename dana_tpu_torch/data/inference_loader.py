"""The evaluation-time episodic loader, ported from the JAX package's
`data/inference_loader.py` (`SupportPool`, `InferenceLoader`).

Each query image is evaluated against its single annotated target class
(its first gt box's class, reference inference.py:131-139), with a fixed,
seeded support set per class: from the directory pool
`<DATA_DIR>/supports/<class>/` when it exists (the reference's
`random.seed(seed); random.sample` per class), else crops from a support
roidb (`np.random.default_rng(seed)`), so that both packages pick the same
supports.  Queries pad onto static bucket canvases.  The other loaders
(multi-way, all-class, oracle, general) are not ported yet.
"""

from __future__ import annotations

import glob
import os.path as osp
import random
from pathlib import Path

import numpy as np

from dana_tpu_torch.data import blob
from dana_tpu_torch.data.fs_loader import build_support_db
from dana_tpu_torch.utils.config import PIXEL_MEANS


def _crop_support(im, box, pixel_means, support_size, exact=True,
                  target_size=600):
    """A roidb box as a support: the reference's training crop
    (`support_blob_exact`, TPU.EXACT_SUPPORT_SCALE; the source scaled
    without a long-side cap, whatever the query scaling) or the
    one-resampling approximation."""
    if exact:
        return blob.support_blob_exact(im, box, pixel_means, support_size,
                                       target_size=target_size, max_size=None)
    return blob.support_blob(im, box, pixel_means, support_size)


def _list_support_files(support_dir, name):
    """The directory pool of one class: the reference's Path.glob('*.jpg')
    listing, else every file, sorted; [] when there is none."""
    files = [str(p) for p in Path(osp.join(support_dir, name)).glob('*.jpg')]
    if not files:
        files = sorted(glob.glob(osp.join(support_dir, name, '*')))
    return files


class SupportPool:
    """Fixed per-class support images, seeded like the reference
    (inference_loader.py:61-71)."""

    def __init__(self, classes, num_shot, support_dir=None,
                 support_roidb=None, seed=0, pixel_means=PIXEL_MEANS,
                 support_size=320, exact_support_scale=True,
                 target_size=600, image_cache=None):
        self.num_shot = num_shot
        self.support_size = support_size
        self.pixel_means = pixel_means
        self._images = {}          # class index -> [support blobs]
        rng = np.random.default_rng(seed)
        if support_dir and osp.isdir(support_dir):
            for cls_ind, name in enumerate(classes):
                if name == '__background__':
                    continue
                files = _list_support_files(support_dir, name)
                if not files:
                    continue
                if len(files) >= num_shot:
                    # random.seed(seed) reapplied per class, then sample
                    picks = random.Random(seed).sample(files, k=num_shot)
                else:
                    # the reference would raise: draw with replacement
                    pick = rng.choice(len(files), num_shot, replace=True)
                    picks = [files[int(i)] for i in pick]
                self._images[cls_ind] = [
                    blob.support_blob_whole(
                        blob.imread_bgr(p, image_cache), pixel_means,
                        support_size) for p in picks]
        elif support_roidb is not None:
            db = build_support_db(support_roidb, len(classes))
            for cls_ind in range(1, len(classes)):
                pool = db[cls_ind]
                if not pool:
                    continue
                pick = rng.choice(len(pool), num_shot,
                                  replace=len(pool) < num_shot)
                self._images[cls_ind] = [
                    _crop_support(
                        blob.imread_bgr(
                            support_roidb[pool[int(i)]['roidb_idx']]['image'],
                            image_cache),
                        pool[int(i)]['box'], pixel_means, support_size,
                        exact_support_scale, target_size)
                    for i in pick]
        else:
            raise ValueError('need support_dir or support_roidb')

    def classes_available(self):
        return sorted(self._images)

    def get(self, cls_ind):
        return np.stack(self._images[cls_ind])   # [shot, S, S, 3]


class InferenceLoader:
    """One episode per query image against its fixed target class.

    `max_size` None scales by the shortest side alone, as the reference
    does (TPU.EXACT_QUERY_SCALE); `ship_uint8` emits raw uint8 canvases for
    device-side mean subtraction (TPU.SHIP_UINT8).  Items carry no support
    stack (the JAX loader's `support_ims`): the predictor encodes each
    class's supports once, from `pool.get(target_cls)`."""

    def __init__(self, roidb, pool: SupportPool, pixel_means=PIXEL_MEANS,
                 max_num_box=20, buckets=blob.DEFAULT_BUCKETS, scale=600,
                 max_size=None, ship_uint8=False):
        self.roidb = roidb
        self.pool = pool
        self.pixel_means = pixel_means
        self.max_num_box = max_num_box
        self.buckets = [tuple(b) for b in buckets]
        self.scale = scale
        self.max_size = max_size
        self.ship_uint8 = ship_uint8

    def _query_blob(self, im):
        if self.ship_uint8:
            return blob.query_blob_u8(im, self.scale, self.max_size,
                                      buckets=self.buckets,
                                      pixel_means=self.pixel_means)
        return blob.query_blob(im, self.pixel_means, self.scale,
                               self.max_size, buckets=self.buckets)

    def __len__(self):
        return len(self.roidb)

    def bucket_of(self, index):
        e = self.roidb[index]
        h, w = e['height'], e['width']
        s = blob.query_scale(h, w, self.scale, self.max_size)
        return blob.pick_bucket(round(h * s), round(w * s), self.buckets)

    def target_class(self, index):
        return int(self.roidb[index]['gt_classes'][0])

    def __getitem__(self, index):
        entry = self.roidb[index]
        im = blob.imread_bgr(entry['image'])
        im_data, im_info = self._query_blob(im)
        cls = self.target_class(index)
        gt = np.zeros((self.max_num_box, 5), np.float32)
        n = min(len(entry['boxes']), self.max_num_box)
        gt[:n, :4] = entry['boxes'][:n] * im_info[2]
        gt[:n, 4] = entry['gt_classes'][:n]
        return {
            'im_data': im_data, 'im_info': im_info, 'gt_boxes': gt,
            'num_boxes': np.int32(n),
            'target_cls': np.int32(cls), 'index': np.int32(index),
        }
