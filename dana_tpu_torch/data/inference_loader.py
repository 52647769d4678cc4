"""The evaluation-time loaders, ported from the JAX package's
`data/inference_loader.py`.

`InferenceLoader` evaluates each query image against its single annotated
target class (its first gt box's class, reference inference.py:131-139),
with a fixed, seeded support set per class (`SupportPool`): from the
directory pool `<DATA_DIR>/supports/<class>/` when it exists (the
reference's `random.seed(seed); random.sample` per class), else crops from
a support roidb (`np.random.default_rng(seed)`), so that both packages
pick the same supports.  Queries pad onto static bucket canvases.

The other protocols: `GeneralTestLoader` (queries only), `OracleLoader`
(queries and every class's gt, no supports), `MultiwayLoader` (the N-way
episode: the supports of N classes per query) and `ALLCLSFSLoader`
(supports drawn anew for each item, from a directory pool or through
`ResamplingSupportPool`).  Every draw of an item depends on its index
alone, so items may be assembled in any order and on any thread.
"""

from __future__ import annotations

import glob
import os.path as osp
import random
import warnings
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
    device-side mean subtraction (TPU.SHIP_UINT8).  Items carry their
    class's support stack `support_ims` = `pool.get(target_cls)` [shot, S,
    S, 3] only with `with_supports`, for the detectors that encode each
    request's supports (the JAX loader's `skip_supports` False); DAnA and
    cisa encode each class's supports once, from the pool."""

    def __init__(self, roidb, pool: SupportPool, pixel_means=PIXEL_MEANS,
                 max_num_box=20, buckets=blob.DEFAULT_BUCKETS, scale=600,
                 max_size=None, ship_uint8=False, with_supports=False):
        self.roidb = roidb
        self.pool = pool
        self.pixel_means = pixel_means
        self.max_num_box = max_num_box
        self.buckets = [tuple(b) for b in buckets]
        self.scale = scale
        self.max_size = max_size
        self.ship_uint8 = ship_uint8
        self.with_supports = with_supports

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

    def supports(self, cls, index):
        """Item `index`'s support stack of class `cls`."""
        return self.pool.get(cls)

    def __getitem__(self, index):
        entry = self.roidb[index]
        im = blob.imread_bgr(entry['image'])
        im_data, im_info = self._query_blob(im)
        cls = self.target_class(index)
        gt = np.zeros((self.max_num_box, 5), np.float32)
        n = min(len(entry['boxes']), self.max_num_box)
        gt[:n, :4] = entry['boxes'][:n] * im_info[2]
        gt[:n, 4] = entry['gt_classes'][:n]
        item = {
            'im_data': im_data, 'im_info': im_info, 'gt_boxes': gt,
            'num_boxes': np.int32(n),
            'target_cls': np.int32(cls), 'index': np.int32(index),
        }
        if self.with_supports:
            item['support_ims'] = self.supports(cls, index)
        return item


class GeneralTestLoader(InferenceLoader):
    """Queries only (reference general_test_loader.py:48-68)."""

    def __init__(self, roidb, **kw):
        super().__init__(roidb, pool=None, **kw)

    def __getitem__(self, index):
        im_data, im_info = self._query_blob(
            blob.imread_bgr(self.roidb[index]['image']))
        return {'im_data': im_data, 'im_info': im_info,
                'num_boxes': np.int32(0), 'index': np.int32(index)}


class OracleLoader(GeneralTestLoader):
    """Queries with every class's gt and no supports, for the oracle
    evaluation of a conventional detector (reference oracle_loader.py:
    56-205): the gt rows shuffled by `default_rng((seed, index))`,
    degenerate boxes dropped, padded to `max_num_box`; the labels keep
    their class ids.  The bucket canvas stands in for the reference's
    per-batch crop and pad."""

    def __init__(self, roidb, max_num_box=20, seed=1996, **kw):
        super().__init__(roidb, max_num_box=max_num_box, **kw)
        self.seed = seed

    def __getitem__(self, index):
        item = super().__getitem__(index)
        entry = self.roidb[index]
        rng = np.random.default_rng((self.seed, index))
        gt = np.zeros((len(entry['boxes']), 5), np.float32)
        gt[:, :4] = entry['boxes'] * item['im_info'][2]
        gt[:, 4] = entry['gt_classes']
        rng.shuffle(gt)
        keep = (gt[:, 0] != gt[:, 2]) & (gt[:, 1] != gt[:, 3])
        gt = gt[keep][:self.max_num_box]
        gt_pad = np.zeros((self.max_num_box, 5), np.float32)
        gt_pad[:len(gt)] = gt
        item['gt_boxes'] = gt_pad
        item['num_boxes'] = np.int32(len(gt))
        return item


class MultiwayLoader(InferenceLoader):
    """The N-way episode (reference multiway_loader.py:88-129): each item
    carries the supports of `num_way` classes, stacked way-major,
    `support_ims` [num_way * shot, S, S, 3], and their classes
    `selected_ways`.  The classes present in the query come first, in
    the iteration order of a CPython set of their ids, as the reference
    takes them; more present classes than ways -> `Random(epi_seed)`
    samples num_way of them; fewer -> the rest are a `Random(epi_seed)`
    sample of the pool's other classes.  Only classes the pool holds
    supports of are ways."""

    def __init__(self, roidb, pool, num_way=5, epi_seed=0, **kw):
        kw['with_supports'] = False
        super().__init__(roidb, pool, **kw)
        self.num_way = num_way
        self.epi_seed = epi_seed

    def select_ways(self, gt_classes):
        avail = self.pool.classes_available()
        avail_set = set(avail)
        present = [c for c in set(int(c) for c in gt_classes if int(c) != 0)
                   if c in avail_set]
        if len(present) > self.num_way:
            return random.Random(self.epi_seed).sample(present,
                                                       k=self.num_way)
        other = [c for c in avail if c not in present]
        return present + random.Random(self.epi_seed).sample(
            other, k=min(self.num_way - len(present), len(other)))

    def __getitem__(self, index):
        item = super().__getitem__(index)
        ways = self.select_ways(self.roidb[index]['gt_classes'])
        sup = np.stack([self.pool.get(c) for c in ways])
        item['support_ims'] = sup.reshape(-1, *sup.shape[2:])
        item['selected_ways'] = np.array(ways, np.int32)
        return item


class ResamplingSupportPool:
    """Support crops drawn anew for each item from a support roidb: item
    `index` draws class `cls`'s `num_shot` crops with
    `default_rng((seed, index))`, without replacement unless the class
    has fewer crops, and decodes only those.  The JAX package keeps one
    generator that `reseed(index)` replaces before each item; a generator
    of the item's own gives the same draws and lets items be assembled
    concurrently."""

    def __init__(self, classes, num_shot, support_roidb, seed=0,
                 pixel_means=PIXEL_MEANS, support_size=320):
        self.num_shot = num_shot
        self.support_size = support_size
        self.pixel_means = pixel_means
        self.support_roidb = support_roidb
        self.db = build_support_db(support_roidb, len(classes))
        self.seed = seed

    def classes_available(self):
        return [c for c in range(len(self.db)) if self.db[c]]

    def get(self, cls_ind, index):
        """Item `index`'s [shot, S, S, 3] supports of class `cls_ind`."""
        pool = self.db[cls_ind]
        if not pool:
            raise ValueError(f'class {cls_ind} has an empty support pool')
        rng = np.random.default_rng((self.seed, int(index)))
        pick = rng.choice(len(pool), self.num_shot,
                          replace=len(pool) < self.num_shot)
        return np.stack([
            _crop_support(
                blob.imread_bgr(
                    self.support_roidb[pool[int(i)]['roidb_idx']]['image']),
                pool[int(i)]['box'], self.pixel_means, self.support_size)
            for i in pick])


def _first_appearance(gt_classes):
    """The image's foreground classes in the order of their first gt box."""
    seen = []
    for c in gt_classes:
        if int(c) and int(c) not in seen:
            seen.append(int(c))
    return seen


class ALLCLSFSLoader(InferenceLoader):
    """Supports drawn anew for every item (reference allcls_fs_loader.py:
    66-115); each item carries `support_ims` [shot, S, S, 3].

    Directory mode (`support_dir`, the reference's protocol): a class's
    candidates are every `*.jpg` of its directory; the target class is
    `Random(0).sample(k=1)` over the query's classes in first-appearance
    order; the gt keeps that class's boxes only; the supports are
    `Random(index).sample(paths, k=shot)`, each whole image prepared as a
    support.  A class short of `num_shot` images raises at construction
    if it can be a target, else warns; a class without images raises.

    Crop mode (`support_roidb`): the target class is the first gt box's,
    and the supports are `ResamplingSupportPool`'s draws for the item."""

    def __init__(self, roidb, support_roidb=None, classes=None,
                 num_shot=5, seed=0, support_dir=None, **kw):
        kw['with_supports'] = True
        self._paths = None
        self.num_shot = num_shot
        pool = None
        if support_dir is None:
            pool = ResamplingSupportPool(
                classes, num_shot, support_roidb, seed=seed,
                pixel_means=kw.get('pixel_means', PIXEL_MEANS))
        elif seed:
            raise ValueError('directory mode follows the reference fixed-seed '
                             'protocol; seed applies to crop mode only')
        else:
            # only a class that can be drawn as a target must have
            # num_shot images: the reference never samples the others
            reachable = {random.Random(0).sample(seen, k=1)[0]
                         for seen in map(_first_appearance,
                                         (r['gt_classes'] for r in roidb))
                         if seen}
            self._paths = {}
            for cls_ind, name in enumerate(classes):
                if name == '__background__':
                    continue
                files = _list_support_files(support_dir, name)
                if not files:
                    raise FileNotFoundError(
                        f'support data not found in '
                        f'{osp.join(support_dir, name)}')
                if len(files) < num_shot:
                    msg = (f'{osp.join(support_dir, name)} has {len(files)} '
                           f'support images but num_shot={num_shot}; the '
                           'reference protocol samples without replacement')
                    if cls_ind in reachable:
                        raise ValueError(msg)
                    warnings.warn(msg + ' (class never sampled as a target '
                                  'in this roidb; continuing)')
                self._paths[cls_ind] = files
        super().__init__(roidb, pool, **kw)

    def target_class(self, index):
        if self._paths is None:
            return super().target_class(index)
        return random.Random(0).sample(
            _first_appearance(self.roidb[index]['gt_classes']), k=1)[0]

    def supports(self, cls, index):
        if self._paths is None:
            return self.pool.get(cls, index)
        picks = random.Random(index).sample(self._paths[cls], k=self.num_shot)
        return np.stack([blob.support_blob_whole(blob.imread_bgr(p),
                                                 self.pixel_means, 320)
                         for p in picks])

    def __getitem__(self, index):
        item = super().__getitem__(index)
        if self._paths is None:
            return item
        # directory mode keeps the target class's gt only (the reference
        # returns num_boxes 0; the count of the kept rows is given here,
        # as in the JAX package)
        cls = int(item['target_cls'])
        entry = self.roidb[index]
        sel = entry['gt_classes'] == cls
        gt = np.zeros((self.max_num_box, 5), np.float32)
        n = min(int(sel.sum()), self.max_num_box)
        gt[:n, :4] = entry['boxes'][sel][:n] * item['im_info'][2]
        gt[:n, 4] = cls
        item['gt_boxes'] = gt
        item['num_boxes'] = np.int32(n)
        return item
