"""The episodic few-shot training loaders, ported from the JAX package's
`data/fs_loader.py`: the support database, `FewShotLoader` (episodes
from the roidb's own crops), `FinetuneLoader` (supports from a directory
pool), `EpisodicBatcher` (same-bucket batches, a seeded shuffle per epoch,
thread-pool assembly) and `Prefetcher` (batches to the card on a side
stream, in place of the JAX package's `prefetch_to_device`).

Each item is ONE episode: a query image padded onto its static bucket
canvas, `shot` positive supports of one class present in the query (gt
filtered to that class, labels remapped to 1, reference fs_loader.py:286-291)
and `shot` negative supports of an absent class.  Each item draws from its
own `default_rng((seed, index))`, so the worker count never changes what
is produced.
"""

from __future__ import annotations

import glob
import os.path as osp
import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from dana_tpu_torch.data import blob
from dana_tpu_torch.utils.config import PIXEL_MEANS


def build_support_db(roidb, num_classes, size_threshold=64):
    """class idx -> [{'roidb_idx', 'box'}]: the reference's filters
    (fs_loader.py:58-78): non-flipped entries, non-crowd boxes, both sides
    >= size_threshold px, aspect ratio <= 2."""
    db = [[] for _ in range(num_classes)]
    for roidb_idx, entry in enumerate(roidb):
        if entry.get('flipped'):
            continue
        for i in _gt_indices(entry):
            box = entry['boxes'][i].astype(np.float32)
            cls = int(entry['gt_classes'][i])
            w, h = box[2] - box[0], box[3] - box[1]
            if w < size_threshold or h < size_threshold \
                    or w > 2 * h or h > 2 * w:
                continue
            db[cls].append({'roidb_idx': roidb_idx, 'box': box})
    return db


def _gt_indices(entry):
    """The entry's non-crowd object boxes (crowd rows have overlap -1)."""
    overlaps = entry['gt_overlaps']
    overlaps = overlaps.toarray() if hasattr(overlaps, 'toarray') \
        else overlaps
    return np.where((entry['gt_classes'] != 0)
                    & np.all(overlaps > -1.0, axis=1))[0]


class FewShotLoader:
    """Episodes whose supports are crops of the roidb's own boxes.

    `max_size` None scales queries by the shortest side alone, as the
    reference does (TPU.EXACT_QUERY_SCALE); `exact_support` picks the
    reference's support crop (`support_blob_exact`, TPU.EXACT_SUPPORT_SCALE)
    over the one-resampling approximation; `support_cache` decoded crops
    (TPU.SUPPORT_CACHE) are kept.  `allowed_classes`: the classes the
    positive way may be drawn from (base / novel split training)."""

    def __init__(self, roidb, num_classes, num_way=2, num_shot=5,
                 max_num_box=20, seed=1996, pixel_means=PIXEL_MEANS,
                 buckets=blob.DEFAULT_BUCKETS, scale=600, max_size=None,
                 support_size=320, allowed_classes=None, support_cache=2048,
                 exact_support=True):
        self.roidb = roidb
        self.num_classes = num_classes
        self.num_way = num_way
        self.num_shot = num_shot
        self.max_num_box = max_num_box
        self.seed = seed
        self.pixel_means = pixel_means
        self.buckets = [tuple(b) for b in buckets]
        self.scale = scale
        self.max_size = max_size
        self.support_size = support_size
        self.allowed_classes = (set(allowed_classes)
                                if allowed_classes is not None else None)
        self.support_db = build_support_db(roidb, num_classes)
        # the per-class pools are small, so crops recur every few episodes
        self._sup_cache = blob.FIFOCache(support_cache)
        self.exact_support = bool(exact_support)

    def _class_has_supports(self, cls: int) -> bool:
        return bool(self.support_db[cls])

    def _allowed(self, cls: int) -> bool:
        return self.allowed_classes is None or cls in self.allowed_classes

    def valid_indices(self):
        """roidb indices usable as episodes: an allowed positive class with
        a non-empty support pool."""
        return [i for i, entry in enumerate(self.roidb)
                if any(self._allowed(c) and self._class_has_supports(c)
                       for c in {int(c) for c in entry['gt_classes'] if c})]

    def __len__(self):
        return len(self.roidb)

    def _cached(self, key, make):
        hit = self._sup_cache.get(key)
        if hit is not None:
            return hit
        made = make()
        made.flags.writeable = False
        return self._sup_cache.put(key, made)

    def _support_image(self, info):
        def make():
            im = blob.imread_bgr(self.roidb[info['roidb_idx']]['image'])
            if self.exact_support:
                # the reference's prep_im_for_blob never caps the long
                # side (blob.py:46-47), whatever the query scaling
                return blob.support_blob_exact(
                    im, info['box'], self.pixel_means, self.support_size,
                    target_size=self.scale, max_size=None)
            return blob.support_blob(im, info['box'], self.pixel_means,
                                     self.support_size)
        return self._cached((int(info['roidb_idx']),
                             tuple(float(v) for v in info['box'][:4])), make)

    def _sample_supports(self, cls, rng):
        pool = self.support_db[cls]
        if not pool:
            raise ValueError(f'class {cls} has an empty support pool: '
                             'episodes must be drawn from valid_indices()')
        idx = rng.choice(len(pool), self.num_shot,
                         replace=len(pool) < self.num_shot)
        return [self._support_image(pool[int(i)]) for i in idx]

    def bucket_of(self, index):
        """The static canvas this entry lands on (for batch grouping)."""
        e = self.roidb[index]
        h, w = e['height'], e['width']
        s = blob.query_scale(h, w, self.scale, self.max_size)
        return blob.pick_bucket(round(h * s), round(w * s), self.buckets)

    def __getitem__(self, index):
        entry = self.roidb[index]
        rng = np.random.default_rng((self.seed, index))

        im_data, im_info = blob.query_blob(
            blob.imread_bgr(entry['image']), self.pixel_means, self.scale,
            self.max_size, flipped=bool(entry.get('flipped')),
            buckets=self.buckets)
        gt_inds = _gt_indices(entry)
        gt = np.zeros((len(gt_inds), 5), np.float32)
        gt[:, :4] = entry['boxes'][gt_inds] * im_info[2]
        gt[:, 4] = entry['gt_classes'][gt_inds]
        rng.shuffle(gt)

        classes_in_query = sorted({int(c) for c in gt[:, 4]})
        eligible = [c for c in classes_in_query
                    if self._allowed(c) and self._class_has_supports(c)]
        if not eligible:
            raise ValueError(
                f'roidb[{index}] has no positive class with supports '
                f'(classes {classes_in_query}); iterate valid_indices()')
        pos_cls = int(rng.choice(eligible))

        supports = np.zeros((self.num_way * self.num_shot, self.support_size,
                             self.support_size, 3), np.float32)
        for i, s in enumerate(self._sample_supports(pos_cls, rng)):
            supports[i] = s
        if self.num_way > 1:
            absent = [c for c in range(1, self.num_classes)
                      if c not in classes_in_query
                      and self._class_has_supports(c) and self._allowed(c)]
            neg_cls = int(rng.choice(absent)) if absent else pos_cls
            for i, s in enumerate(self._sample_supports(neg_cls, rng)):
                supports[self.num_shot + i] = s

        fs = gt[gt[:, 4] == pos_cls].copy()
        fs[:, 4] = 1.0
        fs_pad, num_boxes = self._pad_boxes(fs)
        gt_pad, _ = self._pad_boxes(gt)
        return {
            'im_data': im_data, 'im_info': im_info,
            'gt_boxes': fs_pad, 'num_boxes': np.int32(num_boxes),
            'support_ims': supports, 'all_gt_boxes': gt_pad,
            'pos_cls': np.int32(pos_cls),
        }

    def _pad_boxes(self, b):
        """Drop degenerate boxes, keep max_num_box, zero-pad -> (boxes, n)."""
        out = np.zeros((self.max_num_box, 5), np.float32)
        b = b[(b[:, 0] != b[:, 2]) & (b[:, 1] != b[:, 3])][:self.max_num_box]
        out[:len(b)] = b
        return out, len(b)


class FinetuneLoader(FewShotLoader):
    """Episodes whose supports come from the directory pool
    `<support_dir>/<class name>/*` (reference finetune_loader.py:99-149),
    each a whole image prepared as `blob.support_blob_whole`."""

    def __init__(self, roidb, num_classes, class_names, support_dir, **kw):
        super().__init__(roidb, num_classes, **kw)
        self.support_files = {}
        for cls_ind, name in enumerate(class_names):
            if name == '__background__':
                continue
            files = sorted(glob.glob(osp.join(support_dir, name, '*')))
            if files:
                self.support_files[cls_ind] = files

    def _class_has_supports(self, cls: int) -> bool:
        return cls in self.support_files

    def _sample_supports(self, cls, rng):
        if cls not in self.support_files:
            raise ValueError(f'class {cls} has no support directory files: '
                             'episodes must be drawn from valid_indices()')
        files = self.support_files[cls]
        idx = rng.choice(len(files), self.num_shot,
                         replace=len(files) < self.num_shot)
        return [self._cached(files[int(i)], lambda p=files[int(i)]:
                             blob.support_blob_whole(
                                 blob.imread_bgr(p), self.pixel_means,
                                 self.support_size))
                for i in idx]


class EpisodicBatcher:
    """Batches of same-bucket episodes (the reference's ratio-grouped
    sampler and 8-worker DataLoader, fs_loader.py:332-354, train.py:57-59).

    Epoch e shuffles with `default_rng((seed, e))`: the episodes within each
    bucket, then the batches.  Iterating starts epoch `epoch + 1`; a
    resumed run sets `epoch` to its last finished epoch, so that it draws
    what a straight run would.  With num_workers > 1 a thread pool
    assembles the episodes, `lookahead` batches ahead of the consumer
    (file reads and numpy's array passes release the interpreter lock for
    part of their time; the rest competes with the consumer's thread).

    batch_size is the global batch.  In a run of `process_count` processes
    (parallel/distributed.py) each passes its `process_id`: the batches'
    indices are the same on every process (seeded), and each assembles
    only its row block [id B/P, (id+1) B/P) of every batch, so the ranks'
    rows in rank order are the one-process batches.  A bucket shorter than
    the batch (drop_last False) is cycled to fill it, so the blocks stay
    equal."""

    def __init__(self, loader: FewShotLoader, batch_size, shuffle=True,
                 seed=0, drop_last=True, process_id=0, process_count=1,
                 num_workers=0, lookahead=2):
        if batch_size % max(1, process_count):
            raise ValueError(
                f'global batch {batch_size} must divide evenly over '
                f'{process_count} processes')
        self.loader = loader
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.process_id = process_id
        self.process_count = max(1, process_count)
        self.num_workers = int(num_workers)
        self.lookahead = max(1, int(lookahead))
        self.epoch = 0

    def index_batches(self, epoch):
        """Epoch `epoch`'s batches of roidb indices."""
        groups = {}
        for i in self.loader.valid_indices():
            groups.setdefault(self.loader.bucket_of(i), []).append(i)
        rng = np.random.default_rng((self.seed, epoch))
        batches = []
        for _, idxs in sorted(groups.items()):
            idxs = np.array(idxs)
            if self.shuffle:
                rng.shuffle(idxs)
            for s in range(0, len(idxs), self.batch_size):
                chunk = idxs[s:s + self.batch_size]
                if len(chunk) < self.batch_size:
                    if self.drop_last:
                        continue
                    # cycle the bucket until the batch is full
                    reps = int(np.ceil(self.batch_size / len(idxs)))
                    pad = np.tile(idxs, reps)[:self.batch_size - len(chunk)]
                    chunk = np.concatenate([chunk, pad])
                batches.append(list(chunk))
        if self.shuffle:
            rng.shuffle(batches)
        return batches

    def __len__(self):
        return len(self.index_batches(self.epoch + 1))

    def _stack(self, items):
        return {k: np.stack([it[k] for it in items]) for k in items[0]}

    def __iter__(self):
        self.epoch += 1
        per = self.batch_size // self.process_count
        lo = self.process_id * per
        rows = [b[lo:lo + per] for b in self.index_batches(self.epoch)]
        if self.num_workers <= 1:
            for batch_idx in rows:
                yield self._stack([self.loader[i] for i in batch_idx])
            return
        ex = ThreadPoolExecutor(max_workers=self.num_workers,
                                thread_name_prefix='dana-episode')
        try:
            pending, it = deque(), iter(rows)

            def submit_next():
                batch_idx = next(it, None)
                if batch_idx is not None:
                    pending.append([ex.submit(self.loader.__getitem__, i)
                                    for i in batch_idx])

            for _ in range(1 + self.lookahead):
                submit_next()
            while pending:
                futs = pending.popleft()
                items = [f.result() for f in futs]
                submit_next()
                yield self._stack(items)
        finally:
            # an abandoned epoch must not strand threads on its decodes
            ex.shutdown(wait=False, cancel_futures=True)


class _Failed:
    def __init__(self, error):
        self.error = error


_END = object()


class Prefetcher:
    """Iterate `batches` (dicts of numpy arrays) on a background thread,
    `size` batches ahead, as dicts of tensors on `device`.

    On the card each batch is copied into pinned host memory, one copy per
    array, then to the card with `non_blocking` on a side CUDA stream; the
    consumer's stream waits for that batch's copies (an event recorded
    after them on the side stream) and each tensor `record_stream`s the
    consumer's stream, so the caching allocator never hands its memory to
    the side stream while the consumer may still read it.  On the CPU the
    batches are handed over as CPU tensors, unpinned.

    An exception in the worker is raised again in the consuming thread.
    `wait_s` sums the consumer's seconds spent waiting for a batch."""

    def __init__(self, batches, device, size=2):
        self.batches = batches
        self.device = torch.device(device)
        self.size = size
        self.wait_s = 0.0

    def _upload(self, batch, stream):
        if stream is None:
            return {k: torch.from_numpy(np.asarray(v))
                    for k, v in batch.items()}, None
        with torch.cuda.stream(stream):
            out = {k: torch.from_numpy(np.asarray(v)).pin_memory()
                   .to(self.device, non_blocking=True)
                   for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

    def __iter__(self):
        q = queue.Queue(maxsize=self.size)
        stop = threading.Event()
        side = (torch.cuda.Stream(self.device)
                if self.device.type == 'cuda' else None)

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            it = iter(self.batches)
            try:
                for batch in it:
                    if not put(self._upload(batch, side)):
                        return
                put(_END)
            except BaseException as e:        # handed to the consumer
                put(_Failed(e))
            finally:
                close = getattr(it, 'close', None)
                if close is not None:
                    close()

        t = threading.Thread(target=worker, name='dana-prefetch',
                             daemon=True)
        t.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                self.wait_s += time.perf_counter() - t0
                if item is _END:
                    return
                if isinstance(item, _Failed):
                    raise item.error
                batch, done = item
                if done is not None:
                    consumer = torch.cuda.current_stream(self.device)
                    consumer.wait_event(done)
                    for v in batch.values():
                        v.record_stream(consumer)
                yield batch
        finally:
            stop.set()
            t.join(timeout=60)
