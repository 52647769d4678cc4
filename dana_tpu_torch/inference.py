"""Episodic evaluation of the DAnA detector on a COCO-format dataset, on the
PyTorch port.

    python -m dana_tpu_torch.inference --dataset synth --way 2 --shot 3 \\
        --bs 8 [--checkpath model.dkpt|model.pth] [--eval_dir DIR] \\
        [--device cpu] [--set KEY VALUE ...]

The protocol of the repo's root `inference.py` (the JAX package's CLI),
with the same flags: the roidb of the eval split; a fixed support pool per
class (the directory pool `<DATA_DIR>/supports` when present, else seeded
crops from the split named by a test -> train substitution, else, loudly,
from the eval split itself), each class encoded once; the images grouped
by query bucket into batches of --bs, the last item repeated to fill a
batch; `Predictor.predict` with the detection postprocess;
`detections.pkl` in the `all_boxes[class][image]` layout; and the numpy
COCOeval, whose result dict `main` returns, with the detection pass's
timing under 'timing'.

Host and device overlap: a thread pool of min(8, cores) assembles chunks
(decode, resize, pad; pinned host memory on the card) a few chunks ahead,
and the loop keeps one chunk in flight, reading chunk i's detections back
only after chunk i+1 has been handed to the card.

It runs on the card; without CUDA it raises unless --device cpu is given.
Multi-GPU flags, other networks, int8 serving and the space-to-depth stem
are refused (utils/args.py).
"""

from __future__ import annotations

import json
import os
import pickle
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from dana_tpu_torch.data.blob import ImageCache
from dana_tpu_torch.data.imdb import combined_roidb
from dana_tpu_torch.data.inference_loader import InferenceLoader, SupportPool
from dana_tpu_torch.engine.predict import Predictor
from dana_tpu_torch.models import dana
from dana_tpu_torch.utils import checkpoint as ckpt_lib
from dana_tpu_torch.utils.args import load_cfg, parse_args
from dana_tpu_torch.utils.config import dana_config, postprocess_kwargs
from dana_tpu_torch.utils.device import resolve_device


def _checkpoint(args):
    """The checkpoint path the flags name, or None: --checkpath, or with
    --r the one under --load_dir, also found as .pth or _preempt."""
    if not (args.checkpath or args.resume):
        return None
    path = args.checkpath or ckpt_lib.checkpoint_path(
        args.load_dir, args.checkepoch, args.checkpoint)
    if not os.path.exists(path):
        base, ext = os.path.splitext(path)
        for cand in (base + '.pth', f'{base}_preempt{ext}'):
            if os.path.exists(cand):
                return cand
    return path


def _support_pool(args, c, imdb_, roidb, cache):
    sup_dir = os.path.join(c.DATA_DIR, 'supports') \
        if args.sup_dir == 'all' else args.sup_dir
    support_roidb = None
    if not os.path.isdir(sup_dir):
        train_name = args.imdbval_name.replace('test', 'train') \
            if 'synth' in args.imdbval_name else args.imdbval_name
        try:
            _, support_roidb, _, _ = combined_roidb(
                train_name, training=False, use_flipped=False,
                data_dir=c.DATA_DIR)
        except KeyError:
            # a query's own gt crop can then be its support, which
            # inflates AP against the reference protocol
            print(f'WARNING: no support split for {args.imdbval_name} '
                  f'(tried {train_name}); falling back to the EVAL '
                  f'split\'s own annotations — AP is not '
                  f'protocol-comparable', flush=True)
            support_roidb = roidb
        sup_dir = None
    return SupportPool(imdb_.classes, args.shot, support_dir=sup_dir,
                       support_roidb=support_roidb, seed=0,
                       pixel_means=c.PIXEL_MEANS,
                       exact_support_scale=c.TPU.EXACT_SUPPORT_SCALE,
                       target_size=c.TRAIN.SCALES[0], image_cache=cache)


def main(argv=None):
    args = parse_args(argv)
    c = load_cfg(args)
    device = resolve_device(args.device)

    imdb_, roidb, _, _ = combined_roidb(args.imdbval_name, training=False,
                                        use_flipped=False, data_dir=c.DATA_DIR)
    num_images = len(roidb)
    print(f'{num_images} eval images')

    config = dana_config(c, args.way, args.shot)
    path = _checkpoint(args)
    if path:
        params, _ = ckpt_lib.load_checkpoint(path, config)
        print(f'loaded checkpoint {path}')
    else:
        params = dana.init_params(config, seed=args.seed)
    pred = Predictor(params, config, device=device,
                     postprocess=postprocess_kwargs(c))

    # several support crops may share an image; each query image is read
    # once, so the queries bypass the cache
    cache = ImageCache(c.TPU.IMAGE_CACHE_MB) if c.TPU.IMAGE_CACHE_MB > 0 \
        else None
    pool = _support_pool(args, c, imdb_, roidb, cache)
    loader = InferenceLoader(
        roidb, pool, pixel_means=c.PIXEL_MEANS,
        max_num_box=c.MAX_NUM_GT_BOXES, buckets=c.TPU.SIZE_BUCKETS,
        scale=c.TEST.SCALES[0],
        max_size=None if c.TPU.EXACT_QUERY_SCALE else c.TEST.MAX_SIZE,
        ship_uint8=c.TPU.SHIP_UINT8)

    eval_bs = max(1, args.batch_size)
    groups = {}
    for i in range(num_images):
        groups.setdefault(loader.bucket_of(i), []).append(i)
    chunks = [idxs[s:s + eval_bs] for _, idxs in sorted(groups.items())
              for s in range(0, len(idxs), eval_bs)]
    all_boxes = [[[] for _ in range(num_images)]
                 for _ in range(imdb_.num_classes)]
    pin = device.type == 'cuda'

    def assemble(chunk):
        """One chunk's batch, on a worker thread: decode, resize, pad,
        the last item repeated to fill the batch."""
        t = time.perf_counter()
        items = [loader[i] for i in chunk]
        items += [items[-1]] * (eval_bs - len(chunk))
        batch = {k: torch.from_numpy(np.stack([it[k] for it in items]))
                 for k in ('im_data', 'im_info')}
        if pin:
            batch = {k: v.pin_memory() for k, v in batch.items()}
        classes = [int(it['target_cls']) for it in items]
        return chunk, batch, classes, time.perf_counter() - t

    def flush(entry):
        chunk, classes, dets, valid = entry
        dets, valid = dets.cpu().numpy(), valid.cpu().numpy()
        for bi, img_idx in enumerate(chunk):
            all_boxes[classes[bi]][img_idx] = dets[bi][valid[bi]]

    # no floor of 2 threads: a one-core host gains nothing from a second
    workers = min(8, os.cpu_count() or 1)
    # each chunk in flight holds its batch on the host (~60 MB at bs 8,
    # 608x1024, float32): a capped lookahead
    lookahead = min(workers + 2, 8)
    timing = dict(assemble_s=0.0, wait_s=0.0, predict_s=0.0)
    n_done, in_flight = 0, None
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=workers) as ex:
        pending = [ex.submit(assemble, ch) for ch in chunks[:lookahead]]
        try:
            for ci in range(len(chunks)):
                t = time.perf_counter()
                chunk, batch, classes, secs = pending[ci].result()
                timing['wait_s'] += time.perf_counter() - t
                timing['assemble_s'] += secs
                pending[ci] = None
                if ci + lookahead < len(chunks):
                    pending.append(ex.submit(assemble,
                                             chunks[ci + lookahead]))
                t = time.perf_counter()
                for cls in set(classes):
                    if not pred.has_supports(cls):
                        pred.encode_supports(cls, pool.get(cls))
                dets, valid = pred.predict(batch['im_data'],
                                           batch['im_info'], classes)
                if in_flight is not None:
                    flush(in_flight)
                in_flight = (chunk, classes, dets, valid)
                timing['predict_s'] += time.perf_counter() - t
                n_done += len(chunk)
                if n_done % (20 * eval_bs) < eval_bs:
                    print(f'{n_done}/{num_images} imgs, '
                          f'{n_done / (time.perf_counter() - t0):.2f} img/s',
                          flush=True)
            if in_flight is not None:
                flush(in_flight)
        finally:
            for f in pending:
                if f is not None:
                    f.cancel()

    detect_s = time.perf_counter() - t0
    timing.update(images=num_images, chunks=len(chunks), detect_s=detect_s,
                  img_per_s=num_images / detect_s)
    out_dir = args.eval_dir or os.path.join(args.save_dir, 'eval')
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, 'detections.pkl'), 'wb') as f:
        pickle.dump(all_boxes, f)
    print(f'total detect time {detect_s:.1f}s '
          f'({num_images / detect_s:.2f} img/s)', flush=True)
    print(f'timing {json.dumps(timing)}', flush=True)
    result = imdb_.evaluate_detections(all_boxes, out_dir)
    result['timing'] = timing
    return result


if __name__ == '__main__':
    main(sys.argv[1:])
