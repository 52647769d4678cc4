"""Episodic evaluation of a few-shot detector on a COCO-format dataset, on
the PyTorch port.

    python -m dana_tpu_torch.inference --dataset synth --way 2 --shot 3 \\
        --bs 8 [--net DAnA|cisa|fsod|meta|fgn|res101|vgg16] \\
        [--backbone res50|res101|vgg16] [--ls] \\
        [--checkpath model.dkpt|model.pth] [--eval_dir DIR] \\
        [--device cpu] [--set KEY VALUE ...]

The protocol of the repo's root `inference.py` (the JAX package's CLI),
with the same flags: the roidb of the eval split; a fixed support pool per
class (the directory pool `<DATA_DIR>/supports` when present, else seeded
crops from the split named by a test -> train substitution, else, loudly,
from the eval split itself), each class encoded once for DAnA and cisa,
each chunk's stack of its images' class supports encoded with the chunk
for FSOD, Meta R-CNN and FGN (as the JAX CLI does); the images grouped
by query bucket into batches of --bs, the last item repeated to fill a
batch; `Predictor.predict` with the detection postprocess;
`detections.pkl` in the `all_boxes[class][image]` layout; and the numpy
COCOeval, whose result dict `main` returns, with the detection pass's
timing under 'timing'.

Host and device overlap: a thread pool of min(8, cores) assembles chunks
(decode, resize, pad; pinned host memory on the card) a few chunks ahead,
and the loop keeps one chunk in flight, reading chunk i's detections back
only after chunk i+1 has been handed to the card.

The detector runs on the trunk --backbone names (or --net, where that is
a backbone name), with the config tree's POOLING_MODE, which a checkpoint
overrides with the mode it was trained with; --ls serves at
cfgs/res101_ls.yml's values (800 px queries, 1000 proposals an image).

Several devices (dana_tpu_torch/parallel), as the JAX CLI: --mGPUs,
--tp N or --sp N serve over `parallel.local_devices()` when it names more
than one device, on a (data, model=N) grid of `Predictor(devices=, tp=,
sp=)` (--tp with --sp is refused), --bs rounded up to a multiple of the
data extent.  --dist --coordinator HOST:PORT --num_procs N --proc_id R
(or torchrun's environment) splits the chunks over N processes, rank r
taking chunks[r::N] on its own device; each writes
`detections_rank{r}.pkl`, and after a barrier sized to the pass the chief
merges them into `detections.pkl` and evaluates (the others return
None).

--set TPU.QUANT_INT8 True serves int8, as the JAX CLI does: after the
checkpoint loads, the trunk's convs in TPU.QUANT_SCOPE ('tail': layer4, the
default; 'all': every conv) are quantized (dana_tpu_torch/quant.py) and
RoIAlign on a map that is not float32 runs in int8; the CLI prints the
JAX CLI's line.  With --mGPUs, or --sp under scope 'all', every quantized
conv takes one activation scale over the whole request, as the JAX CLI's
mesh forms it (engine/predict.py); under --dist each rank's chunk is its
own tensor, in both packages.

--set TPU.STEM_S2D True serves the ResNet trunks on the space-to-depth
stem, as the JAX CLI's default does: the loader packs each query
(`blob.query_blob_packed`, one native pass from the resized image) and the
supports (`blob.s2d_pack`, the DAnA / cisa encodes and the siblings' batch
stacks) into 12 channels, and conv1 runs as a 4x4/1 conv on them
(models/resnet.py).  VGG16 and --sp keep the direct stem (a packed query's
H/2+3 rows split over no spatial blocks), as in the JAX CLI; the port
decides by the trunk it serves, the JAX CLI by --backbone alone.

It runs on the card; without CUDA it raises unless --device cpu is given.
--net frcnn is refused: Faster R-CNN's
class-specific deltas [B, R, 8] meet the postprocess's 4 bbox stds, which
the JAX package's postprocess cannot broadcast either, so the JAX CLI
raises on it.
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

from dana_tpu_torch import quant
from dana_tpu_torch.data.blob import ImageCache, s2d_pack
from dana_tpu_torch.data.imdb import combined_roidb
from dana_tpu_torch.data.inference_loader import InferenceLoader, SupportPool
from dana_tpu_torch.engine.predict import Predictor
from dana_tpu_torch.models import frameworks
from dana_tpu_torch.parallel import distributed, local_devices
from dana_tpu_torch.utils import checkpoint as ckpt_lib
from dana_tpu_torch.utils.args import load_cfg, parse_args
from dana_tpu_torch.utils.config import NETS, dana_config, postprocess_kwargs


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


def quantize(params, scope):
    """The int8 serving transform of the detector (a module, quantized in
    place, or a param tree), with the JAX CLI's line; -> the quantized
    detector."""
    if isinstance(params, torch.nn.Module):
        params = quant.quantize_model(params, scope)
    else:
        params = quant.quantize_params(params, scope)
    n_q = quant.count_int8(params)
    if n_q:
        print(f'int8-quantized {n_q} convs (scope={scope}) + int8 roi_align')
    else:
        print(f'WARNING: TPU.QUANT_INT8 quantized 0 convs for this '
              f'backbone/scope ({scope}) — only the int8 roi_align path is '
              'active')
    return params


def main(argv=None):
    args = parse_args(argv)
    if args.tp > 1 and args.sp > 1:
        raise SystemExit('--tp and --sp both shard the mesh "model" '
                         'axis — pick one latency mode')
    if not args.dist:
        return evaluate(args)
    group = distributed.init_distributed(args.coordinator, args.num_procs,
                                         args.proc_id, device=args.device)
    print(f'distributed eval: process {group.rank}/{group.size} on '
          f'{distributed.rank_device(args.device)}', flush=True)
    try:
        return evaluate(args, group)
    finally:
        distributed.shutdown()


def evaluate(args, group=distributed.SINGLE):
    """The evaluation of the parsed flags on this rank of `group`."""
    if NETS[args.net] == 'frcnn':
        raise SystemExit(
            '--net frcnn: Faster R-CNN\'s class-specific deltas [B, R, 8] '
            'meet the detection postprocess\'s 4 bbox stds, which the JAX '
            'package\'s postprocess cannot broadcast either '
            '(dana_tpu/engine/postprocess.py:38): its dataset CLI raises, so '
            'there is no serving path to port')
    c = load_cfg(args)
    rank, nproc = group.rank, group.size
    # under --dist each rank serves on its own device
    devices = [distributed.rank_device(args.device)] if group.distributed \
        else local_devices(args.device)
    tp, sp = max(1, args.tp), max(1, args.sp)
    if not ((args.mGPUs or tp > 1 or sp > 1) and len(devices) > 1):
        devices, tp, sp = devices[:1], 1, 1
    if len(devices) > max(tp, sp) and len(set(devices)) > 1:
        print('warning: the grid\'s data rows are driven from this one '
              'process, so a request takes longer over several cards than '
              'on one; for throughput start one process per card with '
              '--dist', flush=True)
    device = devices[0]

    imdb_, roidb, _, _ = combined_roidb(args.imdbval_name, training=False,
                                        use_flipped=False, data_dir=c.DATA_DIR)
    num_images = len(roidb)
    print(f'{num_images} eval images')

    config = dana_config(c, args.way, args.shot, args.net, args.backbone)
    path = _checkpoint(args)
    if path:
        params, payload = ckpt_lib.load_checkpoint(path, config)
        config = ckpt_lib.take_pooling_mode(payload, c, config)
        print(f'loaded checkpoint {path} (pooling {config.pooling_mode})')
    else:
        params = frameworks.init_params(config, seed=args.seed)
    if c.TPU.QUANT_INT8:
        params = quantize(params, c.TPU.QUANT_SCOPE)
    pred = Predictor(params, config, postprocess=postprocess_kwargs(c),
                     devices=devices, tp=tp, sp=sp)
    # the siblings encode each chunk's support stack with it
    keys = ('im_data', 'im_info') if pred.caches_supports \
        else ('im_data', 'im_info', 'support_ims')

    # several support crops may share an image; each query image is read
    # once, so the queries bypass the cache
    cache = ImageCache(c.TPU.IMAGE_CACHE_MB) if c.TPU.IMAGE_CACHE_MB > 0 \
        else None
    pool = _support_pool(args, c, imdb_, roidb, cache)
    # a packed query's H/2+3 rows split over no spatial blocks
    pack_s2d = bool(c.TPU.STEM_S2D) and config.arch != 'vgg16' \
        and max(1, args.sp) == 1
    loader = InferenceLoader(
        roidb, pool, pixel_means=c.PIXEL_MEANS,
        max_num_box=c.MAX_NUM_GT_BOXES, buckets=c.TPU.SIZE_BUCKETS,
        scale=c.TEST.SCALES[0],
        max_size=None if c.TPU.EXACT_QUERY_SCALE else c.TEST.MAX_SIZE,
        ship_uint8=c.TPU.SHIP_UINT8, with_supports='support_ims' in keys,
        pack_s2d=pack_s2d)

    eval_bs = max(1, args.batch_size)
    if len(devices) > 1:
        n_data = len(pred.rows)
        eval_bs = max(eval_bs, n_data)
        eval_bs += (-eval_bs) % n_data        # divisible by the data axis
        print(f'parallel eval: data={n_data} x model={tp} x spatial={sp} '
              f'(bs {eval_bs})', flush=True)
    groups = {}
    for i in range(num_images):
        groups.setdefault(loader.bucket_of(i), []).append(i)
    chunks = [idxs[s:s + eval_bs] for _, idxs in sorted(groups.items())
              for s in range(0, len(idxs), eval_bs)]
    if nproc > 1:
        # the chunk list is the same on every rank: a strided split is
        # disjoint and covering
        chunks = chunks[rank::nproc]
        print(f'rank {rank}: {len(chunks)} of the chunks', flush=True)
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
                 for k in keys}
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
    # 608x1024, float32, and ~29.5 MB more with 3-shot supports): a capped
    # lookahead
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
                if pred.caches_supports:
                    for cls in set(classes):
                        if not pred.has_supports(cls):
                            sup = pool.get(cls)
                            pred.encode_supports(
                                cls, s2d_pack(sup) if pack_s2d else sup)
                dets, valid = pred.predict(
                    batch['im_data'], batch['im_info'], classes,
                    support_ims=batch.get('support_ims'))
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
    if nproc > 1:
        # the ranks' partials on the shared eval dir; the chief merges them
        # after a barrier sized to the whole pass (its skew is unbounded)
        with open(os.path.join(out_dir, f'detections_rank{rank}.pkl'),
                  'wb') as f:
            pickle.dump(all_boxes, f)
        distributed.barrier('eval_partials',
                            timeout_ms=max(3_600_000, 60_000 * len(chunks)))
        if rank != 0:
            return None
        for r in range(1, nproc):
            with open(os.path.join(out_dir, f'detections_rank{r}.pkl'),
                      'rb') as f:
                other = pickle.load(f)
            for cls in range(len(all_boxes)):
                for i in range(num_images):
                    if len(other[cls][i]):
                        all_boxes[cls][i] = other[cls][i]
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
