"""Episodic training of a few-shot detector on the PyTorch port.

    python -m dana_tpu_torch.train --dataset synth --way 2 --shot 3 \\
        --bs 4 [--net DAnA|cisa|frcnn|fsod|meta|fgn|res101|vgg16] \\
        [--backbone res50|res101|vgg16] [--ls] [--epochs 12] \\
        [--flip] [--fs --sup_dir DIR] [--r --checkpath model.dkpt] \\
        [--device cpu] [--set KEY VALUE ...]

The loop of the repo's root `train.py` (the JAX package's CLI), with the
same flags: the roidb of the training split (doubled with flipped entries
by --flip); `FewShotLoader` episodes, or with --fs `FinetuneLoader`'s from
the support directory, where only the detection heads train; batches of
--bs from `EpisodicBatcher` on min(--nw, cores) threads, prefetched to the
card; SGD with the config tree's momentum, weight decay and bias rules
(cfgs/res50.yml values); the lr times --lr_decay_gamma at every epoch
divisible by --lr_decay_step + 1; loss lines every --disp_interval steps;
a checkpoint `model_<epoch>_<steps - 1>.dkpt` after every epoch, in the
JAX package's format, with the detector's name in its 'extra'; --r
resume from --checkpath or --load_dir / --checkepoch / --checkpoint
(also found as `_preempt` or `.pth`),
restoring the lr, the epoch, the momentum buffers and the target layers'
generator.  --steps_per_call N runs its N steps one at a time: the same
updates, draws and logging (the JAX package stages them only to save TPU
dispatch).  --profile PATH writes a torch.profiler chrome trace of steps
3-8.

A first SIGTERM or SIGINT checkpoints at the next step boundary, under a
`_preempt` name that records the previous epoch, and exits; a second one
raises KeyboardInterrupt.

Unlike the JAX CLI, a resumed run draws what a straight run would: the
batcher starts at the resumed epoch's shuffle and the generator continues
from its saved state (the JAX CLI replays epoch 1's shuffle and restarts
its step keys).

Every --net the port has trains: DAnA, cisa, and the siblings Faster
R-CNN, FSOD, Meta R-CNN (whose batches carry every class's gt,
`all_gt_boxes`, for its RPN targets) and FGN, on the trunk --backbone
names (DAnA and cisa also on vgg16, whose trunk trains whole; with
--backbone vgg16 the gradient norm is clipped at 10 unless --clip_norm
says otherwise, as in the JAX CLI), with the config tree's POOLING_MODE,
which every checkpoint records and --r takes back; --ls trains at
cfgs/res101_ls.yml's values (800 px queries).  `--set TPU.COMPUTE_DTYPE
bfloat16 [TPU.ATTENTION_DTYPE ..] [TPU.HEAD_DTYPE ..]` trains in the
precision recipe (default: bf16 trunk and attention, float32 heads): the
parameters and the momentum stay float32, and so does every checkpoint,
which records no dtype, as the JAX CLI's records none: a resumed run
trains in the precision its own --set names.

Several cards (dana_tpu_torch/parallel): --mGPUs, or --slices S, spawns
one process per visible card (on one card it runs as one process, as the
JAX CLI does on one device); --dist --coordinator HOST:PORT --num_procs N
--proc_id R (or torchrun's environment) joins a group of N processes,
each on `cuda:(local rank % cards)`, and needs --mGPUs or --slices (the
JAX CLI's ValueError).  --bs stays the global batch: each process
assembles its row block of every batch and the step is the global batch's
(engine/train.py); --slices S arranges the W processes as S slices of
W/S (W % S == 0), rows in rank order.  Only the chief (rank 0) logs and
writes checkpoints, every rank resumes from the same one, and a
preemption is voted every --disp_interval steps and at each epoch's end,
so that every rank stops at the same step.

--set TPU.STEM_S2D True trains the ResNet trunks on the space-to-depth
stem, as the JAX CLI's default does: the loader's assembly threads pack
each episode's query and supports into 12 channels (data/fs_loader.py),
and conv1, frozen, runs as a 4x4/1 conv on them (models/resnet.py);
VGG16 keeps the direct stem.

It runs on the card; without CUDA it raises unless --device cpu is given.
Orbax checkpoints are refused (utils/args.py); under TPU.QUANT_INT8 it trains the float tree, as the
JAX CLI does (int8 is serving only).  `main` returns a summary: the last
checkpoint, whether the run was preempted, and per epoch its steps,
seconds, episodes per second, the seconds the loop waited for a batch,
mean losses, the loss of every step and the skipped steps.
"""

from __future__ import annotations

import os
import pickle
import signal
import sys
import tempfile
import time

import numpy as np
import torch

from dana_tpu_torch.data.fs_loader import (EpisodicBatcher, FewShotLoader,
                                           FinetuneLoader, Prefetcher)
from dana_tpu_torch.data.imdb import combined_roidb
from dana_tpu_torch.engine.train import Trainer
from dana_tpu_torch.models import frameworks
from dana_tpu_torch.parallel import (distributed, local_devices, make_mesh,
                                     make_mesh_dcn)
from dana_tpu_torch.utils import checkpoint as ckpt_lib
from dana_tpu_torch.utils.args import load_cfg, parse_args
from dana_tpu_torch.utils.config import dana_config
from dana_tpu_torch.utils.device import resolve_device

# what the trainer reads of a batch (Meta R-CNN also every class's gt)
BATCH_KEYS = ('im_data', 'im_info', 'gt_boxes', 'support_ims')
PROFILE_STEPS = (3, 8)


class PreemptionGuard:
    """The first SIGTERM or SIGINT sets `requested` (the loop checkpoints
    and exits at the next step boundary); a second restores the previous
    handler and raises KeyboardInterrupt.  `uninstall` restores the
    handlers."""

    def __init__(self):
        self.requested = False
        self._prev = {}

    def install(self):
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev[sig] = signal.signal(sig, self._handle)
            except ValueError:          # not the main thread
                pass
        return self

    def uninstall(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev if prev is not None else signal.SIG_DFL)
        self._prev = {}

    def _handle(self, signum, frame):
        if self.requested:
            prev = self._prev.get(signum)
            signal.signal(signum, prev if prev is not None else signal.SIG_DFL)
            raise KeyboardInterrupt
        self.requested = True
        print(f'signal {signum}: checkpointing at next step boundary',
              flush=True)


def make_loader(args, c, imdb_, roidb, arch):
    """The episodic loader the flags ask for, at the tree's scales, packing
    for the space-to-depth stem under TPU.STEM_S2D unless the trunk `arch`
    is VGG16."""
    kw = dict(num_way=args.way, num_shot=args.shot,
              max_num_box=c.MAX_NUM_GT_BOXES, seed=args.seed,
              pixel_means=c.PIXEL_MEANS, buckets=c.TPU.SIZE_BUCKETS,
              scale=c.TRAIN.SCALES[0],
              max_size=None if c.TPU.EXACT_QUERY_SCALE else c.TRAIN.MAX_SIZE,
              support_cache=c.TPU.SUPPORT_CACHE,
              exact_support=c.TPU.EXACT_SUPPORT_SCALE,
              pack_s2d=bool(c.TPU.STEM_S2D) and arch != 'vgg16')
    if args.fewshot:
        sup_dir = os.path.join(c.DATA_DIR, 'supports') \
            if args.sup_dir == 'all' else args.sup_dir
        return FinetuneLoader(roidb, imdb_.num_classes, imdb_.classes,
                              sup_dir, **kw)
    return FewShotLoader(roidb, imdb_.num_classes, **kw)


def make_trainer(args, c, config, params, lr, device, group=None):
    """The Trainer with the tree's SGD settings and trainable selection
    (root train.py:151-164)."""
    return Trainer(params, config, device=device, lr=lr, seed=args.seed,
                   group=group,
                   clip_norm=args.clip_norm
                   or (10.0 if args.backbone == 'vgg16' else 0.0),
                   fixed_blocks=c.RESNET.FIXED_BLOCKS,
                   finetune=args.fewshot, momentum=c.TRAIN.MOMENTUM,
                   weight_decay=c.TRAIN.WEIGHT_DECAY,
                   double_bias=c.TRAIN.DOUBLE_BIAS,
                   bias_decay=c.TRAIN.BIAS_DECAY)


def resume_path(args):
    """The checkpoint --r names: --checkpath, or the one under --load_dir,
    also found with a `_preempt` or `.pth` name."""
    path = args.checkpath or ckpt_lib.checkpoint_path(
        args.load_dir, args.checkepoch, args.checkpoint)
    if not os.path.exists(path):
        base, ext = os.path.splitext(path)
        for cand in (f'{base}_preempt{ext}', base + '.pth',
                     base + '_preempt.pth'):
            if os.path.exists(cand):
                return cand
    return path


def restore(args, c, config):
    """--r: the checkpoint `resume_path` names -> (the module on the CPU,
    the config with the checkpoint's pooling mode, which also goes into
    the tree `c`, lr, first epoch to train, momentum velocity tree or None,
    generator state or None)."""
    path = resume_path(args)
    model, payload = ckpt_lib.load_checkpoint(path, config)
    config = ckpt_lib.take_pooling_mode(payload, c, config)
    print(f'resumed from {path} (epoch {payload.get("epoch")}, pooling '
          f'{config.pooling_mode})')
    return (model, config, payload.get('lr') or args.lr,
            int(payload.get('epoch', 0)) + 1,
            ckpt_lib.optimizer_velocity(payload),
            (payload.get('extra') or {}).get('generator'))


def decayed_lr(lr, epoch, args):
    """The lr for `epoch`: times --lr_decay_gamma at every epoch divisible
    by --lr_decay_step + 1 (reference train.py:118-120: with step 10 it
    decays at epochs 11, 22, ...)."""
    if epoch % (args.lr_decay_step + 1) == 0:
        return lr * args.lr_decay_gamma
    return lr


def _profiler(device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == 'cuda':
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


def setup(args, group=distributed.SINGLE):
    """-> (config tree, batcher, trainer, first epoch to train) for the
    parsed flags: the roidb, the loader and its batcher (this rank's rows
    of `group`'s global batches), the detector from the seed or from the
    checkpoint --r names, its Trainer with the restored momentum and
    generator, the batcher at the epoch before."""
    c = load_cfg(args)
    config = dana_config(c, args.way, args.shot, args.net, args.backbone)
    device = distributed.rank_device(args.device) if group.distributed \
        else resolve_device(args.device)
    np.random.seed(args.seed)

    imdb_, roidb, _, _ = combined_roidb(args.imdb_name,
                                        use_flipped=args.use_flip,
                                        data_dir=c.DATA_DIR)
    print(f'{len(roidb)} roidb entries')
    loader = make_loader(args, c, imdb_, roidb, config.arch)
    batcher = EpisodicBatcher(
        loader, args.batch_size, shuffle=True, seed=args.seed,
        process_id=group.rank, process_count=group.size,
        num_workers=min(args.num_workers, os.cpu_count() or 1))

    if args.resume:
        params, config, lr, start_epoch, velocity, generator = restore(
            args, c, config)
    else:
        params = frameworks.init_params(config, seed=args.seed)
        lr, start_epoch = args.lr, args.start_epoch
    trainer = make_trainer(args, c, config, params, lr, device, group)
    if args.resume:
        trainer.load_state(velocity, generator)
        print('restored the momentum buffers' if velocity is not None
              else 'no momentum in the checkpoint: it starts at zero')
    # the batcher draws epoch e's shuffle whatever epoch the run starts at
    batcher.epoch = start_epoch - 1
    return c, batcher, trainer, start_epoch


def _spawned(rank, argv, world, init, out):
    """A process of an --mGPUs / --slices run on one host."""
    args = parse_args(argv)
    group = distributed.init_distributed(init, world, rank,
                                         device=args.device)
    try:
        summary = run(args, group)
    finally:
        distributed.shutdown()
    if rank == 0:
        with open(out, 'wb') as f:
            pickle.dump(summary, f)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if args.dist:
        group = distributed.init_distributed(
            args.coordinator, args.num_procs, args.proc_id,
            device=args.device)
        print(f'distributed: process {group.rank}/{group.size} on '
              f'{distributed.rank_device(args.device)}', flush=True)
        try:
            return run(args, group)
        finally:
            distributed.shutdown()
    n = len(local_devices(args.device)) if args.mGPUs or args.slices > 1 \
        else 1
    if n == 1:
        return run(args, distributed.SINGLE)
    # one process per card, rendezvous through a file; rank 0's summary
    # comes back through a pickle
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, 'summary.pkl')
        torch.multiprocessing.spawn(
            _spawned, args=(argv, n, f'file://{tmp}/rdzv', out), nprocs=n)
        with open(out, 'rb') as f:
            return pickle.load(f)


def run(args, group=distributed.SINGLE):
    """The training loop of the parsed flags on this rank of `group`."""
    c, batcher, trainer, start_epoch = setup(args, group)
    world, chief = group.size, group.rank == 0
    slices = max(0, args.slices)
    if slices > 1 and world > 1:
        grid = make_mesh_dcn(slices, [trainer.device] * world)
        print(f'multi-slice data-parallel: {slices} slices x '
              f'{grid.shape["data"]} devices', flush=True)
    elif args.mGPUs and world > 1:
        grid = make_mesh([trainer.device] * world)
        print(f'data-parallel over {grid.shape["data"]} devices', flush=True)
    elif world > 1:
        raise ValueError('--dist requires --mGPUs or --slices N: a '
                         'multi-process batch must shard over a device '
                         'mesh spanning all processes')

    logger = None
    if not args.dlog and chief:
        from dana_tpu_torch.utils.fsod_logger import FSODLogger
        logger = FSODLogger(os.path.join(args.save_dir, 'tb'),
                            pixel_means=c.PIXEL_MEANS)

    keys = BATCH_KEYS + (('all_gt_boxes',)
                         if trainer.config.framework == 'meta' else ())
    guard = PreemptionGuard().install()
    summary = dict(checkpoint=None, preempted=False, epochs=[])
    global_step, prof = 0, None
    # several processes vote on a stop (a collective) every disp_interval
    # steps, all at the same step; one process reads its own flag
    vote_every = max(1, args.disp_interval) if world > 1 else 1

    def stop_requested():
        return distributed.agree_stop(guard.requested) if world > 1 \
            else guard.requested
    try:
        for epoch in range(start_epoch, args.max_epochs + 1):
            new_lr = decayed_lr(trainer.lr, epoch, args)
            if new_lr != trainer.lr:
                trainer.lr = new_lr
                print(f'lr decayed to {new_lr}')
            t0 = time.perf_counter()
            last_raw = {}

            def batches():
                for b in batcher:
                    if args.imlog:
                        last_raw.clear()
                        last_raw.update(b)
                    yield {k: b[k] for k in keys}
            feed = Prefetcher(batches(), trainer.device)
            stream = iter(feed)
            steps, loss_acc, curve, skipped, step_s = 0, {}, [], 0, []
            preempted = False
            t_step = time.perf_counter()
            try:
                for batch in stream:
                    if args.profile and global_step == PROFILE_STEPS[0]:
                        prof = _profiler(trainer.device)
                    m = trainer.step(batch)
                    # one read-back for all the metrics
                    m = dict(zip(m, torch.stack(
                        [v.float() for v in m.values()]).tolist()))
                    now = time.perf_counter()
                    step_s.append(now - t_step)
                    t_step = now
                    steps += 1
                    global_step += 1
                    if prof is not None and global_step >= PROFILE_STEPS[1]:
                        prof.__exit__(None, None, None)
                        prof.export_chrome_trace(args.profile)
                        print(f'profiler trace written to {args.profile}')
                        prof = None
                    for k, v in m.items():
                        loss_acc[k] = loss_acc.get(k, 0.0) + v
                    curve.append(m['loss'])
                    skipped += int(m['skipped'])
                    if steps % args.disp_interval == 0 and chief:
                        dt = time.perf_counter() - t0
                        msg = ', '.join(f'{k}: {loss_acc[k] / steps:.4f}'
                                        for k in sorted(loss_acc)
                                        if 'loss' in k)
                        print(f'[epoch {epoch:2d}][iter {steps:4d}] '
                              f'lr: {trainer.lr:.2e}, time/iter: '
                              f'{dt / steps:.3f}s, {msg}', flush=True)
                    if steps % vote_every == 0 and stop_requested():
                        preempted = True
                        break
            finally:
                stream.close()
            stop_after_epoch = not preempted and stop_requested()
            if prof is not None:
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(args.profile)
                print(f'profiler trace written to {args.profile} (partial)')
                prof = None
            if steps == 0:
                if preempted or guard.requested:
                    print('preempted before the first step; nothing new to '
                          'checkpoint')
                    summary['preempted'] = True
                    return summary
                print('no batches; check dataset')
                break
            secs = time.perf_counter() - t0
            means = {k: v / steps for k, v in loss_acc.items()}
            if logger is not None:
                logger.write(epoch, means, batch=last_raw or None,
                             save_im=args.imlog)
            # a mid-epoch preemption records the previous epoch as the last
            # complete one, so that --r trains the interrupted one again
            ckpt_epoch = epoch - 1 if preempted else epoch
            path = ckpt_lib.checkpoint_path(args.save_dir, ckpt_epoch,
                                            steps - 1)
            if preempted:
                base, ext = os.path.splitext(path)
                path = f'{base}_preempt{ext}'
            eps = steps * args.batch_size / secs
            if chief:
                state = trainer.state()
                ckpt_lib.save_checkpoint(
                    path, trainer.model, state['velocity'], epoch=ckpt_epoch,
                    step=steps - 1, lr=trainer.lr,
                    pooling_mode=c.POOLING_MODE,
                    extra={'generator': state['generator'],
                           'framework': trainer.config.framework})
                print(f'[epoch {epoch:2d}] saved {path} ({secs:.1f}s, '
                      f'{steps} iters, {eps:.2f} episodes/s, waited '
                      f'{feed.wait_s:.2f}s for batches)', flush=True)
            summary['checkpoint'] = path
            summary['epochs'].append(dict(
                epoch=epoch, steps=steps, seconds=secs, eps_per_s=eps,
                wait_s=feed.wait_s, step_s=step_s, losses=means,
                loss_curve=curve, skipped=skipped, lr=trainer.lr))
            if preempted or stop_after_epoch:
                print('preemption checkpoint written; exiting')
                summary['preempted'] = True
                return summary
    finally:
        guard.uninstall()
        if prof is not None:
            prof.__exit__(None, None, None)
        if logger is not None:
            logger.close()
    return summary


if __name__ == '__main__':
    main(sys.argv[1:])
