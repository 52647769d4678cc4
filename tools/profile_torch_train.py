#!/usr/bin/env python3
"""Where a training step's time goes in the PyTorch port, on one CUDA card.

    python3 tools/profile_torch_train.py [--seed 0] [--iters 5]
        [--source episodes|cli|cli_fixed]
        [--net DAnA|cisa|frcnn|fsod|meta|fgn] [--backbone res50|res101|vgg16]
        [--set POOLING_MODE pool|crop TPU.COMPUTE_DTYPE bfloat16 ...]
        [--trace .scratch/profile_torch_train.trace.json]

--source episodes (the default) builds the trainer that chip_smoke.py
phase 5 drives (DAnA ResNet-50 2-way 3-shot, 9 anchors, random weights
from --seed; --net, --backbone and --set as in
tools/profile_torch_predict.py) and runs `Trainer.step` on one seeded
episode batch of 4
uint8 608x1024 queries with 6 supports of 320 px each.  --source cli
builds the trainer, loader and batcher as `python -m dana_tpu_torch.train
--dataset synth --way 2 --shot 3 --bs 4` does (12 anchors, float32
queries; synth_train written into a temporary DANA_SYNTH_ROOT; --net,
--backbone and --set passed on to it) and steps
on the batches of its prefetch stream while the eight assembly threads
run, as in the CLI; --source cli_fixed steps that trainer on the stream's
first batch again and again, with no thread running beside it.  Each
takes --iters steps untraced for the wall time per step, then --iters
under torch.profiler.  The stages are the `dana.*`
record_function ranges of `models/dana.py` `forward` and of
`engine/train.py` (`dana.backward`, `dana.update`); the step's unit
`dana.entry.step`, its upload `dana.entry.upload` and the host syncs
`dana.sync.<site>` (utils/trace.py) are rows of their own, in no sum of
stages, as in tools/profile_torch_predict.py; kernels are charged
to the ranges open when they were launched, as in
tools/profile_torch_predict.py (the backward's kernels, launched by
autograd's own thread while `dana.backward` is open, go to that range).
`--set TPU.COMPUTE_DTYPE bfloat16 [TPU.HEAD_DTYPE bfloat16 | ...]` breaks
down a step of the precision recipe (K1-bf16 and K2-bf16 in place of the
float32 K1 and K3).
The last line is one JSON object with the per-step numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, 'tools'))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--iters', type=int, default=5)
    ap.add_argument('--source', default='episodes',
                    choices=('episodes', 'cli', 'cli_fixed'))
    from profile_torch_predict import add_model_args, card_name, profile
    add_model_args(ap)
    ap.add_argument('--trace', default=os.path.join(
        REPO, '.scratch', 'profile_torch_train.trace.json'))
    args = ap.parse_args()
    card = card_name()

    from dana_tpu_torch.ops import build
    build.build_all()
    with tempfile.TemporaryDirectory() as tmp:
        os.environ['DANA_SYNTH_ROOT'] = os.path.join(tmp, 'synth')
        trainer, batch, stream = _source(args)

        def step():
            trainer.step(batch if stream is None else next(stream))
            torch.cuda.synchronize()

        try:
            out = profile(step, args.iters, args.trace, card, unit='step')
        finally:
            if stream is not None:
                stream.close()
    config = trainer.config
    out.update(source=args.source, framework=config.framework,
               arch=config.arch, pooling_mode=config.pooling_mode,
               dtypes={k: str(getattr(config, k)).replace('torch.', '')
                       for k in ('compute_dtype', 'attention_dt',
                                 'head_dt')})
    print(json.dumps(out))


def _source(args):
    """-> (trainer, batch or None, batch stream or None) for --source."""
    if args.source == 'episodes':
        import chip_smoke
        from dana_tpu_torch.engine.train import Trainer
        from profile_torch_predict import model_for
        config, params = model_for(args.net, args.backbone, args.set,
                                   args.seed, serving=False)
        trainer = Trainer(params, config, seed=args.seed)
        batch = chip_smoke.training_episodes(args.seed, 1, trainer.device)[0]
        if config.framework == 'meta':          # as chip_smoke.py phase 8
            batch['all_gt_boxes'] = chip_smoke.all_class_gt(
                batch['gt_boxes'], args.seed)
        return trainer, batch, None
    from dana_tpu_torch import train as cli
    from dana_tpu_torch.data.fs_loader import Prefetcher
    _, batcher, trainer, _ = cli.setup(cli.parse_args(
        ['--dataset', 'synth', '--way', '2', '--shot', '3', '--bs', '4',
         '--dlog', '--seed', str(args.seed), '--net', args.net,
         '--backbone', args.backbone]
        + (['--set', *args.set] if args.set else [])))
    keys = cli.BATCH_KEYS + (('all_gt_boxes',)
                             if trainer.config.framework == 'meta' else ())
    stream = iter(Prefetcher(({k: b[k] for k in keys} for b in batcher),
                             trainer.device))
    if args.source == 'cli':
        return trainer, None, stream
    batch = next(stream)
    stream.close()
    return trainer, batch, None


if __name__ == '__main__':
    main()
