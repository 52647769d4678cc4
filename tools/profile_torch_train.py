#!/usr/bin/env python3
"""Where a training step's time goes in the PyTorch port, on one CUDA card.

    python3 tools/profile_torch_train.py [--seed 0] [--iters 5]
        [--trace .scratch/profile_torch_train.trace.json]

Builds the trainer that chip_smoke.py drives (DAnA ResNet-50 2-way
3-shot, random weights from --seed) and runs `Trainer.step` on one
seeded episode batch of 4 uint8 608x1024 queries with 6 supports of
320 px each: --iters steps untraced for the wall time per step, then
--iters under torch.profiler.  The stages are the `dana.*`
record_function ranges of `models/dana.py` `forward` and of
`engine/train.py` (`dana.backward`, `dana.update`); kernels are charged
to the ranges open when they were launched, as in
tools/profile_torch_predict.py (the backward's kernels, launched by
autograd's own thread while `dana.backward` is open, go to that range).
The last line is one JSON object with the per-step numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, 'tools'))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--iters', type=int, default=5)
    ap.add_argument('--trace', default=os.path.join(
        REPO, '.scratch', 'profile_torch_train.trace.json'))
    args = ap.parse_args()
    from profile_torch_predict import card_name, profile
    card = card_name()

    import chip_smoke
    from dana_tpu_torch.engine.train import Trainer
    from dana_tpu_torch.ops import build
    from dana_tpu_torch.utils import config as cfg
    build.build_all()
    config, params = cfg.get_model('res50', way=2, shot=3, seed=args.seed)
    trainer = Trainer(params, config, seed=args.seed)
    batch = chip_smoke.training_episodes(args.seed, 1, trainer.device)[0]

    def step():
        trainer.step(batch)
        torch.cuda.synchronize()

    print(json.dumps(profile(step, args.iters, args.trace, card,
                             unit='step')))


if __name__ == '__main__':
    main()
