#!/usr/bin/env python3
"""Train the DAnA detector twice from one seed on the card, once through the
kernels and once through their plain versions, and compare.

    python3 tools/train_paths_compare.py [--epochs 8] [--seed 0] \\
        [--out chiprun_out/train_paths.json]

Both runs are `dana_tpu_torch.train.main` on synth_train_big (240 images of
480x640, written with synth_test_big into a temporary DANA_SYNTH_ROOT by
the port's generator) at the CLI's full default config (cfgs/res50.yml
values, --ascale 4), --way 2 --shot 3 --bs 4 --nw 8.  The plain run routes
the detector through the plain versions as chip_smoke.py's `plain_ops`
does; nothing in the package switches.  Each final checkpoint is then
evaluated by `dana_tpu_torch.inference.main` on synth_test_big (on the
kernel path), and the random weights of the seed too.

Printed, and written to --out as one JSON object:
  * per run: per-epoch mean losses, steps, seconds, episodes/s, launches
    (the plain run must launch no kernel), and the 12 COCOeval stats of its
    checkpoint;
  * the relative difference of the two runs' per-epoch mean losses;
  * how often rois span the whole image (both sides at least 90% of the
    scaled image's; also at least 50%): per epoch of the kernel run, over
    the rois the training RoIAlign (K3) pools, and over the proposals
    (K2's rois) served for each evaluated set of weights.

Card only: without CUDA it exits 1.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SPANS = (0.9, 0.5)


class SpanCount:
    """Rois whose both sides cover at least each share of SPANS of the
    scaled image, and all rois counted, summed on the device."""

    def __init__(self):
        self.n = None

    def add(self, rois, im_info, valid=None):
        """rois [B,R,5] (batch, x1, y1, x2, y2) in query pixels; im_info
        [B,3] (h, w, scale); valid [B,R] or None."""
        w = rois[..., 3] - rois[..., 1] + 1
        h = rois[..., 4] - rois[..., 2] + 1
        hw = im_info[:, None, :2]
        keep = torch.ones_like(w, dtype=torch.bool) if valid is None \
            else valid.bool()
        n = torch.stack([((w >= s * hw[..., 1]) & (h >= s * hw[..., 0])
                          & keep).sum() for s in SPANS] + [keep.sum()])
        self.n = n if self.n is None else self.n + n

    def shares(self):
        if self.n is None:
            return None
        *hits, total = self.n.tolist()
        return {f'>= {s:g}': h / max(total, 1) for s, h in zip(SPANS, hits)} \
            | {'rois': total}


@contextlib.contextmanager
def count_spans(train_counts=None, serve_count=None):
    """Count the rois the training RoIAlign pools into the last SpanCount
    of `train_counts`, and the valid proposals of eval forwards into
    `serve_count`."""
    from dana_tpu_torch.models import dana, rpn
    real_layer, real_train = rpn.proposal_layer, dana.roi_align_train
    last = {}

    def layer(probs_fg, deltas, anchors, im_info, *args, **kwargs):
        out = real_layer(probs_fg, deltas, anchors, im_info, *args, **kwargs)
        last['im_info'] = im_info
        if serve_count is not None and not torch.is_grad_enabled():
            serve_count.add(out[0], im_info, out[2])
        return out

    def train(feat, rois, *args, **kwargs):
        if train_counts is not None:
            train_counts[-1].add(rois, last['im_info'])
        return real_train(feat, rois, *args, **kwargs)

    rpn.proposal_layer, dana.roi_align_train = layer, train
    try:
        yield
    finally:
        rpn.proposal_layer, dana.roi_align_train = real_layer, real_train


def launches():
    from dana_tpu_torch.ops import cisa_attention, roi_align
    return {'cisa_shots': cisa_attention.cisa_attention_shots.launches,
            'roi_align_fwd': roi_align.roi_align.launches,
            'roi_align_pw': roi_align.roi_align_pw.launches}


def zero_launches():
    from dana_tpu_torch.ops import cisa_attention, roi_align
    cisa_attention.cisa_attention_shots.launches = 0
    roi_align.roi_align.launches = 0
    roi_align.roi_align_pw.launches = 0


def train_run(path, args, save_dir):
    """One training run -> its summary row."""
    from chip_smoke import plain_ops
    from dana_tpu_torch import train
    from dana_tpu_torch.data.fs_loader import EpisodicBatcher
    counts = []
    real_iter = EpisodicBatcher.__iter__

    def epoch_iter(self):
        # called as each epoch starts, before its first step
        counts.append(SpanCount())
        return real_iter(self)

    argv = ['--dataset', 'synth_train_big', '--way', '2', '--shot', '3',
            '--bs', '4', '--epochs', str(args.epochs), '--nw', '8', '--dlog',
            '--disp_interval', '20', '--seed', str(args.seed),
            '--save_dir', save_dir]
    zero_launches()
    EpisodicBatcher.__iter__ = epoch_iter
    t0 = time.perf_counter()
    try:
        with plain_ops() if path == 'plain' else contextlib.nullcontext(), \
                count_spans(train_counts=counts):
            out = train.main(argv)
    finally:
        EpisodicBatcher.__iter__ = real_iter
    torch.cuda.synchronize()
    row = dict(path=path, seconds=time.perf_counter() - t0,
               launches=launches(), checkpoint=out['checkpoint'],
               train_roi_spans=[c.shares() for c in counts],
               epochs=[dict(epoch=e['epoch'], steps=e['steps'],
                            seconds=e['seconds'], eps_per_s=e['eps_per_s'],
                            wait_s=e['wait_s'], skipped=e['skipped'],
                            losses=e['losses']) for e in out['epochs']])
    print(f'{path} run: {json.dumps(row)}', flush=True)
    return row


def evaluate(ckpt, args, out_dir):
    """COCOeval stats of `ckpt` (None: the seed's random weights) on
    synth_test_big, and the span shares of its served proposals."""
    from dana_tpu_torch import inference
    argv = ['--dataset', 'synth_test_big', '--way', '2', '--shot', '3',
            '--bs', '8', '--seed', str(args.seed), '--eval_dir', out_dir]
    if ckpt:
        argv += ['--checkpath', ckpt]
    count = SpanCount()
    with count_spans(serve_count=count):
        result = inference.main(argv)
    return dict(checkpoint=ckpt, stats=[float(x) for x in result['stats']],
                img_per_s=result['timing']['img_per_s'],
                proposal_spans=count.shares())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--epochs', type=int, default=8)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--out', default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('train_paths_compare: no CUDA device', file=sys.stderr)
        sys.exit(1)
    import subprocess
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    from dana_tpu_torch.data.synth import synth_fsod
    from dana_tpu_torch.ops import build
    build.build_all()
    result = {'device': torch.cuda.get_device_name(0),
              'nvidia_smi': smi.stdout.strip(), 'epochs': args.epochs,
              'seed': args.seed}
    with tempfile.TemporaryDirectory() as tmp:
        os.environ['DANA_SYNTH_ROOT'] = os.path.join(tmp, 'synth')
        synth_fsod('train_big', num_images=240)
        synth_fsod('test_big', num_images=60)
        runs = {p: train_run(p, args, os.path.join(tmp, p))
                for p in ('kernel', 'plain')}
        if runs['plain']['launches'] != {'cisa_shots': 0, 'roi_align_fwd': 0,
                                         'roi_align_pw': 0} or \
                not runs['kernel']['launches']['roi_align_pw']:
            print(f'launches: {runs["kernel"]["launches"]} kernel run, '
                  f'{runs["plain"]["launches"]} plain run', file=sys.stderr)
            sys.exit(1)
        evals = {name: evaluate(ckpt, args, os.path.join(tmp, f'eval_{name}'))
                 for name, ckpt in (('init', None),
                                    ('kernel', runs['kernel']['checkpoint']),
                                    ('plain', runs['plain']['checkpoint']))}
    diffs = []
    for ek, ep in zip(runs['kernel']['epochs'], runs['plain']['epochs']):
        diffs.append({k: abs(ek['losses'][k] - ep['losses'][k])
                      / max(abs(ep['losses'][k]), 1e-12)
                      for k in ek['losses'] if 'loss' in k})
    result.update(runs=runs, evals=evals, loss_rel_diff_per_epoch=diffs)
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
        with open(args.out, 'w') as f:
            f.write(line + '\n')
    print(line, flush=True)


if __name__ == '__main__':
    main()
