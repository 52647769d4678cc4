#!/usr/bin/env python3
"""One rank of a data-parallel training step of the PyTorch port.

    python tools/torch_dist_step.py --inputs IN.pkl --out OUT.pkl \\
        --rank R --world W --init file:///tmp/rdzv [--device cpu] \\
        [--time_steps K]

IN.pkl holds a dict: `params` (a param tree in the JAX layout, numpy
leaves), `batch` (the GLOBAL batch, numpy arrays with B rows), optionally
`draws` (the global batch's target-layer draws, keyed by rpn.DRAW_KEYS),
`lr`, and `runs`: a list of dicts, each a `label`, a `config` (a
DanaConfig) and `trainer` (more Trainer keywords).  The rank joins a group
of W processes through --init (dana_tpu_torch/parallel
`init_distributed`) and takes its row block of the batch (`local_rows`);
for each run it builds a Trainer from the params on its device
(`rank_device`) with the group and takes one step; with --time_steps K it
then takes K more steps on the same batch and times them (synchronised
host clock).  OUT.pkl gets {'device', 'backend', 'runs': {label: dict}},
each run's dict: the step's global `metrics`, `naive_rpn_loss_cls` (this
rank's own mean, what a per-rank loss would have given), the kernels'
`launches` in the first step (total and by device), `param_abs_sum` of
every parameter, the trainable parameters after the first step
(`params`, by module name), `step_ms` of the timed steps and the peak
memory in GiB.

The CPU test tests/test_torch_port_distributed.py runs two of these with
gloo; chip_smoke.py phase 13 runs two on the card.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from dana_tpu_torch.engine.train import Trainer  # noqa: E402
from dana_tpu_torch.models import dana  # noqa: E402
from dana_tpu_torch.ops import cisa_attention, nms, roi_align  # noqa: E402
from dana_tpu_torch.parallel import distributed  # noqa: E402

WRAPPERS = {'cisa_shots': cisa_attention.cisa_attention_shots,
            'roi_align_fwd': roi_align.roi_align,
            'roi_align_pw': roi_align.roi_align_pw,
            'nms': nms.nms_sorted}


def _launches():
    out = {}
    for name, fn in WRAPPERS.items():
        out[name] = fn.launches
        out[name + '_bf16'] = getattr(fn, 'launches_bf16', 0)
        out[name + '_by_device'] = {f'{d}/{t}': n for (d, t), n in
                                    fn.launches_by_device.items()}
    return out


def _zero_launches():
    for fn in WRAPPERS.values():
        fn.launches = 0
        if hasattr(fn, 'launches_bf16'):
            fn.launches_bf16 = 0
        fn.launches_by_device.clear()


def _sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def one_run(inp, run, group, dev, batch, time_steps):
    """One run of IN.pkl's `runs` on this rank: -> its OUT.pkl entry."""
    trainer = Trainer(inp['params'], run['config'], device=dev,
                      lr=inp.get('lr', 1e-3), group=group,
                      **run.get('trainer', {}))
    if dev.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(dev)
    naive = []
    real = dana.masked_cross_entropy

    def recording(logits, labels, mask):
        with distributed.SINGLE:
            naive.append(real(logits, labels, mask).item())
        return real(logits, labels, mask)
    dana.masked_cross_entropy = recording
    _zero_launches()
    try:
        m = trainer.step(batch, draws=inp.get('draws'))
        metrics = {k: float(v) for k, v in m.items()}
    finally:
        dana.masked_cross_entropy = real
    _sync(dev)
    out = dict(metrics=metrics, naive_rpn_loss_cls=naive[0],
               launches=_launches(),
               param_abs_sum=float(sum(
                   p.detach().double().abs().sum().item()
                   for p in trainer.model.parameters())),
               params={n: p.detach().cpu().numpy()
                       for n, p in trainer.model.named_parameters()
                       if p.requires_grad})
    times = []
    for _ in range(time_steps):
        _sync(dev)
        t0 = time.perf_counter()
        trainer.step(batch)
        _sync(dev)
        times.append(1e3 * (time.perf_counter() - t0))
    out['step_ms'] = times
    out['peak_gib'] = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                       if dev.type == 'cuda' else None)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--inputs', required=True)
    ap.add_argument('--out', required=True)
    ap.add_argument('--rank', type=int, required=True)
    ap.add_argument('--world', type=int, required=True)
    ap.add_argument('--init', required=True)
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--time_steps', type=int, default=0)
    args = ap.parse_args(argv)

    with open(args.inputs, 'rb') as f:
        inp = pickle.load(f)
    group = distributed.init_distributed(args.init, args.world, args.rank,
                                         device=args.device)
    try:
        dev = distributed.rank_device(args.device)
        b = next(iter(inp['batch'].values())).shape[0]
        rows = distributed.local_rows(b, group.rank, group.size)
        batch = {k: v[rows] for k, v in inp['batch'].items()}
        runs = {}
        for run in inp['runs']:
            runs[run['label']] = one_run(inp, run, group, dev, batch,
                                         args.time_steps)
        with open(args.out, 'wb') as f:
            pickle.dump(dict(device=str(dev), runs=runs, backend=str(
                torch.distributed.get_backend())), f)
    finally:
        distributed.shutdown()


if __name__ == '__main__':
    main()
