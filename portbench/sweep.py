#!/usr/bin/env python3
"""The readings a cell's limits and load are set from, on the card, in one
process (the kernels built once):

    python3 portbench/sweep.py --workload <cell> --seeds 1,2,... \
        [--control-seeds ...] [--fault-seeds ...] [--seconds 4] \
        [--rates 5,6,7,...] [--out sweep.json]

--seeds: the program's run of the cell (a short window at the cell's own
load, the comparison as a run makes it) on each seed; --control-seeds:
the control (controls.py) on each; --fault-seeds: a training cell's fault
of half the batch left out; --answer-fault-seeds: the program's run with
a proposal altered where it is produced; --plain-attention-seeds: the
program's run with its CISA kernel replaced by its plain version (a
witness for a seed that reads high); --rates (serving): the window at
each offered rate on the first seed, for the highest rate the system
sustains.
Prints one line per reading and writes them all to --out as JSON.  Not
run by the benchmark's runs.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import harness  # noqa: E402


def _ints(s):
    return [int(x) for x in s.split(',') if x]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=_ints, default=[])
    ap.add_argument('--control-seeds', type=_ints, default=[])
    ap.add_argument('--fault-seeds', type=_ints, default=[])
    ap.add_argument('--answer-fault-seeds', type=_ints, default=[])
    ap.add_argument('--plain-attention-seeds', type=_ints, default=[])
    ap.add_argument('--rates', type=lambda s: [float(x) for x in
                                               s.split(',') if x],
                    default=[])
    ap.add_argument('--seconds', type=float, default=4.0)
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    harness.use_checkout_caches()
    cell, cfg, traffic = harness.workload(args.workload)
    import torch
    if not torch.cuda.is_available():
        print('the sweep needs a CUDA card', file=sys.stderr)
        return 2
    from portbench import controls
    from portbench.loops import common
    from portbench.run import Context
    dev = torch.device('cuda', 0)
    smi = os.popen('nvidia-smi --query-gpu=name,power.limit '
                   '--format=csv,noheader').read().strip()
    out = {'workload': args.workload, 'card': smi, 'program': [],
           'control': [], 'fault_half_batch': [], 'fault_answer': [],
           'plain_attention': [], 'rates': []}

    def ctx(seed, rate=None):
        return Context(cell, cfg, traffic, seed, args.seconds, False, dev,
                       time.perf_counter(), rate=rate)

    def loop_run(c):
        import importlib
        loop = importlib.import_module(f'portbench.loops.{traffic["kind"]}')
        res = loop.run(c)
        common.free(dev)
        return {'seed': c.seed, 'numbers': res['numbers'],
                'metrics': {k: v['value'] for k, v in res['metrics'].items()},
                'setup_s': c.setup_s, 'attempted': res['attempted'],
                'failed': res['failed'], 'rate': c.rate,
                'peak_bytes': res['run'].peak_bytes,
                'details': res.get('details')}

    def emit(kind, rec):
        out[kind].append(rec)
        print(kind, json.dumps(rec), flush=True)

    for s in args.seeds:
        emit('program', loop_run(ctx(s)))
    for r in args.rates:
        emit('rates', loop_run(ctx(args.seeds[0] if args.seeds else 1, r)))
    for s in args.control_seeds:
        fn = controls.train_control if traffic['kind'] == 'train' \
            else controls.serve_control
        emit('control', {'seed': s, 'numbers': fn(ctx(s))})
        common.free(dev)
    for s in args.fault_seeds:
        emit('fault_half_batch', {'seed': s, 'numbers':
                                  controls.train_half_batch(ctx(s))})
        common.free(dev)
    for s in args.answer_fault_seeds:
        with controls.altered_proposals():
            emit('fault_answer', loop_run(ctx(s)))
    for s in args.plain_attention_seeds:
        with controls.plain_attention():
            emit('plain_attention', loop_run(ctx(s)))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(out, f, indent=1)
    print(f'sweep done in {time.perf_counter() - T0:.1f} s', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
