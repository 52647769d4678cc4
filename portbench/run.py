#!/usr/bin/env python3
"""The benchmark of dana_tpu_torch, the PyTorch and CUDA port of DAnA.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

runs one cell of BENCHMARK.json on the card(s) of this machine, from the
root of a checkout: it reads the cell, its configuration
(configs/<config>.json), its traffic mix (traffic/<mix>.json, whose `kind`
picks loops/serve.py or loops/train.py) and the limits of its comparison
(limits/<cell>.json); makes the detector's weights and the inputs on the
card from the seed; builds the program's kernels (the first run of a
checkout compiles them into portbench/_cache/, every later run finds them
there); warms up the cell's own shapes; measures for --seconds; frees the
program and compares what its timed path produced with the plain
reference (reference/); and prints one JSON line last.  With --trace 1 it
profiles a bounded stretch of the window and reports the cell's
per-layer metrics (metrics/<metric>.py), the device's busy and traced
seconds and a breakdown; with --trace 0 the end-to-end metrics.

A later change adds a configuration, a traffic mix, a cell or a metric
as new files and new BENCHMARK.json entries: the harness finds each by
its name.  Every cache (the kernels' nvcc builds, Triton's, torch's) lives
under portbench/_cache/ inside the checkout.

Exit codes: 0 with a result; 2 without a card (or fewer than the cell
asks for); 3 when a JAX module was loaded; any other failure raises.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import harness  # noqa: E402


def _same(*args):
    return args if len(args) != 1 else args[0]


@dataclasses.dataclass
class Context:
    """One run of a cell: what the loops read, and the faults a test may
    plant in the timed path (`fault` on a request's detections,
    `step_fault` on the trainer's step)."""
    cell: dict
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float
    rate: float | None = None
    fault: object = _same
    step_fault: object = lambda trainer: trainer.step
    setup_s: float | None = None
    marks: list = dataclasses.field(default_factory=list)

    def mark(self, name):
        """Note the end of a set-up phase (printed to standard error)."""
        self.marks.append((name, time.perf_counter() - self.t0))


def run_cell(ctx, lims=None):
    """Run the cell -> the result line's dict."""
    import torch
    loop = importlib.import_module(f'portbench.loops.{ctx.traffic["kind"]}')
    res = loop.run(ctx)
    lims = lims or harness.limits(ctx.cell['name'])
    checks, ok = harness.judged(res['numbers'], lims)
    device = harness.device_info(torch, ctx.device, ctx.cell['chips'])
    device['memory_peak_bytes'] = res['run'].peak_bytes
    breakdown = None
    if ctx.trace:
        from portbench.loops import common
        metrics = common.per_layer_metrics(ctx.cell['name'], res['run'])
        trace = res['run'].trace
        if trace is not None:
            device.update(common.trace_device(trace))
        breakdown = common.breakdown(trace)
    else:
        metrics = dict(res['metrics'], setup_s={'value': ctx.setup_s,
                                                'unit': 's'})
    return harness.result_line(ok and res['failed'] == 0, res['attempted'],
                               res['failed'], metrics, device, checks,
                               breakdown)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.use_checkout_caches()
    cell, cfg, traffic = harness.workload(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell['chips']:
        print(f'{args.workload} needs {cell["chips"]} CUDA card(s); this '
              f'machine has {torch.cuda.device_count()}', file=sys.stderr)
        return 2
    ctx = Context(cell, cfg, traffic, args.seed, args.seconds,
                  bool(args.trace), torch.device('cuda', 0), T0)
    ctx.mark('imports')
    out = run_cell(ctx)
    bad = harness.forbidden_modules()
    if bad:
        print(f'loaded modules of the JAX stack or package: {bad}',
              file=sys.stderr)
        return 3
    print('set-up phases, s from the start: ' + ', '.join(
        f'{name} {t:.2f}' for name, t in ctx.marks), file=sys.stderr)
    for name, c in out['checks'].items():
        print(f'{name} {c["value"]!r} limit {c["limit"]!r}', file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
