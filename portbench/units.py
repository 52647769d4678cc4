"""What the readers of the program's own unit records share
(dana_tpu_torch/utils/trace.py).

The program keeps a record of every unit, one `Predictor.predict`
('predict') or one `Trainer.step` ('step'): the unit's delta of each
counter of its table (`host_syncs`, `h2d_bytes`, `h2d_pageable_bytes`,
the kernels' launches), the host ns it was blocked reading device values
(`sync_wait_ns`) and spent uploading its inputs (`upload_ns`), and its
start and end on the host's clock (`t0_ns`, `t1_ns`, which map onto a
saved torch.profiler trace as ts = t_ns / 1e3 - baseTimeNanoseconds / 1e3).
The range `dana.entry.predict` or `dana.entry.step` covers the unit in
the device trace.

A window's units are the last `len(run.host_ms)` records of the run's
kind that did not raise: both loops call the entry point for nothing
after the window, and `host_ms` has one entry a call that returned.  A
program without the records (before utils/trace.py) reads None, as does
a run with fewer records than units.
"""

from portbench import harness

KIND = {'serve': 'predict', 'train': 'step'}


def window(run, kind):
    """The records of the window's units, oldest first, or None."""
    if run.kind != kind or not run.host_ms:
        return None
    try:
        from dana_tpu_torch.utils import trace
    except ImportError:
        return None
    recs = [r for r in trace.records()
            if r['kind'] == KIND[kind] and not r['failed']]
    n = len(run.host_ms)
    return recs[-n:] if len(recs) >= n else None


def median(run, kind, value):
    """The median over the window's units of value(record), or None."""
    recs = window(run, kind)
    if recs is None:
        return None
    return harness.median([value(r) for r in recs])
