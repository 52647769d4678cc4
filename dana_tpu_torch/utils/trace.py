"""The port's tracing: one counter table, a record of every request and
training step on the profiler's clock, and the only ways the live paths
wait on the device from the host (`sync`, `blocking`) and copy host inputs
to the device (`upload`).

Counters.  `count(name, n=1)` adds to one process-wide table under a lock
(the rows of an int8 grid count from threads of their own); `counts()` is
a copy of it, a `collections.Counter` (a name never counted reads 0).
The kernel wrappers count each launch with `launched(op, device, dtype)`:
`<op>.<dtype>` and `<op>.<dtype>@<device>`, e.g. `nms.float32` and
`nms.float32@cuda:0`.  `sync` and `blocking` count `host_syncs` and
`host_syncs.<site>`; `upload` counts `h2d_bytes` and
`h2d_pageable_bytes`.

Units.  `unit(kind)` wraps the body of an entry point
(`Predictor.predict`: 'predict', `Trainer.step`: 'step').  It opens the
record_function range `dana.entry.<kind>` and, on exit, raised or not,
appends one record to `records()`, a deque of the last RECORDS units:
  kind, id          the kind and this process's sequence number
  failed            True when the unit raised
  t0_ns, t1_ns      time.time_ns() on entry and exit
  counts            the unit's delta of every counter that moved
  sync_wait_ns      host ns blocked in `sync` / `blocking` inside the unit
  upload_ns         host ns spent in `upload` inside the unit
The counters are process-wide: a delta is the unit's own because the
entry points run one unit at a time (the benchmark's loops and both
CLIs call them serially).  Units that overlapped, from threads, would
each count the other's work too.

Clock.  A record maps onto a torch.profiler chrome trace (its top-level
`baseTimeNanoseconds`) as ts_us = t_ns / 1e3 - baseTimeNanoseconds / 1e3,
the time base of every event's `ts`.

Range names: `dana.entry.predict`, `dana.entry.step`, `dana.entry.upload`
(the training batch's upload) and `dana.sync.<site>`.  Each has two dots,
so the model's one-dot `dana.*` stage ranges keep their meaning.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch
from torch.profiler import record_function

RECORDS = 4096

_LOCK = threading.Lock()
_COUNTS: collections.Counter = collections.Counter()
_RECORDS: collections.deque = collections.deque(maxlen=RECORDS)
_IDS = itertools.count()
_OPEN: list = []            # the records of the units now open


def count(name: str, n: int = 1):
    """Add n to the counter `name`."""
    with _LOCK:
        _COUNTS[name] += n


def launched(op: str, device, dtype):
    """Count one launch of the kernel `op` on `device` in `dtype` (a torch
    dtype or its name): `<op>.<dtype>` and `<op>.<dtype>@<device>`."""
    name = f'{op}.{str(dtype).replace("torch.", "")}'
    with _LOCK:
        _COUNTS[name] += 1
        _COUNTS[f'{name}@{device}'] += 1


def counts() -> collections.Counter:
    """A copy of the counter table."""
    with _LOCK:
        return collections.Counter(_COUNTS)


def records() -> collections.deque:
    """The records of the last RECORDS units, oldest first."""
    return _RECORDS


@contextlib.contextmanager
def unit(kind: str):
    """The body of one request or step: its range and its record."""
    rec = {'kind': kind, 'id': next(_IDS), 'failed': False, 't0_ns': 0,
           't1_ns': 0, 'counts': {}, 'sync_wait_ns': 0, 'upload_ns': 0}
    with _LOCK:
        before = dict(_COUNTS)
        _OPEN.append(rec)
    rec['t0_ns'] = time.time_ns()
    try:
        with record_function(f'dana.entry.{kind}'):
            yield rec
    except BaseException:
        rec['failed'] = True
        raise
    finally:
        rec['t1_ns'] = time.time_ns()
        with _LOCK:
            _OPEN.remove(rec)
            rec['counts'] = {k: n - before.get(k, 0)
                             for k, n in _COUNTS.items()
                             if n != before.get(k, 0)}
            _RECORDS.append(rec)


def _charge(key: str, ns: int):
    for rec in _OPEN:
        rec[key] += ns


@contextlib.contextmanager
def blocking(site: str, n: int = 1):
    """Around n operations that make the host wait for the device (a copy
    from pageable memory that must finish, a read): the range
    `dana.sync.<site>`; counts n `host_syncs` and `host_syncs.<site>`;
    the ns blocked add to the open units' `sync_wait_ns`."""
    t0 = time.perf_counter_ns()
    with record_function(f'dana.sync.{site}'):
        yield
    waited = time.perf_counter_ns() - t0
    with _LOCK:
        _COUNTS['host_syncs'] += n
        _COUNTS[f'host_syncs.{site}'] += n
        _charge('sync_wait_ns', waited)


def sync(t: torch.Tensor, site: str):
    """t.tolist() under `blocking(site)`: the host waits for the device's
    value (a Python number for a 0-dim tensor)."""
    with blocking(site):
        return t.tolist()


def upload(x, device, non_blocking: bool = False) -> torch.Tensor:
    """x (a numpy array, a tensor or a nested list) as a tensor on
    `device`, in its own dtype.  A copy from host memory to another
    device counts its bytes in `h2d_bytes`, and in `h2d_pageable_bytes`
    too unless x is a pinned tensor (a numpy array is pageable); the host
    ns it takes add to the open units' `upload_ns`.  A tensor already on
    `device` is returned as it is."""
    device = torch.device(device)
    t0 = time.perf_counter_ns()
    t = torch.as_tensor(x)
    if t.device.type != 'cpu' or device.type == 'cpu':
        return t.to(device, non_blocking=non_blocking)
    pinned = isinstance(x, torch.Tensor) and t.is_pinned()
    out = t.to(device, non_blocking=non_blocking)
    spent = time.perf_counter_ns() - t0
    nbytes = t.numel() * t.element_size()
    with _LOCK:
        _COUNTS['h2d_bytes'] += nbytes
        if not pinned:
            _COUNTS['h2d_pageable_bytes'] += nbytes
        _charge('upload_ns', spent)
    return out
