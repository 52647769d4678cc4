"""The readers of the program's unit records (units.py and the seven
`entry.*` metrics it serves) on made-up runs and records: each reads its
own kind, the window's last units, and None where records are missing.

    python -m pytest portbench/tests -q
"""

import collections
import types

import pytest

from dana_tpu_torch.utils import trace
from portbench import harness, units

READERS = {
    'entry.host_syncs.serve': ('serve', 'host_syncs', 1),
    'entry.host_syncs.train': ('train', 'host_syncs', 1),
    'entry.sync_wait_ms.train': ('train', 'sync_wait_ns', 1e-6),
    'entry.h2d_pageable_mib.serve': ('serve', 'h2d_pageable_bytes',
                                     2 ** -20),
    'entry.h2d_pageable_mib.train': ('train', 'h2d_pageable_bytes',
                                     2 ** -20),
    'entry.upload_ms.serve': ('serve', 'upload_ns', 1e-6),
    'entry.upload_ms.train': ('train', 'upload_ns', 1e-6),
}


def _record(kind, i, value, failed=False):
    """A unit record of `kind` whose every counter and span reads
    `value`."""
    counts = {'host_syncs': value, 'h2d_pageable_bytes': value,
              'h2d_bytes': value}
    return {'kind': kind, 'id': i, 'failed': failed, 't0_ns': i,
            't1_ns': i + 1, 'counts': counts, 'sync_wait_ns': value,
            'upload_ns': value}


def _run(kind, n):
    return types.SimpleNamespace(kind=kind, host_ms=[1.0] * n)


@pytest.fixture
def records(monkeypatch):
    """The program's record deque, empty, for the test to fill."""
    recs = collections.deque(maxlen=trace.RECORDS)
    monkeypatch.setattr(trace, '_RECORDS', recs)
    return recs


def test_every_reader_has_its_entry():
    entries = {m['name']: m for m in harness.benchmark()['per_layer']}
    for name, (kind, _, _) in READERS.items():
        m = entries[name]
        assert m['layer'] == 'entry points' and m['workloads']
        assert all(kind in w for w in m['workloads'])


@pytest.mark.parametrize('name', READERS)
def test_reader_takes_the_windows_last_units_of_its_kind(records, name):
    kind, _, scale = READERS[name]
    other = 'step' if kind == 'serve' else 'predict'
    mine = units.KIND[kind]
    # set-up units of both kinds and a failed unit are not the window's;
    # the window is the last 3 of the kind that returned
    records.extend([_record(mine, 0, 1000), _record(other, 1, 5000),
                    _record(mine, 2, 10), _record(mine, 3, 2000, True),
                    _record(mine, 4, 30), _record(other, 5, 7000),
                    _record(mine, 6, 20)])
    read = harness.metric_readers([name])[name]
    assert read(_run(kind, 3)) == pytest.approx(20 * scale)
    assert read(_run(kind, 1)) == pytest.approx(20 * scale)


@pytest.mark.parametrize('name', READERS)
def test_reader_reads_none_without_its_records(records, name):
    kind, _, _ = READERS[name]
    read = harness.metric_readers([name])[name]
    records.extend([_record(units.KIND[kind], i, 1) for i in range(2)])
    assert read(_run(kind, 3)) is None            # fewer records than units
    assert read(_run(kind, 0)) is None            # no window
    other = 'train' if kind == 'serve' else 'serve'
    assert read(_run(other, 2)) is None           # another cell's kind
    assert read(_run(kind, 2)) is not None


def test_a_program_without_records_reads_none(monkeypatch):
    import builtins
    real = builtins.__import__

    def no_trace(name, *a, **k):
        if name == 'dana_tpu_torch.utils' or name.endswith('utils.trace'):
            raise ImportError(name)
        return real(name, *a, **k)
    monkeypatch.setattr(builtins, '__import__', no_trace)
    assert units.window(_run('serve', 1), 'serve') is None
