"""utils/trace.py on the CPU: the counter table, one record per
`Predictor.predict` and `Trainer.step` (also when it raises), `upload`'s
byte counts (the meta device stands in for the card), the counts and
waits of `sync` and `blocking`, and the records' clock against an
exported torch.profiler trace.
"""

import json
import time

import numpy as np
import pytest
import torch

from test_torch_port_profile import tiny_predictor, tiny_trainer
from dana_tpu_torch.utils import trace


@pytest.fixture(scope='module')
def predictor():
    return tiny_predictor()


@pytest.fixture(scope='module')
def profiled(predictor, tmp_path_factory):
    """One predict, then one step, under torch.profiler: (their records,
    the exported chrome trace)."""
    (pred, request), (tr, batch) = predictor, tiny_trainer()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        pred.predict(*request)
        tr.step(batch)
    recs = list(trace.records())[-2:]
    path = tmp_path_factory.mktemp('trace') / 'trace.json'
    prof.export_chrome_trace(str(path))
    return recs, json.loads(path.read_text())


def test_launches_count_by_dtype_and_device():
    before = trace.counts()
    trace.launched('probe_op', torch.device('cuda', 1), torch.bfloat16)
    trace.launched('probe_op', 'cuda:0', 'int8')
    got = trace.counts()
    assert {k: got[k] - before[k] for k in got if got[k] != before[k]} == {
        'probe_op.bfloat16': 1, 'probe_op.bfloat16@cuda:1': 1,
        'probe_op.int8': 1, 'probe_op.int8@cuda:0': 1}
    got['probe_op.int8'] += 5                   # a copy, not the table
    assert trace.counts()['probe_op.int8'] == before['probe_op.int8'] + 1


def test_one_record_per_predict_and_step_in_sequence(profiled):
    recs, _ = profiled
    assert [r['kind'] for r in recs] == ['predict', 'step']
    assert recs[1]['id'] == recs[0]['id'] + 1
    assert not any(r['failed'] for r in recs)
    assert recs[0]['t0_ns'] < recs[0]['t1_ns'] <= recs[1]['t0_ns'] \
        < recs[1]['t1_ns']
    step = recs[1]['counts']
    # the update reads its skipped flag once, proposal_target copies two
    # constants; on the CPU the plain NMS reads its loops' flags too
    assert (step['host_syncs.update'], step['host_syncs.proposal_target']) \
        == (1, 2)
    assert step['host_syncs'] == 3 + step['host_syncs.nms'] >= 4
    assert recs[1]['sync_wait_ns'] > 0
    # CPU inputs served on the CPU: nothing is uploaded
    assert not any(k.startswith('h2d') for r in recs for k in r['counts'])


def test_a_raised_unit_is_recorded_failed(predictor):
    pred, (q, info, _) = predictor
    with pytest.raises(KeyError):
        pred.predict(q, info, [99])         # no supports encoded for 99
    rec = trace.records()[-1]
    assert rec['kind'] == 'predict' and rec['failed']
    with pytest.raises(ValueError):
        with trace.unit('probe'):
            raise ValueError('a step that raises')
    rec2 = trace.records()[-1]
    assert (rec2['kind'], rec2['failed'], rec2['id']) == ('probe', True,
                                                          rec['id'] + 1)


def test_upload_counts_bytes_and_the_pageable_share(monkeypatch):
    a = np.zeros((2, 3, 4), np.uint8)
    t = torch.zeros(5)
    with trace.unit('probe') as rec:
        x = trace.upload(a, 'meta')
        y = trace.upload(t, torch.device('meta'), non_blocking=True)
        assert trace.upload(y, 'meta') is y     # already there: no copy
        assert trace.upload(t, 'cpu') is t      # host to host: no copy
    assert (x.device.type, x.dtype, x.shape) == ('meta', torch.uint8,
                                                 a.shape)
    assert (y.device.type, y.dtype) == ('meta', torch.float32)
    assert rec['counts'] == {'h2d_bytes': 24 + 20, 'h2d_pageable_bytes': 44}
    assert rec['upload_ns'] > 0
    # a pinned tensor (this CPU build cannot pin one: is_pinned is
    # patched) is not pageable; a numpy array always is
    monkeypatch.setattr(torch.Tensor, 'is_pinned', lambda self: True)
    with trace.unit('probe') as rec:
        trace.upload(t, 'meta')
        trace.upload(a, 'meta')
    assert rec['counts'] == {'h2d_bytes': 44, 'h2d_pageable_bytes': 24}


class _Slow:
    """A value whose read blocks the host 2 ms, as a device's would."""

    def tolist(self):
        time.sleep(0.002)
        return 7


def test_sync_counts_and_times_its_waits():
    with trace.unit('probe') as rec:
        assert trace.sync(torch.tensor([3.0, 4.0]), 'probe') == [3.0, 4.0]
        assert trace.sync(torch.tensor(True), 'probe') is True
        assert trace.sync(_Slow(), 'probe') == 7
        with trace.blocking('copies', n=2):
            time.sleep(0.002)
    assert rec['counts'] == {'host_syncs': 5, 'host_syncs.probe': 3,
                             'host_syncs.copies': 2}
    assert 4e6 <= rec['sync_wait_ns'] < rec['t1_ns'] - rec['t0_ns']
    assert rec['upload_ns'] == 0


def test_records_lie_on_the_profilers_clock(profiled):
    """Each record's [t0, t1], mapped by the trace's baseTimeNanoseconds,
    lies within 1 ms of its `dana.entry.*` range."""
    recs, data = profiled
    base_us = data['baseTimeNanoseconds'] / 1e3
    ranges = {e['name']: (e['ts'], e['ts'] + e['dur'])
              for e in data['traceEvents']
              if e.get('cat') == 'user_annotation' and 'dur' in e
              and e['name'].startswith('dana.entry.')}
    assert set(ranges) == {'dana.entry.predict', 'dana.entry.step',
                           'dana.entry.upload'}
    for rec in recs:
        t0, t1 = ranges[f'dana.entry.{rec["kind"]}']
        assert abs(rec['t0_ns'] / 1e3 - base_us - t0) <= 1e3
        assert abs(rec['t1_ns'] / 1e3 - base_us - t1) <= 1e3
