"""A run of each cell with its timed path broken underneath, on the CPU at
a small size (the harness's look for a card skipped): `correct` must come
out false for every fault the cell can have, and true unbroken.

Serving: an answer altered where it is produced (a detection moved); half
of the batch left out (its answers dropped).  Training: a step that
leaves its state unchanged; half of the batch left out (the step's means
over the rest); an answer altered where it is produced (a proposal
moved).  The exchange between cards does not exist on one card."""

import contextlib

import pytest
import torch

from portbench import controls, harness
from portbench.run import run_cell
from portbench.tests.tiny import tiny

SERVE = [c['name'] for c in harness.benchmark()['workloads']
         if harness.workload(c['name'])[2]['kind'] == 'serve']
TRAIN = [c['name'] for c in harness.benchmark()['workloads']
         if harness.workload(c['name'])[2]['kind'] == 'train']


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def moved_answer(dets, valid):
    """The first query's answer altered: its boxes moved half a pixel."""
    dets = dets.clone()
    dets[0, :, :4] += 0.5
    return dets, valid


def half_the_answers(dets, valid):
    dets, valid = dets.clone(), valid.clone()
    half = len(dets) // 2
    dets[half:], valid[half:] = 0.0, False
    return dets, valid


def unchanged_state(trainer):
    trainer.optimizer.step = lambda *a, **k: None
    return trainer.step


def half_the_batch(trainer):
    def step(batch, draws):
        n = len(batch['im_data']) // 2
        return trainer.step({k: v[:n] for k, v in batch.items()},
                            {k: v[:n] for k, v in draws.items()})
    return step


def _run(name, **kw):
    return run_cell(tiny(name, **kw), lims=harness.limits(name))


@pytest.mark.parametrize('name', SERVE + TRAIN)
def test_the_unbroken_path_is_correct(name):
    ctx = tiny(name)
    out = run_cell(ctx, lims=harness.limits(name))
    assert out['correct'], out['checks']
    assert out['failed'] == 0 and out['attempted'] >= 1
    m = {k: v['value'] for k, v in out['metrics'].items()}
    assert m['setup_s'] > 0
    if name in SERVE:
        # every request of the window is due and done: the rate is over
        # the whole window, which lasts at least --seconds
        assert out['attempted'] == round(ctx.traffic['rate_per_s']
                                         * ctx.seconds)
        batch = ctx.traffic['batch']
        assert 0 < m['serve_img_per_s'] <= batch * out['attempted'] \
            / ctx.seconds
        assert m['serve_p95_ms'] > 0


@pytest.mark.parametrize('fault', [moved_answer, half_the_answers])
@pytest.mark.parametrize('name', SERVE)
def test_a_broken_serving_path_is_not_correct(name, fault):
    out = _run(name, fault=fault)
    assert not out['correct'], out['checks']


@pytest.mark.parametrize('fault', ['unchanged', 'half', 'answer'])
@pytest.mark.parametrize('name', TRAIN)
def test_a_broken_training_step_is_not_correct(name, fault):
    kw = {'unchanged': dict(step_fault=unchanged_state),
          'half': dict(step_fault=half_the_batch)}.get(fault, {})
    ctx = (controls.altered_proposals() if fault == 'answer'
           else contextlib.nullcontext())
    with ctx:
        out = _run(name, **kw)
    assert not out['correct'], out['checks']
