"""The control on the card: the reference put in the program's place and
computed in TF32 (the precision below the configurations' float32 with
TF32 off) must come out not correct against each cell's limits.  Run on
the card at a size a test run holds (the cell's files, cut as
tests/tiny.py cuts them); the limits' readings at the cells' own size are
in limits/<cell>.json.

    python -m pytest -m cuda portbench/tests/test_portbench_control.py
"""

import pytest
import torch

from portbench import controls, harness
from portbench.tests.tiny import tiny

CELLS = [c['name'] for c in harness.benchmark()['workloads']]


@pytest.mark.cuda
@pytest.mark.parametrize('name', CELLS)
def test_the_tf32_control_is_not_correct(name):
    if not torch.cuda.is_available():
        pytest.skip('the control computes in TF32, which needs a CUDA card')
    ctx = tiny(name, device='cuda')
    control = (controls.train_control if ctx.traffic['kind'] == 'train'
               else controls.serve_control)
    checks, ok = harness.judged(control(ctx), harness.limits(name))
    assert not ok, checks
