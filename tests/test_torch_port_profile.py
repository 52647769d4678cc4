"""The serving path's stage ranges and how tools/profile_torch_predict.py
charges device time to them.  On the CPU a synthetic trace stands in for
the card's: the tool is run on the card, its attribution is tested here.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from dana_tpu_torch.engine.predict import Predictor
from dana_tpu_torch.models import dana as tdana
from dana_tpu_torch.utils.weights import from_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = {'dana.upload', 'dana.trunk', 'dana.rpn_attention',
          'dana.rpn_heads', 'dana.proposals', 'dana.roi_align',
          'dana.rcnn_head', 'dana.rcnn_head.layer4', 'dana.postprocess'}


def _tool():
    path = os.path.join(ROOT, 'tools', 'profile_torch_predict.py')
    spec = importlib.util.spec_from_file_location('profile_torch_predict',
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _trace(iters):
    """`iters` copies of one request: a trunk range, then an R-CNN head
    range with a nested layer4 range; four device events, one of them
    (a copy) launched outside every range."""
    events = []
    for i in range(iters):
        t = 1000.0 * i

        def ev(cat, name, ts, dur, **args):
            events.append({'ph': 'X', 'cat': cat, 'name': name,
                           'ts': t + ts, 'dur': dur, 'args': args})
        ev('user_annotation', 'dana.trunk', 0, 100)
        ev('user_annotation', 'dana.rcnn_head', 100, 100)
        ev('user_annotation', 'dana.rcnn_head.layer4', 120, 50)
        ev('user_annotation', 'other', 0, 500)
        for corr, ts in ((1, 10), (2, 130), (3, 180), (4, 300)):
            ev('cuda_runtime', 'cudaLaunchKernel', ts, 2,
               correlation=10 * i + corr)
        ev('kernel', 'conv', 400, 30, correlation=10 * i + 1)
        ev('kernel', 'conv', 440, 40, correlation=10 * i + 2)
        ev('kernel', 'cisa', 490, 5, correlation=10 * i + 3)
        ev('gpu_memcpy', 'Memcpy HtoD', 500, 7, correlation=10 * i + 4)
    return {'traceEvents': events}


@pytest.mark.parametrize('iters', [1, 3])
def test_stage_times_charge_the_launching_ranges(tmp_path, iters):
    path = tmp_path / 'trace.json'
    path.write_text(json.dumps(_trace(iters)))
    stages, busy, kernels = _tool().stage_times(str(path), iters)
    assert stages.keys() == {'dana.trunk', 'dana.rcnn_head',
                             'dana.rcnn_head.layer4'}
    np.testing.assert_allclose(stages['dana.trunk'], (0.030, 0.100))
    np.testing.assert_allclose(stages['dana.rcnn_head'], (0.045, 0.100))
    np.testing.assert_allclose(stages['dana.rcnn_head.layer4'],
                               (0.040, 0.050))
    assert busy == pytest.approx(0.082)
    np.testing.assert_allclose(kernels['conv'], (0.070, 2))
    np.testing.assert_allclose(kernels['Memcpy HtoD'], (0.007, 1))


def test_predict_opens_every_stage_range():
    conf = tdana.DanaConfig(n_way=2, n_shot=2, semantic_enhance=True,
                            anchor_scales=(8, 16, 32), test_pre_nms=200,
                            test_post_nms=16)
    pred = Predictor(from_jax_params(tdana.init_params(conf, seed=1), conf),
                     conf, device='cpu')
    rng = np.random.default_rng(1)
    pred.encode_supports(0, rng.normal(0, 50, (2, 224, 224, 3))
                         .astype(np.float32))
    q = rng.integers(0, 256, (1, 96, 128, 3)).astype(np.uint8)
    info = np.array([[96, 128, 1.0]], np.float32)
    want = pred.predict(q, info, [0])
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        got = pred.predict(q, info, [0])
    names = {e.key for e in prof.key_averages() if e.key.startswith('dana.')}
    assert names == STAGES
    assert all(torch.equal(a, b) for a, b in zip(got, want))
