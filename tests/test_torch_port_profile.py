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
# the ranges of utils/trace.py: the entry point's unit and, on the CPU,
# the plain NMS's host reads of its loop flags (the card's kernel reads
# none); a step also uploads its batch, copies proposal_target's two
# constants and reads the update's skipped flag
PREDICT_UNIT = {'dana.entry.predict', 'dana.sync.nms'}
STEP_UNIT = {'dana.entry.step', 'dana.entry.upload', 'dana.sync.nms',
             'dana.sync.proposal_target', 'dana.sync.update'}


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


def test_unit_ranges_stay_out_of_the_stages():
    """The ranges of utils/trace.py enclose stages: the tools print them
    apart and sum none of them."""
    stages = {'dana.trunk': (1.0, 2.0), 'dana.rcnn_head.layer4': (0.5, 1.0),
              'dana.entry.predict': (1.5, 9.0), 'dana.entry.upload': (0.1,
                                                                     0.3),
              'dana.sync.nms': (0.0, 0.2)}
    kept, units = _tool().split_units(stages)
    assert kept == {'dana.trunk': (1.0, 2.0),
                    'dana.rcnn_head.layer4': (0.5, 1.0)}
    assert set(units) == {'dana.entry.predict', 'dana.entry.upload',
                          'dana.sync.nms'}


def tiny_predictor():
    """A tiny DAnA predictor on the CPU with class 0's supports encoded,
    and one request for it: (pred, (im_data, im_info, classes))."""
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
    return pred, (q, info, [0])


def tiny_trainer():
    """A tiny DAnA trainer on the CPU and one batch for it."""
    from dana_tpu_torch.engine.train import Trainer
    conf = tdana.DanaConfig(n_way=2, n_shot=1, train_pre_nms=100,
                            train_post_nms=16, nms_cap=100, rois_per_image=8,
                            rpn_batchsize=16)
    trainer = Trainer(tdana.init_params(conf, seed=2), conf, device='cpu')
    rng = np.random.default_rng(2)
    gt = np.zeros((1, 2, 5), np.float32)
    gt[0, 0] = [10, 10, 70, 60, 1]
    batch = dict(im_data=rng.integers(0, 256, (1, 96, 128, 3))
                 .astype(np.uint8),
                 im_info=np.array([[96, 128, 1.0]], np.float32), gt_boxes=gt,
                 support_ims=rng.normal(0, 50, (1, 2, 224, 224, 3))
                 .astype(np.float32))
    return trainer, batch


def _opened(fn):
    """The `dana.*` range names that fn() opens."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
    return {e.key for e in prof.key_averages() if e.key.startswith('dana.')}


def test_predict_opens_every_stage_range():
    pred, request = tiny_predictor()
    want = pred.predict(*request)
    got = []
    names = _opened(lambda: got.extend(pred.predict(*request)))
    assert names == STAGES | PREDICT_UNIT
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.fixture(scope='module')
def step_ranges():
    trainer, batch = tiny_trainer()
    return _opened(lambda: trainer.step(batch))


def test_train_step_opens_every_stage_range(step_ranges):
    assert step_ranges == (STAGES - {'dana.upload', 'dana.postprocess'}) | {
        'dana.support_trunk', 'dana.targets', 'dana.losses',
        'dana.backward', 'dana.update'} | STEP_UNIT


def test_forward_reader_selects_the_forward_ranges(step_ranges):
    """portbench's `model.forward_ms.train` charges the one-dot `dana.*`
    ranges but dana.backward and dana.update: in a step that is still
    exactly the forward's stages, none of the unit's ranges."""
    path = os.path.join(ROOT, 'portbench', 'metrics',
                        'model.forward_ms.train.py')
    spec = importlib.util.spec_from_file_location('forward_ms_train', path)
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    picked = set()

    class Trace:
        device, units = [1], 1

        def charged_s(self, pred):
            picked.update(n for n in step_ranges if pred(n))
            return 0.0

    class Run:
        kind, trace = 'train', Trace()

    assert reader.read(Run()) == 0.0
    assert picked == {'dana.trunk', 'dana.support_trunk',
                      'dana.rpn_attention', 'dana.rpn_heads',
                      'dana.proposals', 'dana.targets', 'dana.roi_align',
                      'dana.rcnn_head', 'dana.losses'}


@pytest.mark.parametrize('case', ['pool', 'crop', 'vgg16'])
def test_predict_opens_the_pooling_and_tail_ranges(case):
    """POOLING_MODE pool and crop pool in their own ranges (dana.roi_pool,
    dana.roi_crop) and launch no RoIAlign; VGG16's RoI tail runs in
    dana.rcnn_head.fc."""
    kw = dict(arch='vgg16') if case == 'vgg16' else dict(pooling_mode=case)
    conf = tdana.DanaConfig(n_way=2, n_shot=2, test_pre_nms=200,
                            test_post_nms=16, **kw)
    pred = Predictor(tdana.init_params(conf, seed=1), conf, device='cpu')
    rng = np.random.default_rng(1)
    pred.encode_supports(0, rng.normal(0, 50, (2, 224, 224, 3))
                         .astype(np.float32))
    q = rng.integers(0, 256, (1, 96, 128, 3)).astype(np.uint8)
    info = np.array([[96, 128, 1.0]], np.float32)
    names = _opened(lambda: pred.predict(q, info, [0]))
    if case == 'vgg16':
        want = STAGES - {'dana.rcnn_head.layer4'} | {'dana.rcnn_head.fc'}
    else:
        want = STAGES - {'dana.roi_align'} | {f'dana.roi_{case}'}
    if case == 'pool':
        want |= {'dana.sync.roi_pool'}
    assert names == want | PREDICT_UNIT


def test_tools_build_the_asked_trunk_and_mode():
    """The profile tools' --net, --backbone and --set: the detector of
    get_model's draw on the asked trunk, with the tree's overrides."""
    from dana_tpu_torch.utils import config as tcfg
    config, params = _tool().model_for('DAnA', 'res101',
                                       ['POOLING_MODE', 'crop'], 3)
    assert (config.arch, config.pooling_mode) == ('resnet101', 'crop')
    assert config.num_anchors == 9 and config.semantic_enhance
    want = tcfg.get_model('res101', seed=3)[1]
    assert len(params['backbone']['layer3']) == 23
    np.testing.assert_array_equal(params['RCNN_rpn']['RPN_Conv']['weight'],
                                  want['RCNN_rpn']['RPN_Conv']['weight'])
