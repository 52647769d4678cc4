"""The rest of the library surface on the port against the JAX package's on
the CPU: attention maps (models/viz.py) and the inference logger
(utils/fsod_logger.py), the legacy logger, the demo helpers of the root
`utils.py` (utils/demo.py), reference `.pth` export and the trunk-only
import (utils/torch_import.py), the HDF5 weight dump (utils/checkpoint.py)
and tools/torch_visualize_attention.py.

Tolerances: the relevance maps within 1e-5 (float32 trunks whose sums run
in another order in each package, ~1e-6 relative, then a softmax of
values in (0, 1]); an overlay within one grey level (its uint8 rounding
of those maps); detections tie-aware at 2e-3 px (ROADMAP "Carried
findings"); everything else exact.
"""

import json
import os
import pathlib
import sys

import cv2
import jax
import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / 'tools'))

from test_torch_port_model import _leaves, _match_detections  # noqa: E402

import utils as cli_utils  # noqa: E402
from dana_tpu.models import dana as jdana  # noqa: E402
from dana_tpu.models.layers import to_jnp  # noqa: E402
from dana_tpu.utils.config import cfg, cfg_from_list  # noqa: E402

from dana_tpu_torch.data import blob as tblob  # noqa: E402
from dana_tpu_torch.models import dana as tdana  # noqa: E402
from dana_tpu_torch.utils import checkpoint as tckpt  # noqa: E402
from dana_tpu_torch.utils import config as tcfg  # noqa: E402
from dana_tpu_torch.utils import demo  # noqa: E402
from dana_tpu_torch.utils import torch_import as timport  # noqa: E402
from dana_tpu_torch.utils.weights import (from_jax_params,  # noqa: E402
                                          load_reference_state_dict,
                                          to_jax_params)

# tests/test_viz.py's and tests/test_demo_utils.py's config
FIELDS = dict(n_way=2, n_shot=1, train_pre_nms=200, train_post_nms=32,
              test_pre_nms=200, test_post_nms=16, nms_cap=200)
SHRINK = ['TRAIN.SCALES', '(96,)', 'TRAIN.MAX_SIZE', '128',
          'TEST.SCALES', '(96,)', 'TEST.MAX_SIZE', '128']
VIZ_TOL = 1e-5
COORD_ATOL = 2e-3


@pytest.fixture(scope='module')
def small():
    jconf = jdana.DanaConfig(**FIELDS)
    tconf = tdana.DanaConfig(**FIELDS)
    params = jdana.init_params(jconf, seed=0)
    return jconf, tconf, params, from_jax_params(params, tconf)


@pytest.fixture
def no_ipp():
    """cv2's IPP float resize sits ~0.01 grey from its own INTER_LINEAR,
    which the port reproduces (tests/test_torch_port_data.py)."""
    ipp = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(ipp)


@pytest.fixture
def no_tensorboard(monkeypatch):
    """Both packages' loggers keep their records in memory when
    torch.utils.tensorboard does not import (which here imports TensorFlow,
    ~15 s); the records are what the tests compare."""
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)


def _shrunk_trees():
    cfg_from_list(list(SHRINK))
    c = tcfg.default_cfg()
    tcfg.cfg_from_list(c, list(SHRINK))
    return c


# ------------------------------------------------------ viz and loggers

def _attention_batch():
    """tests/test_viz.py's logger batch; the relevance test takes the same
    shapes, so that JAX's op-by-op primitives compile once for both."""
    rng = np.random.default_rng(1)
    return {
        'im_data': rng.normal(size=(1, 128, 160, 3)).astype(np.float32),
        'support_ims': rng.normal(
            size=(1, 1, 224, 224, 3)).astype(np.float32),
    }


def test_rpn_attention_relevance_matches_jax(small):
    from dana_tpu.models.viz import rpn_attention_relevance as jrel
    from dana_tpu_torch.models.viz import rpn_attention_relevance
    jconf, tconf, params, model = small
    batch = _attention_batch()
    q = batch['im_data'][0] * 10
    s = batch['support_ims'][0] * 10
    want = jrel(to_jnp(params), jconf, q, s)
    got = rpn_attention_relevance(model, tconf, q, s)
    assert got.shape == (8, 10) and got.dtype == np.float32
    assert got.min() > 0.0 and got.max() <= 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=VIZ_TOL)


def test_overlay_heatmap_matches_jax():
    from dana_tpu.models.viz import overlay_heatmap as joverlay
    from dana_tpu_torch.models.viz import overlay_heatmap
    rng = np.random.default_rng(1)
    im = rng.integers(0, 256, (64, 96, 3)).astype(np.uint8)
    heat = rng.random((4, 6)).astype(np.float32)
    np.testing.assert_array_equal(overlay_heatmap(im, heat),
                                  joverlay(im, heat))
    flat = np.ones((4, 6), np.float32)
    np.testing.assert_array_equal(overlay_heatmap(im, flat),
                                  joverlay(im, flat))


def test_inference_logger_matches_jax(small, tmp_path, no_tensorboard):
    """write_attention's overlay within one grey level of the JAX
    logger's; write records the query and its predictions in red."""
    from dana_tpu.utils.fsod_logger import FSODInferenceLogger as JLogger
    from dana_tpu.utils.fsod_logger import _to_uint8, draw_boxes
    from dana_tpu_torch.utils.fsod_logger import FSODInferenceLogger
    jconf, tconf, params, model = small
    batch = _attention_batch()
    want = JLogger(str(tmp_path / 'jax')).write_attention(
        3, to_jnp(params), jconf, batch)
    logger = FSODInferenceLogger(str(tmp_path / 'port'))
    got = logger.write_attention(3, model, tconf, batch)
    assert got.shape == (128, 160, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    preds = np.array([[10, 20, 60, 90, 0.9]], np.float32)
    logger.write(4, batch, predictions=preds)
    images = {tag: im for step, tag, im in logger.images}
    assert set(images) == {'attention', 'query', 'support/0', 'predictions'}
    im = _to_uint8(batch['im_data'][0], cfg.PIXEL_MEANS)
    np.testing.assert_array_equal(images['predictions'],
                                  draw_boxes(im, preds, color=(255, 0, 0)))
    logger.close()


def test_legacy_logger_matches_jax(tmp_path, no_tensorboard):
    from dana_tpu.utils.legacy_logger import Logger as JLogger
    from dana_tpu_torch.utils.legacy_logger import Logger
    images = [np.zeros((8, 8, 3), np.uint8),
              np.linspace(0, 1, 64).reshape(8, 8)]
    values = np.random.default_rng(0).normal(size=100)
    loggers = [JLogger(str(tmp_path / 'jax')), Logger(str(tmp_path / 'p'))]
    for lg in loggers:
        lg.scalar_summary('loss', 0.5, 1)
        lg.image_summary('imgs', images, 1)
        lg.histo_summary('weights', values, 1, bins=10)
    want, got = (lg.events for lg in loggers)
    assert [e[:3] for e in got] == [e[:3] for e in want] == [
        (1, 'scalar', 'loss'), (1, 'image', 'imgs/0'),
        (1, 'image', 'imgs/1'), (1, 'histogram', 'weights')]
    assert got[0][3] == want[0][3] and got[1][3] == want[1][3]
    for a, b in zip(got[3][3], want[3][3]):
        np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------- demo

def test_preprocess_matches_jax(no_ipp):
    c = _shrunk_trees()
    rng = np.random.default_rng(0)
    im = rng.integers(0, 255, (100, 140, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        demo.support_im_preprocess(im, c, n_of_shot=2),
        cli_utils.support_im_preprocess(im, cfg, n_of_shot=2))
    for exact in (True, False):
        cfg.TPU.EXACT_QUERY_SCALE = c.TPU.EXACT_QUERY_SCALE = exact
        (q, info), (jq, jinfo) = (demo.query_im_preprocess(im, c),
                                  cli_utils.query_im_preprocess(im, cfg))
        np.testing.assert_array_equal(info, jinfo)
        np.testing.assert_array_equal(q, jq)
    assert tuple(jinfo[:2]) == (91, 128)


def test_nms_matches_jax():
    """Greedy NMS at TEST.NMS with the +1 IoU and equal scores (the
    stable sort keeps the first)."""
    rng = np.random.default_rng(3)
    xy = rng.random((60, 2)) * 80
    boxes = np.concatenate([xy, xy + rng.random((60, 2)) * 40 + 2], 1)
    scores = rng.random(60).astype(np.float32)
    scores[10:20] = scores[0]
    keep = demo.NMS(boxes, scores)
    np.testing.assert_array_equal(keep, cli_utils.NMS(boxes, scores))
    assert keep.dtype == np.int64 and 0 < len(keep) < 60
    assert len(demo.NMS(np.zeros((0, 4)), np.zeros(0))) == 0


def _write_shot(path, im):
    """PPM bytes under a .jpg name: PIL (the JAX helper) and the port's
    reader both tell the format by its first bytes."""
    tblob.write_ppm(str(path), im)


def test_run_detection_and_pseudo_label_match_jax(small, tmp_path,
                                                  monkeypatch, no_ipp):
    """run_detection against the JAX helper (its forward jitted; the same
    detections, tie-aware); generate_pseudo_label at its threshold, then
    against the JAX helper with both helpers' run_detection handed the
    port's detections of each shot at threshold 0, so that the JAX union
    and native NMS run on what the port's union and NMS run on."""
    jconf, tconf, params, model = small
    c = _shrunk_trees()
    forward = jdana.forward
    monkeypatch.setattr(jdana, 'forward', jax.jit(
        forward, static_argnums=1, static_argnames='training'))
    rng = np.random.default_rng(1)
    sp = rng.integers(0, 255, (64, 64, 3)).astype(np.float32)
    q = rng.integers(0, 255, (100, 140, 3)).astype(np.float32)
    want = cli_utils.run_detection(sp, q, jconf, to_jnp(params), thresh=0.0)
    got = demo.run_detection(sp, q, tconf, model, thresh=0.0, c=c,
                             device='cpu')
    assert got.ndim == 2 and got.shape[1] == 5 and len(got)
    _match_detections(np.asarray(want), got, coord_atol=COORD_ATOL)

    sp_dir = tmp_path / 'sp'
    sp_dir.mkdir()
    shots = [rng.integers(0, 255, (64, 64, 3)).astype(np.uint8)
             for _ in range(2)]
    for i, shot in enumerate(shots):
        _write_shot(sp_dir / f'shot_{i + 1}.jpg', shot)
    qp = tmp_path / 'q.jpg'
    _write_shot(qp, q.astype(np.uint8))
    got = demo.generate_pseudo_label(str(tmp_path / 'out'), str(sp_dir),
                                     str(qp), tconf, model, num_shot=2,
                                     c=c, device='cpu')
    assert got.ndim == 2 and got.shape[1] == 5 and (got[:, 4] >= 0.5).all()

    # each shot's detections at threshold 0, keyed by the pixels each
    # helper reads, so that the unions hold boxes to suppress
    dets = {shot.tobytes(): demo.run_detection(
        shot.astype(np.float32), q, tconf, model, thresh=0.0, c=c,
        device='cpu') for shot in shots}

    def by_pixels(sp_im, *args, **kwargs):
        return dets[np.asarray(sp_im).astype(np.uint8).tobytes()]
    monkeypatch.setattr(demo, 'run_detection', by_pixels)
    monkeypatch.setattr(cli_utils, 'run_detection', by_pixels)
    got = demo.generate_pseudo_label(str(tmp_path / 'out'), str(sp_dir),
                                     str(qp), tconf, model, num_shot=2, c=c)
    want = cli_utils.generate_pseudo_label(str(tmp_path / 'jout'),
                                           str(sp_dir), str(qp), jconf,
                                           params, num_shot=2)
    assert 0 < len(got) < sum(len(d) for d in dets.values())
    np.testing.assert_array_equal(got, want)


def test_create_annotation_matches_jax(tmp_path):
    nd = tmp_path / 'nd'
    nd.mkdir()
    np.save(nd / '000003.npy',
            np.array([[10, 20, 50, 70], [5, 5, 30, 40]], np.float32))
    np.save(nd / '000012.npy', np.array([[1, 2, 9, 9]], np.float32))
    names, inds = ['mug', 'can'], [[3], [12]]
    demo.create_annotation(str(nd), names, inds, str(tmp_path / 'p.json'))
    cli_utils.create_annotation(str(nd), names, inds,
                                str(tmp_path / 'j.json'))
    with open(tmp_path / 'p.json') as f, open(tmp_path / 'j.json') as g:
        got, want = json.load(f), json.load(g)
    assert got == want and got['annotations'][0]['bbox'] == [10, 20, 40, 50]


# ------------------------------------------------ .pth, trunk, HDF5 files

@pytest.fixture(scope='module')
def fgn():
    config, params = tcfg.get_model('fgn', way=2, shot=1, seed=2)
    return config, params, from_jax_params(params, config)


@pytest.mark.parametrize('net', ['DAnA', 'fgn'])
def test_export_dana_state_dict_matches_jax(small, fgn, net):
    """The reference-format state dict of a module equals the JAX
    package's export of its tree (FGN: RCNN_cls_score back in (c, h, w)
    order)."""
    from dana_tpu.utils.torch_import import export_dana_state_dict as jexp
    model = small[3] if net == 'DAnA' else fgn[2]
    got, want = timport.export_dana_state_dict(model), jexp(
        to_jax_params(model))
    assert got.keys() == want.keys()
    assert 'RCNN_top.0.0.bn1.num_batches_tracked' in got
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize('net', ['DAnA', 'fgn'])
def test_reference_pth_round_trips(small, fgn, tmp_path, net):
    """save_reference_pth's file: the JAX package's load_dana_checkpoint
    reads back the module's tree, and the port's read_pth and
    load_reference_state_dict the module itself."""
    from dana_tpu.utils.torch_import import load_dana_checkpoint
    config, model = (small[1], small[3]) if net == 'DAnA' else \
        (fgn[0], fgn[2])
    path = timport.save_reference_pth(str(tmp_path / 'm.pth'), model,
                                      epoch=3, pooling_mode='pool', lr=0.01)
    tree, extra = load_dana_checkpoint(path)
    assert extra == {'epoch': 3, 'optimizer': {}, 'pooling_mode': 'pool',
                     'lr': 0.01}
    want = dict(_leaves(to_jax_params(model)))
    got = dict(_leaves(tree))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    payload = tckpt.read_pth(path)
    assert payload['pooling_mode'] == 'pool' and payload['epoch'] == 3
    back = load_reference_state_dict(payload['model'], config)
    for (ka, va), (kb, vb) in zip(model.state_dict().items(),
                                  back.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka


def test_load_caffe_resnet_matches_jax(small, tmp_path):
    """A trunk-only torch checkpoint (torchvision names, fc and the BN
    counters included) -> the JAX package's tree, and a detector built on
    it holds those trunk weights."""
    from dana_tpu.utils.torch_import import load_caffe_resnet as jload
    _, tconf, params, model = small
    sd = {k[len('backbone.'):]: v
          for k, v in model.state_dict().items() if k.startswith('backbone.')}
    sd.update({'fc.weight': torch.ones(3, 2048), 'fc.bias': torch.ones(3),
               'bn1.num_batches_tracked': torch.tensor(0)})
    path = str(tmp_path / 'resnet50_caffe.pth')
    torch.save(sd, path)
    got, want = timport.load_caffe_resnet(path), jload(path)
    got_l, want_l = dict(_leaves(got)), dict(_leaves(want))
    assert got_l.keys() == want_l.keys() and 'fc' not in got
    for k in want_l:
        np.testing.assert_array_equal(got_l[k], want_l[k], err_msg=k)
    tree = tdana.init_params(tconf, seed=0, backbone_params=got)
    for k, v in dict(_leaves(params['backbone'])).items():
        np.testing.assert_array_equal(dict(_leaves(tree['backbone']))[k], v)


def test_h5_files_cross_both_ways(small, tmp_path):
    """Each package reads the other's HDF5 dump: the same tree, the same
    module."""
    from dana_tpu.utils.checkpoint import load_net_h5 as jload
    from dana_tpu.utils.checkpoint import save_net_h5 as jsave
    _, tconf, params, model = small
    tckpt.save_net_h5(str(tmp_path / 'port' / 'w.h5'), model)
    jsave(str(tmp_path / 'jax.h5'), params)
    want = dict(_leaves(params))
    for tree in (jload(str(tmp_path / 'port' / 'w.h5')),
                 tckpt.load_net_h5(str(tmp_path / 'jax.h5'))):
        got = dict(_leaves(tree))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    back = from_jax_params(tckpt.load_net_h5(str(tmp_path / 'jax.h5')),
                           tconf)
    for (ka, va), (kb, vb) in zip(model.state_dict().items(),
                                  back.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka


# ----------------------------------------------------------------- tool

def test_visualize_attention_tool(tmp_path):
    """The tool on the CPU: a query-sized overlay written as PPM; its jet
    map runs blue -> red as cv2's does."""
    import torch_visualize_attention as tool
    rng = np.random.default_rng(4)
    q = rng.integers(0, 255, (48, 64, 3)).astype(np.uint8)
    s = rng.integers(0, 255, (40, 40, 3)).astype(np.uint8)
    tblob.write_ppm(str(tmp_path / 'q.ppm'), q)
    tblob.write_ppm(str(tmp_path / 's.ppm'), s)
    out = tool.main([str(tmp_path / 'q.ppm'), str(tmp_path / 's.ppm'),
                     str(tmp_path / 'out.ppm'), '--device', 'cpu'])
    assert out.shape == q.shape and out.dtype == np.uint8
    np.testing.assert_array_equal(tblob.read_ppm(str(tmp_path / 'out.ppm')),
                                  out)
    ends = tool.jet(np.array([0.0, 1.0]))
    want = cv2.applyColorMap(np.array([[0], [255]], np.uint8),
                             cv2.COLORMAP_JET)[:, 0]
    assert np.abs(ends.astype(int) - want.astype(int)).max() <= 1
    assert os.path.getsize(tmp_path / 'out.ppm') > q.size
