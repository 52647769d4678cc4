"""The port's four sibling detectors (Faster R-CNN, FSOD, Meta R-CNN, FGN)
and `cisa` against the JAX package on the CPU: the weight draws, both
weight bridges, and the eval forward.

Sizes are tests/test_models_smoke.py's COMMON (ResNet-50 at full width,
128x160 queries, 320 px supports, few proposals), with BN statistics at
Caffe magnitude and no zeroed residual conv (test_torch_port_model.py
`_caffe_like`).  Two queries with their own supports go through each
forward, so FSOD's per-image correlation kernels are told apart.

The forwards are compared at three depths: the RPN's input map (FSOD's
correlation map, FGN's gated map, the plain base features of Meta R-CNN
and Faster R-CNN, cisa's attention map) within 1e-5 of its scale; the
proposals of the free forward within 2e-3 px (ROADMAP "Carried
findings"); and, on the JAX
proposals handed to the port, the heads within 1e-4 and the served
detections tie-aware.  Faster R-CNN has no detections to compare: the JAX
postprocess cannot broadcast its [B, R, 8] deltas against 4 stds.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dana_tpu.engine.postprocess import postprocess_batch as jax_postprocess
from dana_tpu.models import dana as jdana
from dana_tpu.models import frameworks as jfw
from dana_tpu.models.layers import to_jnp
from dana_tpu.utils.torch_import import export_dana_state_dict

from dana_tpu_torch.engine.predict import Predictor
from dana_tpu_torch.models import dana as tdana
from dana_tpu_torch.models import frameworks as tfw
from dana_tpu_torch.models import rpn as trpn
from dana_tpu_torch.utils import config as tcfg
from dana_tpu_torch.utils import weights as tweights
from test_models_smoke import COMMON
from test_torch_port_model import _caffe_like, _leaves, _match_detections

NAMES = ['frcnn', 'fsod', 'meta', 'fgn', 'cisa']
SIBLINGS = ('frcnn', 'fsod', 'meta', 'fgn')
ROI_ATOL = 2e-3       # px: rois through the two float32 forwards
HEAD_TOL = 1e-4



@pytest.fixture(scope='module', autouse=True)
def few_threads():
    """Two intra-op threads for this file's full-width CPU forwards: the
    suite runs several test processes at once, and each one's default of a
    thread per core oversubscribes the cores."""
    was = torch.get_num_threads()
    torch.set_num_threads(min(2, was))
    yield
    torch.set_num_threads(was)

def jax_model(name, seed):
    """-> (JAX config, numpy param tree) of the detector `name`, as the root
    utils.get_model builds it (cisa: DAnA without the BA block)."""
    if name in SIBLINGS:
        return jfw.get_model(name, dict(COMMON, use_pallas_attention=False),
                             seed=seed)
    conf = jdana.DanaConfig(semantic_enhance=False,
                            use_pallas_attention=False, **COMMON)
    return conf, jdana.init_params(conf, seed=seed)


def port_config(name, **kw):
    return tdana.DanaConfig(framework=name, **COMMON, **kw)


@pytest.mark.parametrize('name', NAMES)
def test_init_params_draw_as_jax(name):
    _, want = jax_model(name, seed=5)
    got = tfw.init_params(port_config(name), seed=5)
    want, got = dict(_leaves(want)), dict(_leaves(got))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize('name', NAMES)
def test_get_model_names_the_framework(name):
    conf, params = tcfg.get_model(name, way=2, shot=3, seed=0)
    assert conf.framework == name and conf.arch == 'resnet50'
    assert not conf.semantic_enhance and conf.num_anchors == 9
    assert 'rpn_channel_k_layer' not in params
    assert type(tfw.build(conf)) is {
        'frcnn': tfw.FasterRCNN, 'fsod': tfw.FSOD, 'meta': tfw.MetaRCNN,
        'fgn': tfw.FGN, 'cisa': tdana.DAnA}[name]


def _jax_layout(name, t):
    t = t.numpy()
    return t.transpose(2, 3, 1, 0) if t.ndim == 4 else \
        (t.T if t.ndim == 2 else t)


@pytest.mark.parametrize('name', NAMES)
def test_weight_bridges_round_trip(name):
    """from_jax_params consumes every leaf of the JAX tree and to_jax_params
    gives it back; the JAX package's reference state dict
    (export_dana_state_dict, FGN's linear permuted to (c, h, w) inputs)
    loads into the same module."""
    _, params = jax_model(name, seed=6)
    params = _caffe_like(params, seed=7)
    conf = port_config(name)
    model = tweights.from_jax_params(params, conf)
    flat = dict(_leaves(params))
    state = model.state_dict()
    assert set(state) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(_jax_layout(name, state[k]), v,
                                      err_msg=k)
    back = dict(_leaves(tweights.to_jax_params(model)))
    assert back.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    sd = export_dana_state_dict(params)
    ref = tweights.load_reference_state_dict(
        {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, conf)
    for k, v in model.state_dict().items():
        assert torch.equal(ref.state_dict()[k], v), k
    if name == 'fgn':
        w = sd['RCNN_cls_score.weight']
        assert w.shape == (2, 1152)
        assert not np.array_equal(w, flat['RCNN_cls_score.weight'].T)


# ----------------------------------------------------------- eval forward

def _inputs():
    rng = np.random.default_rng(11)
    q = rng.integers(0, 256, (2, 128, 160, 3)).astype(np.uint8)
    info = np.array([[128, 160, 1.0], [120, 150, 0.9]], np.float32)
    sup = rng.normal(0, 50, (2, COMMON['n_shot'], 320, 320, 3)) \
        .astype(np.float32)
    return q, info, sup


@contextlib.contextmanager
def _record_rpn_input(module, name, record):
    """Record the RPN input map of a forward: the fourth argument of the
    shared middle (`trunk`), or DAnA's attention output (`rpn_attention`)."""
    real = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = real(*args, **kwargs)
        record['corr'] = args[3] if name == 'trunk' else out
        return out
    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def _pinned(rois, mask):
    """The port's proposal layer returns the given proposals."""
    real = trpn.proposal_layer

    def layer(*args, **kwargs):
        real(*args, **kwargs)
        return rois, None, mask
    trpn.proposal_layer = layer
    try:
        yield
    finally:
        trpn.proposal_layer = real


def _jax_eval(name, jconf, params, q, info, sup):
    """The JAX eval forward (jitted), its RPN input map, and the JAX
    postprocess's detections but for Faster R-CNN."""
    def run(p, q, info, sup):
        rec = {}
        with _record_rpn_input(jfw, 'trunk', rec), \
                _record_rpn_input(jdana, 'rpn_attention', rec):
            if name == 'frcnn':
                out = jfw.frcnn_forward(p, jconf, q, info, training=False)
            elif name in SIBLINGS:
                out = jfw.forward_fn(name)(p, jconf, q, info, sup,
                                           training=False)
            else:
                out = jdana.forward(p, jconf, q, info, sup, training=False)
        out = {k: out[k] for k in ('rois', 'roi_mask', 'cls_prob',
                                   'bbox_pred')}
        if name != 'frcnn':
            out['dets'] = jax_postprocess(out['rois'], out['cls_prob'],
                                          out['bbox_pred'], info)
        return out, rec['corr']
    out, corr = jax.jit(run)(to_jnp(params), jnp.asarray(q),
                             jnp.asarray(info), jnp.asarray(sup))
    return jax.tree.map(np.asarray, out), np.asarray(corr)


@pytest.fixture(scope='module', params=NAMES)
def eval_outputs(request):
    name = request.param
    jconf, params = jax_model(name, seed=3)
    params = _caffe_like(params, seed=4)
    q, info, sup = _inputs()
    jout, jcorr = _jax_eval(name, jconf, params, q, info, sup)
    conf = port_config(name)
    model = tweights.from_jax_params(params, conf)
    tq, tinfo, tsup = map(torch.from_numpy, (q, info, sup))
    rec = {}
    with torch.inference_mode():
        with _record_rpn_input(tdana, 'trunk', rec):
            free = tfw.forward(model, conf, tq, tinfo, support_ims=tsup)
        rois, mask = (torch.from_numpy(np.array(jout[k]))
                      for k in ('rois', 'roi_mask'))
        with _pinned(rois, mask):
            pinned = tfw.forward(model, conf, tq, tinfo, support_ims=tsup)
            dets = None
            if name != 'frcnn':
                pred = Predictor(model, conf, device='cpu')
                if pred.caches_supports:
                    for i in range(2):
                        pred.encode_supports(i, sup[i])
                    dets = pred.predict(q, info, [0, 1])
                else:
                    dets = pred.predict(q, info, support_ims=sup)
    return dict(name=name, jout=jout, jcorr=jcorr,
                corr=rec['corr'].numpy(),
                free={k: v.numpy() for k, v in free.items()},
                pinned={k: v.numpy() for k, v in pinned.items()},
                dets=None if dets is None else [x.numpy() for x in dets])


def test_rpn_input_map(eval_outputs):
    """FSOD's correlation map (a 2x4 grid from the 8x10 base map), FGN's
    gated map, Meta R-CNN's and Faster R-CNN's base features, cisa's
    attention map without the BA block: within 1e-5 of the map's
    scale."""
    got, want = eval_outputs['corr'], eval_outputs['jcorr']
    assert got.shape == want.shape
    if eval_outputs['name'] == 'fsod':
        assert got.shape == (2, 2, 4, 1024)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_free_forward_rois(eval_outputs):
    free, jout = eval_outputs['free'], eval_outputs['jout']
    np.testing.assert_array_equal(free['roi_mask'], jout['roi_mask'])
    np.testing.assert_allclose(free['rois'], jout['rois'], rtol=0,
                               atol=ROI_ATOL)


@pytest.mark.parametrize('key', ['cls_prob', 'bbox_pred'])
def test_heads_on_jax_proposals(eval_outputs, key):
    got, want = eval_outputs['pinned'][key], eval_outputs['jout'][key]
    if eval_outputs['name'] == 'frcnn' and key == 'bbox_pred':
        assert got.shape == (2, COMMON['test_post_nms'], 8)
    np.testing.assert_allclose(got, want, rtol=HEAD_TOL, atol=HEAD_TOL)


def test_detections_on_jax_proposals(eval_outputs):
    if eval_outputs['name'] == 'frcnn':
        with pytest.raises(ValueError, match='postprocess'):
            Predictor(None, port_config('frcnn'), device='cpu')
        return
    (jd, jv), (td, tv) = eval_outputs['jout']['dets'], eval_outputs['dets']
    assert td.shape == (2, 100, 5)
    np.testing.assert_array_equal(tv.sum(1), jv.sum(1))
    assert tv.sum() > 0
    for i in range(2):
        _match_detections(jd[i][jv[i]], td[i][tv[i]])
