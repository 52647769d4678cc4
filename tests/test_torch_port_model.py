"""The port's model against the JAX package on the CPU: the weight bridge,
the ResNet-50 trunk, and the whole eval forward plus postprocess.

Inputs and weights are numpy arrays from a seed, fed to both packages.
BN statistics are Caffe-magnitude (|mean| tens, var up to ~400) and every
residual conv is non-zero, so the numerics are those of a real checkpoint
rather than of a SkipInit identity trunk.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dana_tpu.engine.postprocess import postprocess_batch as jax_postprocess
from dana_tpu.models import dana as jdana
from dana_tpu.models import resnet as jresnet
from dana_tpu.models.layers import to_jnp
from dana_tpu.utils.torch_import import export_dana_state_dict

from dana_tpu_torch.engine.postprocess import postprocess_batch
from dana_tpu_torch.engine.predict import Predictor
from dana_tpu_torch.models import dana as tdana
from dana_tpu_torch.models import resnet as tresnet
from dana_tpu_torch.utils import config as tcfg
from dana_tpu_torch.utils import weights as tweights
from dana_tpu_torch.utils.weights import (from_jax_params,
                                          load_reference_state_dict)

SMALL = dict(n_way=2, n_shot=2, semantic_enhance=True,
             anchor_scales=(8, 16, 32), test_pre_nms=200, test_post_nms=16)


def _caffe_like(tree, seed):
    """Give every BN Caffe-magnitude statistics and every SkipInit-zeroed
    conv3 a He-normal weight (in place; returns the tree)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        for k, v in node.items():
            if not isinstance(v, dict):
                continue
            if 'running_var' in v:
                c = v['running_var'].shape[0]
                v['weight'] = rng.normal(1.0, 0.1, c).astype(np.float32)
                v['bias'] = rng.normal(0.0, 0.1, c).astype(np.float32)
                v['running_mean'] = rng.normal(0.0, 30.0, c).astype(np.float32)
                v['running_var'] = (rng.random(c) * 400 + 1).astype(np.float32)
            elif k == 'conv3' and not v['weight'].any():
                w = v['weight']
                v['weight'] = rng.normal(0.0, np.sqrt(2.0 / w.shape[-1]),
                                         w.shape).astype(np.float32)
            else:
                walk(v)
    walk(tree)
    return tree


def _leaves(tree, prefix=''):
    for k, v in tree.items():
        name = f'{prefix}.{k}' if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, name)
        else:
            yield name, v


@pytest.fixture(scope='module')
def small():
    jconf = jdana.DanaConfig(use_pallas_attention=False, **SMALL)
    tconf = tdana.DanaConfig(**SMALL)
    params = _caffe_like(jdana.init_params(jconf, seed=3), seed=4)
    return jconf, tconf, params, from_jax_params(params, tconf)


def test_init_params_draw_as_jax():
    jconf = jdana.DanaConfig(**SMALL)
    a = dict(_leaves(jdana.init_params(jconf, seed=5)))
    b = dict(_leaves(tdana.init_params(tdana.DanaConfig(**SMALL), seed=5)))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_from_jax_params_consumes_every_leaf(small):
    _, _, params, model = small
    state = model.state_dict()
    names = dict(_leaves(params))
    assert set(state) == set(names)
    for k, v in names.items():
        t = state[k].numpy()
        if v.ndim == 4:
            t = t.transpose(2, 3, 1, 0)
        elif v.ndim == 2:
            t = t.T
        np.testing.assert_array_equal(t, v, err_msg=k)


def test_reference_state_dict_round_trip(small):
    _, tconf, params, model = small
    sd = export_dana_state_dict(params)
    inv = {dst: src for src, dst in tweights._BASE_MAP.items()}
    names = set()
    for key in model.state_dict():
        root = '.'.join(key.split('.')[:2])
        names.add(inv[root] + key[len(root):] if root in inv else key)
    assert names == {k for k in sd if not k.endswith('num_batches_tracked')}
    ref = load_reference_state_dict(
        {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, tconf)
    for (ka, va), (kb, vb) in zip(model.state_dict().items(),
                                  ref.state_dict().items()):
        assert ka == kb
        assert torch.equal(va, vb), ka


@pytest.mark.parametrize('hw', [(64, 96), (70, 90)])
def test_resnet50_base_and_top(small, hw):
    _, _, params, model = small
    rng = np.random.default_rng(hw[0])
    x = rng.normal(0, 50, (2, *hw, 3)).astype(np.float32)
    pj = to_jnp(params['backbone'])
    want = np.asarray(jresnet.base_forward(jnp.asarray(x), pj))
    with torch.inference_mode():
        got = tresnet.base_forward(torch.from_numpy(x), model.backbone)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    r = rng.normal(0, 1, (3, 7, 7, 1024)).astype(np.float32)
    want = np.asarray(jresnet.top_forward(jnp.asarray(r), pj))
    with torch.inference_mode():
        got = tresnet.top_forward(torch.from_numpy(r), model.backbone)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def _match_detections(da, db, coord_atol=1e-4):
    """Tie-aware: same count, same score multiset, and equal boxes for
    every score unique within the image (tests/test_inference_cli.py)."""
    assert da.shape == db.shape
    np.testing.assert_allclose(np.sort(da[:, 4]), np.sort(db[:, 4]),
                               rtol=1e-4, atol=1e-4)
    qa, qb = np.round(da[:, 4], 3), np.round(db[:, 4], 3)
    uniq, cnt = np.unique(qa, return_counts=True)
    for s in uniq[cnt == 1]:
        rb = db[qb == s]
        if len(rb) == 1:
            np.testing.assert_allclose(da[qa == s][:, :4], rb[:, :4],
                                       rtol=1e-4, atol=coord_atol)


@pytest.fixture(scope='module')
def slice_outputs(small):
    jconf, tconf, params, model = small
    rng = np.random.default_rng(0)
    q = rng.integers(0, 256, (2, 128, 160, 3)).astype(np.uint8)
    sup = rng.normal(0, 50, (2, 224, 224, 3)).astype(np.float32)
    info = np.array([[128, 160, 1.0], [120, 150, 0.9]], np.float32)
    pj = to_jnp(params)
    jsup = jdana.extract_support_feats(pj, jconf, jnp.asarray(sup)[None])
    jsup = tuple(jnp.concatenate([f, f]) for f in jsup)
    jo = jdana.forward(pj, jconf, jnp.asarray(q), jnp.asarray(info),
                       training=False, support_feats=jsup)
    jdets = jax_postprocess(jo['rois'], jo['cls_prob'], jo['bbox_pred'],
                            jnp.asarray(info))
    pred = Predictor(model, tconf, device='cpu')
    pred.encode_supports(7, sup)
    with torch.inference_mode():
        to = tdana.forward(pred.model, tconf, torch.from_numpy(q),
                           torch.from_numpy(info),
                           support_feats=pred.batch_support_feats([7, 7]))
    tdets = pred.predict(q, info, [7, 7])
    jo = {k: np.asarray(v) for k, v in jo.items() if v is not None}
    to = {k: v.numpy() for k, v in to.items()}
    return jo, to, [np.asarray(x) for x in jdets], [x.numpy() for x in tdets]


def test_proposal_layer_matches_jax():
    """Identical scores and deltas (with score ties): rois within the
    2e-4 px budget, same kept set."""
    from dana_tpu.core.anchors import generate_anchors, shifted_anchors
    from dana_tpu.models import rpn as jrpn
    from dana_tpu_torch.models import rpn as trpn
    rng = np.random.default_rng(0)
    anchors = np.array(shifted_anchors(
        8, 10, 16, generate_anchors(scales=np.array([8, 16, 32]))))
    n = anchors.shape[0]
    probs = rng.random((2, n)).astype(np.float32)
    probs[:, ::7] = 0.5
    deltas = rng.normal(0, 0.5, (2, n, 4)).astype(np.float32)
    info = np.array([[128, 160, 1.0], [120, 150, 0.9]], np.float32)
    kw = dict(pre_nms_top_n=200, post_nms_top_n=32, nms_thresh=0.7)
    want = jrpn.proposal_layer(jnp.asarray(probs), jnp.asarray(deltas),
                               jnp.asarray(anchors), jnp.asarray(info), **kw)
    got = trpn.proposal_layer(torch.from_numpy(probs),
                              torch.from_numpy(deltas),
                              torch.from_numpy(anchors),
                              torch.from_numpy(info), **kw)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=2e-4)


def test_slice_rois(slice_outputs):
    """Same kept proposals.  The boxes get 2e-3 px, not the 2e-4 px of
    test_proposal_layer_matches_jax: the RPN deltas come out of a full
    ResNet-50 and an 18432-term RPN conv whose float32 sums run in another
    order in each package (about 1e-6 relative), and decoding multiplies
    a delta error by the anchor width (up to 256 px here)."""
    jo, to, _, _ = slice_outputs
    np.testing.assert_array_equal(to['roi_mask'], jo['roi_mask'])
    np.testing.assert_allclose(to['rois'], jo['rois'], rtol=0, atol=2e-3)


@pytest.mark.parametrize('key', ['cls_prob', 'bbox_pred'])
def test_slice_heads(slice_outputs, key):
    jo, to, _, _ = slice_outputs
    np.testing.assert_allclose(to[key], jo[key], rtol=1e-4, atol=1e-4)


def test_slice_detections(slice_outputs):
    _, _, (jd, jv), (td, tv) = slice_outputs
    assert td.shape == (2, 100, 5) and tv.shape == (2, 100)
    np.testing.assert_array_equal(tv.sum(1), jv.sum(1))
    for i in range(2):
        _match_detections(jd[i][jv[i]], td[i][tv[i]])


def test_postprocess_matches_jax():
    rng = np.random.default_rng(9)
    b, r = 2, 40
    xy = rng.random((b, r, 2)) * 100
    wh = rng.random((b, r, 2)) * 60 + 1
    rois = np.concatenate([np.zeros((b, r, 1)), xy, xy + wh], -1)
    prob = rng.random((b, r))
    cls_prob = np.stack([1 - prob, prob], -1).astype(np.float32)
    bbox = rng.normal(0, 1, (b, r, 4)).astype(np.float32)
    info = np.array([[150, 170, 1.5], [160, 120, 0.8]], np.float32)
    rois = rois.astype(np.float32)
    jd, jv = (np.asarray(x) for x in jax_postprocess(
        jnp.asarray(rois), jnp.asarray(cls_prob), jnp.asarray(bbox),
        jnp.asarray(info), max_per_image=10))
    td, tv = (x.numpy() for x in postprocess_batch(
        torch.from_numpy(rois), torch.from_numpy(cls_prob),
        torch.from_numpy(bbox), torch.from_numpy(info), max_per_image=10))
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-4)


def test_get_model_is_the_slice_config():
    conf, params = tcfg.get_model('res50', way=2, shot=3, seed=0)
    assert conf.semantic_enhance and conf.num_anchors == 9
    assert (conf.test_pre_nms, conf.test_post_nms) == (6000, 300)
    assert conf.pooling_size == 7 and conf.arch == 'resnet50'
    assert 'rpn_channel_k_layer' in params
