"""The port's ops against the JAX package on the CPU: boxes, anchors, both
NMS functions, the plain CISA cores, shot-fused and single-group
(against the Pallas kernels in interpret mode and the XLA paths), the
plain RoIAlign, from rois and from precomputed axis weights (against the
XLA float32 path and both Pallas kernels in interpret mode), and the
gradients of the CISA and RoIAlign autograd Functions (against jax.grad).

On the CPU the kernels' wrappers run their plain versions; the kernels
themselves are held to those on the card (tests/test_torch_port_cuda.py,
chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dana_tpu.core import anchors as janchors
from dana_tpu.core import boxes as jboxes
from dana_tpu.ops import cisa_attention as jca
from dana_tpu.ops import nms as jnms
from dana_tpu.ops.roi_align import roi_align as jroi_align
from dana_tpu.ops.roi_align_pallas import (roi_align_pallas,
                                           roi_align_pallas_pw)

from dana_tpu_torch.core import anchors as tanchors
from dana_tpu_torch.core import boxes as tboxes
from dana_tpu_torch.ops import cisa_attention as tca
from dana_tpu_torch.ops import nms as tnms
from dana_tpu_torch.ops import roi_align as troi
from dana_tpu_torch.utils import trace


def _rand_boxes(rng, shape, lo=0.0, span=100.0, size=(5.0, 60.0)):
    xy = rng.random((*shape, 2)) * span + lo
    wh = rng.random((*shape, 2)) * (size[1] - size[0]) + size[0]
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ----------------------------------------------------------------- boxes

def test_boxes_match_jax():
    rng = np.random.default_rng(0)
    a = _rand_boxes(rng, (3, 20))
    b = _rand_boxes(rng, (3, 7))
    deltas = rng.normal(0, 0.5, (3, 20, 8)).astype(np.float32)
    im_hw = np.array([[90.0, 120.0], [60.0, 200.0], [150.0, 80.0]],
                     np.float32)[:, None, :]
    pairs = [
        (jboxes.encode_boxes(a, _rand_boxes(np.random.default_rng(1),
                                            (3, 20))),
         tboxes.encode_boxes(_t(a), _t(_rand_boxes(
             np.random.default_rng(1), (3, 20))))),
        (jboxes.decode_boxes(a, deltas), tboxes.decode_boxes(_t(a),
                                                             _t(deltas))),
        (jboxes.clip_boxes(a, im_hw), tboxes.clip_boxes(_t(a), _t(im_hw))),
        (jboxes.clip_boxes(deltas * 80, im_hw),
         tboxes.clip_boxes(_t(deltas * 80), _t(im_hw))),
        (jboxes.iou_matrix(a, b), tboxes.iou_matrix(_t(a), _t(b))),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-5)


def test_iou_masked_matches_jax():
    rng = np.random.default_rng(2)
    anchors = _rand_boxes(rng, (12,))
    anchors[3] = [5, 5, 5, 5]                   # zero-area anchor -> -1
    gt = np.concatenate([_rand_boxes(rng, (2, 4)),
                         np.ones((2, 4, 1), np.float32)], -1)
    gt[0, 2, :4] = 0                            # padded gt slot -> 0
    want = jboxes.iou_matrix_masked(anchors[None], gt)
    got = tboxes.iou_matrix_masked(_t(anchors[None]), _t(gt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# --------------------------------------------------------------- anchors

@pytest.mark.parametrize('scales', [(8, 16, 32), (4, 8, 16, 32)])
def test_anchors_match_jax(scales):
    want = janchors.generate_anchors(scales=np.array(scales))
    got = tanchors.generate_anchors(scales=np.array(scales))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tanchors.shifted_anchors(5, 7, 16, got).numpy(),
        np.asarray(janchors.shifted_anchors(5, 7, 16, want)))


# ------------------------------------------------------------------- NMS

def _nms_case(name):
    rng = np.random.default_rng(3)
    if name == 'random':
        boxes = _rand_boxes(rng, (150,), span=60.0)
        scores = rng.random(150).astype(np.float32)
        valid = rng.random(150) > 0.2
    elif name == 'ties':
        boxes = _rand_boxes(rng, (120,), span=50.0)
        scores = np.round(rng.random(120), 1).astype(np.float32)
        valid = np.ones(120, bool)
    elif name == 'exact_threshold':
        # IoU([0,0,9,9], [0,0,9,4]) = 50/100 = 0.5 exactly: not > 0.5,
        # so both stay; the third box (IoU 0.6) goes
        boxes = np.array([[0, 0, 9, 9], [0, 0, 9, 4], [0, 0, 9, 5],
                          [40, 40, 50, 50]], np.float32)
        scores = np.array([0.9, 0.8, 0.7, 0.6], np.float32)
        valid = np.ones(4, bool)
    else:                                       # all_invalid
        boxes = _rand_boxes(rng, (30,))
        scores = rng.random(30).astype(np.float32)
        valid = np.zeros(30, bool)
    return boxes, scores, valid


@pytest.mark.parametrize('case', ['random', 'ties', 'exact_threshold',
                                  'all_invalid'])
@pytest.mark.parametrize('tiled', [False, True])
def test_nms_matches_jax(case, tiled):
    boxes, scores, valid = _nms_case(case)
    thr = 0.5
    if tiled:
        # valid=None as the proposal layer calls it; a small tile
        # exercises the cross-tile suppression and the early exit
        v = None if case != 'all_invalid' else valid
        want = jnms.nms_fixed_tiled(jnp.asarray(boxes), jnp.asarray(scores),
                                    thr, 20, None if v is None
                                    else jnp.asarray(v), tile=16)
        got = tnms.nms_fixed_tiled(_t(boxes), _t(scores), thr, 20,
                                   None if v is None else _t(v), tile=16)
    else:
        want = jnms.nms_fixed(jnp.asarray(boxes), jnp.asarray(scores), thr,
                              20, jnp.asarray(valid))
        got = tnms.nms_fixed(_t(boxes), _t(scores), thr, 20, _t(valid))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    if case == 'exact_threshold':
        assert got[0][:3].tolist() == [0, 1, 3]


def test_nms_batched_equals_per_image():
    rng = np.random.default_rng(4)
    boxes = _rand_boxes(rng, (3, 90), span=40.0)
    scores = rng.random((3, 90)).astype(np.float32)
    idx, mask = tnms.nms_fixed_tiled(_t(boxes), _t(scores), 0.7, 25, tile=32)
    for i in range(3):
        one = tnms.nms_fixed_tiled(_t(boxes[i]), _t(scores[i]), 0.7, 25,
                                   tile=32)
        assert torch.equal(idx[i], one[0]) and torch.equal(mask[i], one[1])


# ------------------------------------------------------------------ CISA

def _cisa_inputs(g, s, nq, ns, d, c, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(g, nq, d)).astype(np.float32)
    k = rng.normal(size=(g, s, ns, d)).astype(np.float32)
    v = rng.normal(size=(g, s, ns, c)).astype(np.float32)
    u = rng.normal(size=(g, s, ns))
    u = (np.exp(u) / np.exp(u).sum(-1, keepdims=True)).astype(np.float32)
    return q, k, v, u


@pytest.mark.parametrize('shape', [
    dict(g=2, s=3, nq=70, ns=16, d=32, c=64),      # ragged Nq vs block 32
    dict(g=2, s=3, nq=64, ns=1, d=32, c=48),       # Ns = 1
    dict(g=1, s=2, nq=33, ns=49, d=64, c=96),
], ids=['ragged', 'ns1', 'roi_like'])
def test_cisa_plain_matches_pallas_and_xla(shape):
    q, k, v, u = _cisa_inputs(**shape, seed=shape['nq'])
    scale, gamma = 1.0 / np.sqrt(shape['d']), 0.1
    args = [jnp.asarray(x) for x in (q, k, v, u)]
    xla = np.asarray(jca.cisa_attention_shots_xla(*args, scale, gamma))
    pallas = np.asarray(jca.cisa_attention_shots(*args, scale, gamma, 32))
    plain = tca.cisa_attention_shots_plain(_t(q), _t(k), _t(v), _t(u),
                                           scale, gamma).numpy()
    np.testing.assert_allclose(plain, pallas, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(plain, xla, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize('shape', [
    dict(g=2, nq=70, ns=16, d=32, c=64),           # ragged Nq vs block 32
    dict(g=2, nq=64, ns=1, d=32, c=48),            # Ns = 1
    dict(g=3, nq=33, ns=49, d=64, c=96),
], ids=['ragged', 'ns1', 'roi_like'])
def test_cisa_single_plain_matches_pallas_and_xla(shape):
    q, k, v, u = _cisa_inputs(s=1, **shape, seed=shape['nq'] + 1)
    k, v = k[:, 0], v[:, 0]                        # [G,Ns,D], [G,Ns,C]
    scale, gamma = 1.0 / np.sqrt(shape['d']), 0.1
    args = [jnp.asarray(x) for x in (q, k, v, u)]  # u [G,1,Ns]
    xla = np.asarray(jca.cisa_attention_xla(*args, scale, gamma))
    pallas = np.asarray(jca.cisa_attention(*args, scale, gamma, 32))
    plain = tca.cisa_attention_plain(_t(q), _t(k), _t(v), _t(u), scale,
                                     gamma).numpy()
    np.testing.assert_allclose(plain, pallas, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(plain, xla, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize('single', [False, True], ids=['shots', 'single'])
def test_cisa_function_grads_match_jax(single):
    """The autograd Function (forward: the plain version on the CPU;
    backward: the plain VJP) against jax.grad through the Pallas op's
    custom_vjp, for q, k, v and u, on a ragged Nq."""
    q, k, v, u = _cisa_inputs(2, 1 if single else 3, 37, 20, 16, 24, seed=9)
    if single:
        k, v = k[:, 0], v[:, 0]
    scale, gamma = 0.25, 0.1
    cot = np.random.default_rng(10).normal(
        size=(2, 37, 24)).astype(np.float32)
    jop = jca.cisa_attention if single else jca.cisa_attention_shots
    top = tca.cisa_attention if single else tca.cisa_attention_shots

    def jloss(*xs):
        return jnp.sum(jop(*xs, scale, gamma, 16) * cot)
    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(x) for x in (q, k, v, u)))
    xs = [_t(x).requires_grad_() for x in (q, k, v, u)]
    (top(*xs, scale, gamma) * _t(cot)).sum().backward()
    for name, x, w in zip('qkvu', xs, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5, err_msg=name)


def test_cisa_wrapper_on_cpu_runs_plain():
    q, k, v, u = (_t(x) for x in _cisa_inputs(1, 3, 10, 5, 8, 12, seed=0))
    before = trace.counts()['cisa_shots.float32']
    got = tca.cisa_attention_shots(q, k, v, u, 0.3, 0.1)
    assert torch.equal(got, tca.cisa_attention_shots_plain(q, k, v, u, 0.3,
                                                           0.1))
    assert trace.counts()['cisa_shots.float32'] == before


def test_cisa_single_wrapper_on_cpu_runs_plain():
    q, k, v, u = (_t(x) for x in _cisa_inputs(2, 1, 10, 5, 8, 12, seed=1))
    keys = ('cisa_attention.float32', 'cisa_shots.float32')
    before = [trace.counts()[k] for k in keys]
    got = tca.cisa_attention(q, k[:, 0], v[:, 0], u, 0.3, 0.1)
    assert torch.equal(got, tca.cisa_attention_plain(q, k[:, 0], v[:, 0], u,
                                                     0.3, 0.1))
    assert [trace.counts()[k] for k in keys] == before


# -------------------------------------------------------------- RoIAlign

def _edge_rois():
    """Image-coordinate rois on a 10x12 map at stride 16 (160x192 px):
    in range, leaving the map on each side, tiny, degenerate (x2 < x1),
    and wide enough (> 112 cells) to hit the 16-sample cap."""
    rng = np.random.default_rng(5)
    normal = _rand_boxes(rng, (6,), span=120.0, size=(10.0, 90.0))
    edge = np.array([
        [-40, -30, 60, 50],          # leaves top-left
        [150, 140, 260, 230],        # leaves bottom-right
        [-100, 20, -20, 60],         # entirely left of the map
        [30, 30, 30.4, 30.2],        # tiny
        [80, 80, 60, 50],            # degenerate
        [0, 0, 2000, 1900],          # 125 x 118 cells: capped at 16
        [5.5, 7.25, 159.0, 191.0],   # the whole map
        [16, 16, 16 + 21 * 16, 48],  # extent 21 cells: count exactly 3
    ], np.float32)
    r = np.concatenate([normal, edge])
    return np.stack([r, r[::-1]])    # [2, 14, 4]


@pytest.mark.parametrize('p', [7, 5])
def test_roi_align_plain_matches_jax(p):
    rng = np.random.default_rng(6)
    feat = rng.normal(size=(2, 10, 12, 8)).astype(np.float32)
    rois = _edge_rois()
    rois5 = np.concatenate([np.zeros((2, 14, 1), np.float32), rois], -1)
    plain = troi.roi_align_plain(_t(feat), _t(rois5), p, 1 / 16.0).numpy()
    xla = np.asarray(jroi_align(jnp.asarray(feat), jnp.asarray(rois5), p,
                                1 / 16.0, 0))
    pallas = np.asarray(roi_align_pallas(jnp.asarray(feat),
                                         jnp.asarray(rois), p, 1 / 16.0, 0,
                                         roi_block=4))
    np.testing.assert_allclose(plain, xla, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(plain, pallas, rtol=1e-5, atol=1e-5)


def test_roi_align_sample_cap_binds():
    """The capped roi averages 16 samples per axis, not ceil(125/7)=18."""
    lo, hi = torch.tensor([0.0]), torch.tensor([2000.0 / 16])
    w16 = troi._axis_weights(lo, hi, 12, 7, 16)
    w64 = troi._axis_weights(lo, hi, 12, 7, 64)
    assert not torch.allclose(w16, w64)


def test_roi_align_pw_plain_matches_pallas_pw():
    """The weight-taking form, with the port's own axis weights, against
    the Pallas weight-taking kernel (interpret mode)."""
    rng = np.random.default_rng(11)
    feat = rng.normal(size=(2, 10, 12, 8)).astype(np.float32)
    rois = _edge_rois()
    wy, wx = troi.roi_weights(_t(rois), 10, 12, 7, 1 / 16.0)
    plain = troi.roi_align_pw_plain(_t(feat), wy, wx).numpy()
    pallas = np.asarray(roi_align_pallas_pw(jnp.asarray(feat),
                                            jnp.asarray(rois), 7, 1 / 16.0))
    np.testing.assert_allclose(plain, pallas, rtol=1e-5, atol=1e-5)


def test_roi_align_train_grad_matches_jax():
    """grad_feat of the RoIAlign autograd Function (plain contractions of
    the saved weights) against jax.grad of the JAX float32 roi_align."""
    rng = np.random.default_rng(12)
    feat = rng.normal(size=(2, 10, 12, 8)).astype(np.float32)
    rois = np.concatenate([np.zeros((2, 14, 1), np.float32), _edge_rois()],
                          -1)
    cot = rng.normal(size=(2, 14, 7, 7, 8)).astype(np.float32)
    want = jax.grad(lambda f: jnp.sum(jroi_align(f, jnp.asarray(rois), 7,
                                                 1 / 16.0, 0) * cot))(
        jnp.asarray(feat))
    f = _t(feat).requires_grad_()
    out = troi.roi_align_train(f, _t(rois), 7, 1 / 16.0)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  troi.roi_align_plain(_t(feat),
                                                       _t(rois)).numpy())
    (out * _t(cot)).sum().backward()
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_roi_align_wrapper_on_cpu_runs_plain():
    rng = np.random.default_rng(7)
    feat = _t(rng.normal(size=(2, 6, 7, 4)).astype(np.float32))
    rois = _t(_edge_rois())
    before = trace.counts()['roi_align.float32']
    assert torch.equal(troi.roi_align(feat, rois),
                       troi.roi_align_plain(feat, rois))
    assert trace.counts()['roi_align.float32'] == before


def test_roi_align_pw_wrapper_on_cpu_runs_plain():
    rng = np.random.default_rng(8)
    feat = _t(rng.normal(size=(2, 6, 7, 4)).astype(np.float32))
    wy, wx = troi.roi_weights(_t(_edge_rois()), 6, 7)
    before = trace.counts()['roi_align_pw.float32']
    assert torch.equal(troi.roi_align_pw(feat, wy, wx),
                       troi.roi_align_pw_plain(feat, wy, wx))
    assert trace.counts()['roi_align_pw.float32'] == before
