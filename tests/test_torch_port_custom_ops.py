"""The kernels' registered ops (K1 `dana_torch::cisa_shots`, K2
`dana_torch::roi_align`, NMS `dana_torch::nms_sorted`, the trunk's
epilogue `dana_torch::bn_act`) and int8 serving's
product (`dana_torch::int8_mm`) on the CPU:
`torch.library.opcheck` (schema, fake implementation, autograd
registration, AOT dispatch) in float32 and bf16, and the NMS op's plain
version against the JAX package's `nms_fixed` / `nms_fixed_tiled` on the
cases where exactness is at risk.  The card's side is in
tests/test_torch_port_cuda.py."""

import pathlib
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dana_tpu.ops import nms as jnms

from dana_tpu_torch.ops import bn_act as ba
from dana_tpu_torch.ops import cisa_attention as ca
from dana_tpu_torch.ops import int8_mm
from dana_tpu_torch.ops import nms as tnms
from dana_tpu_torch.ops import roi_align as ra

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def _boxes(rng, b, n, extent=120.0, size=40.0):
    xy = rng.random((b, n, 2)) * extent
    wh = rng.random((b, n, 2)) * size + 1
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize('m, k, n', [(40, 24, 16), (19, 13, 10)])
def test_int8_mm_op_opcheck(m, k, n):
    """The int8 product's op: its fake implementation and schema, and on
    the CPU the exact product (K and N off multiples of 8 included)."""
    rng = np.random.default_rng(m)
    a = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8))
    torch.library.opcheck(int8_mm.int8_mm, (a, b))
    got = int8_mm.int8_matmul(a, b)
    assert got.dtype == torch.int32 and torch.equal(got.long(),
                                                    a.long() @ b.long())
    with pytest.raises(ValueError, match='CPU or CUDA'):
        int8_mm.int8_matmul(a.to('meta'), b.to('meta'))


def test_nms_op_opcheck():
    rng = np.random.default_rng(0)
    sb = torch.from_numpy(_boxes(rng, 2, 100))
    sv = torch.from_numpy(rng.random((2, 100)) > 0.2)
    torch.library.opcheck(tnms.nms_sorted, (sb, sv, 0.7, 20, 64))
    torch.library.opcheck(tnms.nms_sorted, (sb, sv, 0.3, 150, 100))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('single', [False, True], ids=['shots', 'single'])
def test_cisa_op_opcheck(dtype, single):
    g = torch.Generator().manual_seed(1)
    s = 1 if single else 3
    q = torch.randn(2, 10, 16, generator=g)
    k = torch.randn(2, s, 7, 16, generator=g)
    v = torch.randn(2, s, 7, 24, generator=g)
    u = torch.softmax(torch.randn(2, s, 7, generator=g), -1)
    args = tuple(t.to(dtype) for t in (q, k, v, u))
    torch.library.opcheck(ca.cisa_shots_op, (*args, 0.25, 0.1, single))
    out = ca.cisa_shots_op(*args, 0.25, 0.1, single)
    assert out.shape == (2, 10, 24) and out.dtype == dtype


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_bn_act_ops_opcheck(dtype):
    """The epilogue's op with and without a residual and its BN, x
    channels-last and the residual not."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 8, 5, 6, generator=g).to(dtype).contiguous(
        memory_format=torch.channels_last)
    r = torch.randn(2, 8, 5, 6, generator=g).to(dtype)
    s, o = (torch.randn(8, generator=g).to(dtype) for _ in range(2))
    torch.library.opcheck(ba.bn_act_op, (x, s, o, r, s, o))
    torch.library.opcheck(ba.bn_act_op, (x, s, o, r, None, None))
    torch.library.opcheck(ba.bn_act_op, (x, s, o, None, None, None))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_roi_align_op_opcheck(dtype):
    g = torch.Generator().manual_seed(2)
    feat = torch.randn(2, 10, 12, 8, generator=g).to(dtype)
    rois = torch.tensor([[[0, 1., 2., 60., 80.], [0, 10., 20., 100., 150.],
                          [0, -8., -8., 300., 250.]]] * 2)
    torch.library.opcheck(ra.roi_align_op, (feat, rois, 7, 1 / 16, 16))
    out = ra.roi_align(feat, rois)
    assert out.shape == (2, 3, 7, 7, 8) and out.dtype == dtype
    assert torch.equal(out, ra.roi_align_plain(feat, rois))


def test_nms_refuses_other_devices():
    meta = torch.empty(2, 10, 4, device='meta')
    with pytest.raises(ValueError):
        tnms.nms_fixed(meta, torch.empty(2, 10, device='meta'), 0.7, 5)


def _nms_case(name):
    """(boxes [N,4], scores [N], valid [N] or None, threshold, M)."""
    rng = np.random.default_rng(3)
    if name == 'score_ties':
        return (_boxes(rng, 1, 150)[0], np.full(150, 0.5, np.float32),
                None, 0.5, 40)
    if name.startswith('iou_at_'):
        thr = float(name[-3:])
        boxes = chip_smoke.nms_exact_boxes(1, 90, thr, 'cpu')[0].numpy()
        return boxes, np.linspace(1, 0.1, 90).astype(np.float32), None, \
            thr, 90
    if name == 'no_valid':
        return (_boxes(rng, 1, 100)[0], rng.random(100).astype(np.float32),
                np.zeros(100, bool), 0.7, 20)
    if name == 'full_in_64':
        k = np.arange(200)
        corner = np.stack([k % 20, k // 20], -1).astype(np.float32) * 20
        return (np.concatenate([corner, corner + 9], -1),
                rng.random(200).astype(np.float32), None, 0.7, 10)
    assert name == 'ragged_n'              # 201 boxes: tiles of 64 + 9
    boxes = _boxes(rng, 1, 201, extent=60.0)[0]
    return boxes, rng.random(201).astype(np.float32), \
        rng.random(201) > 0.1, 0.6, 60


@pytest.mark.parametrize('tiled', [False, True], ids=['whole', 'tiled'])
@pytest.mark.parametrize('case', ['score_ties', 'iou_at_0.3', 'iou_at_0.7',
                                  'no_valid', 'full_in_64', 'ragged_n'])
def test_nms_op_matches_jax_on_adversarial_cases(case, tiled):
    """The IoU at exactly float32(thr) is kept (a float64 compare would
    suppress it: float32(0.3) lies above 0.3)."""
    boxes, scores, valid, thr, m = _nms_case(case)
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else torch.from_numpy(valid)
    if tiled:
        want = jnms.nms_fixed_tiled(jnp.asarray(boxes), jnp.asarray(scores),
                                    thr, m, jv, tile=64)
        got = tnms.nms_fixed_tiled(torch.from_numpy(boxes),
                                   torch.from_numpy(scores), thr, m, tv,
                                   tile=64)
    else:
        want = jnms.nms_fixed(jnp.asarray(boxes), jnp.asarray(scores), thr,
                              m, jv)
        got = tnms.nms_fixed(torch.from_numpy(boxes),
                             torch.from_numpy(scores), thr, m, tv)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    if case.startswith('iou_at_'):
        # each cell's box at exactly float32(thr) is kept, the one past
        # it suppressed
        assert got[1].sum() == 60
        assert set(got[0][got[1]].numpy() % 3) == {0, 1}
