"""The port's CUDA kernels against their plain PyTorch versions on the card,
and the training step's autograd Functions against autograd of the plain
versions.

The kernels have no CPU mode, so these tests skip without a CUDA device.
On a machine with one (and no JAX), run:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_cuda.py
"""

import pathlib
import sys

import pytest
import torch

from dana_tpu_torch.ops import cisa_attention as ca
from dana_tpu_torch.ops import roi_align as ra

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = 1e-4      # float32 sums in another order than the plain version
# K2 against its plain version and K3: one pooling body, and weights that
# differ only in the order each entry sums its samples
K2_TOL = 1e-6
BUCKETS = [(608, 1024), (1024, 608), (704, 704), (608, 1216), (1216, 608)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels have no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.parametrize('shape', [
    (2, 3, 100, 400, 256, 1024),     # RPN site: 32-row tiles, 128-key chunks
    (2, 3, 77, 1, 256, 1024),        # Ns = 1: 7 padded key columns masked
    (3, 2, 33, 57, 64, 1100),        # ragged Nq, C past one channel chunk
    (1, 1, 16, 2000, 32, 8),         # a large support set: 16-row tiles
    (1, 3, 14700, 49, 256, 1024),    # RoI site: 64-row tiles, ragged Nq
    (3, 2, 77, 57, 256, 1100),       # ragged Nq and Ns, a channel tail
    (1, 3, 40, 2000, 32, 8),         # one shot's tile at a time
])
def test_cisa_kernel_matches_plain(dev, shape):
    g, s, nq, ns, d, c = shape
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(g, nq, d, device=dev, generator=gen)
    k = torch.randn(g, s, ns, d, device=dev, generator=gen)
    v = torch.randn(g, s, ns, c, device=dev, generator=gen)
    u = torch.softmax(torch.randn(g, s, ns, device=dev, generator=gen), -1)
    before = ca.cisa_attention_shots.launches
    got = ca.cisa_attention_shots(q, k, v, u, d ** -0.5, 0.1)
    want = ca.cisa_attention_shots_plain(q, k, v, u, d ** -0.5, 0.1)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    assert ca.cisa_attention_shots.launches == before + 1


def test_cisa_kernel_refuses_too_many_keys(dev):
    q = torch.zeros(1, 4, 256, device=dev)
    k = torch.zeros(1, 1, 20000, 256, device=dev)
    v = torch.zeros(1, 1, 20000, 8, device=dev)
    u = torch.zeros(1, 1, 20000, device=dev)
    with pytest.raises(ValueError, match='shared memory'):
        ca.cisa_attention_shots(q, k, v, u, 1.0, 0.1)
    with pytest.raises(ValueError, match='D % 8'):
        ca.cisa_attention_shots(q[..., :12].contiguous(),
                                k[:, :, :5, :12].contiguous(), v[:, :, :5],
                                u[..., :5], 1.0, 0.1)


def _edge_rois(dev, gen, b=2, n=24):
    edge = torch.tensor([
        [-40, -30, 60, 50], [150, 140, 260, 230], [-100, 20, -20, 60],
        [30, 30, 30.4, 30.2], [80, 80, 60, 50], [0, 0, 2000, 1900],
        [5.5, 7.25, 159.0, 191.0], [16, 16, 16 + 21 * 16, 48]],
        device=dev)
    xy = torch.rand(b, n, 2, device=dev, generator=gen) * 150
    wh = torch.rand(b, n, 2, device=dev, generator=gen) * 90 + 1
    return torch.cat([edge.expand(b, -1, -1),
                      torch.cat([xy, xy + wh], -1)], 1).contiguous()


# rois past the edge cases above, on the 10x12 map (160x192 px): at the
# 16-sample cap and spanning the whole map from outside it on every side,
# and wholly outside the map below and right of it (its output is zero,
# like that of the roi wholly left of the map)
_MORE_ROIS = [[-900, -900, 3000, 3000], [300, 300, 400, 420]]
_OUTSIDE = (2, 33)         # the rois wholly outside the map


def _kernel_rois(dev, gen, cols):
    rois = torch.cat([_edge_rois(dev, gen),
                      torch.tensor(_MORE_ROIS, device=dev).expand(2, -1, -1)],
                     1)
    if cols == 5:          # a leading batch-index column, ignored
        idx = torch.arange(2, device=dev, dtype=torch.float32)
        rois = torch.cat([idx[:, None, None].expand(2, rois.shape[1], 1),
                          rois], -1)
    return rois.contiguous()


@pytest.mark.parametrize('c', [40, 1024])
@pytest.mark.parametrize('cols', [4, 5])
def test_roi_align_kernel_matches_plain(dev, c, cols):
    gen = torch.Generator(device=dev).manual_seed(1)
    feat = torch.randn(2, 10, 12, c, device=dev, generator=gen)
    rois = _kernel_rois(dev, gen, cols)
    for p in (7, 5):
        for max_samples in (16, 64):
            before = ra.roi_align.launches
            got = ra.roi_align(feat, rois, p, max_samples=max_samples)
            torch.testing.assert_close(
                got, ra.roi_align_plain(feat, rois, p,
                                        max_samples=max_samples),
                rtol=K2_TOL, atol=K2_TOL)
            torch.testing.assert_close(
                got, ra.roi_align_pw(feat, *ra.roi_weights(
                    rois, 10, 12, p, max_samples=max_samples)),
                rtol=K2_TOL, atol=K2_TOL)
            assert ra.roi_align.launches == before + 1
            assert not got[:, _OUTSIDE].any()
    with pytest.raises(TypeError):
        ra.roi_align(feat.double(), rois)
    with pytest.raises(ValueError):
        ra.roi_align(feat[:, :, ::2], rois)
    with pytest.raises(ValueError, match='float4'):
        ra.roi_align(feat[..., :6].contiguous(), rois)
    with pytest.raises(ValueError, match='P = 5 and 7'):
        ra.roi_align(feat, rois, 6)


@pytest.mark.parametrize('hw', BUCKETS, ids=lambda hw: f'{hw[0]}x{hw[1]}')
def test_kernels_at_every_query_bucket(dev, hw):
    """K1 at the serving RPN site and K2 at the shapes each query bucket
    gives them (8 queries, 3 shots of 320 px supports, 300 rois).  K1's
    RoI site has the same shape at every bucket (Nq 300 * 49, Ns 49):
    test_cisa_kernel_matches_plain holds it."""
    gen = torch.Generator(device=dev).manual_seed(6)
    fh, fw = hw[0] // 16, hw[1] // 16
    nq, ns = fh * fw, 400
    q = torch.randn(8, nq, 256, device=dev, generator=gen)
    k = torch.randn(8, 3, ns, 256, device=dev, generator=gen)
    v = torch.randn(8, 3, ns, 1024, device=dev, generator=gen)
    u = torch.softmax(torch.randn(8, 3, ns, device=dev, generator=gen), -1)
    torch.testing.assert_close(
        ca.cisa_attention_shots(q, k, v, u, 1 / 16, 0.1),
        ca.cisa_attention_shots_plain(q, k, v, u, 1 / 16, 0.1),
        rtol=TOL, atol=TOL)
    feat = torch.randn(8, fh, fw, 1024, device=dev, generator=gen)
    rois = chip_smoke.serving_rois(8, 300, gen, dev, hw)
    torch.testing.assert_close(ra.roi_align(feat, rois),
                               ra.roi_align_plain(feat, rois),
                               rtol=K2_TOL, atol=K2_TOL)


@pytest.mark.parametrize('c', [40, 1024])
def test_roi_align_pw_kernel_matches_plain(dev, c):
    gen = torch.Generator(device=dev).manual_seed(2)
    feat = torch.randn(2, 10, 12, c, device=dev, generator=gen)
    rois = _kernel_rois(dev, gen, 4)
    for p in (7, 5):
        wy, wx = ra.roi_weights(rois, 10, 12, p)
        before = ra.roi_align_pw.launches
        got = ra.roi_align_pw(feat, wy, wx)
        torch.testing.assert_close(got, ra.roi_align_pw_plain(feat, wy, wx),
                                   rtol=TOL, atol=TOL)
        torch.testing.assert_close(got, ra.roi_align(feat, rois, p),
                                   rtol=TOL, atol=TOL)
        assert ra.roi_align_pw.launches == before + 1
        assert not got[:, _OUTSIDE].any()
    with pytest.raises(ValueError, match='float4'):
        ra.roi_align_pw(feat[..., :6].contiguous(), wy, wx)
    with pytest.raises(TypeError):
        ra.roi_align_pw(feat.double(), wy, wx)


@pytest.mark.parametrize('shape', [
    (2, 100, 400, 256, 1024),
    (2, 77, 1, 256, 1024),           # Ns = 1
    (3, 33, 57, 64, 1100),           # ragged Nq, C past one channel chunk
    (1, 14700, 49, 256, 1024),       # 64-row tiles, ragged Nq
    (1, 16, 2000, 32, 8),            # a large support set: 16-row tiles
])
def test_cisa_single_kernel_matches_plain(dev, shape):
    g, nq, ns, d, c = shape
    gen = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn(g, nq, d, device=dev, generator=gen)
    k = torch.randn(g, ns, d, device=dev, generator=gen)
    v = torch.randn(g, ns, c, device=dev, generator=gen)
    u = torch.softmax(torch.randn(g, 1, ns, device=dev, generator=gen), -1)
    before = ca.cisa_attention.launches, ca.cisa_attention_shots.launches
    got = ca.cisa_attention(q, k, v, u, d ** -0.5, 0.1)
    want = ca.cisa_attention_plain(q, k, v, u, d ** -0.5, 0.1)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    assert (ca.cisa_attention.launches,
            ca.cisa_attention_shots.launches) == (before[0] + 1, before[1])


@pytest.mark.parametrize('single', [False, True], ids=['shots', 'single'])
def test_cisa_function_grads_match_plain_autograd(dev, single):
    gen = torch.Generator(device=dev).manual_seed(4)
    g, s, nq, ns, d, c = 2, 3, 70, 49, 64, 96
    shapes = ([(g, nq, d), (g, ns, d), (g, ns, c), (g, 1, ns)] if single
              else [(g, nq, d), (g, s, ns, d), (g, s, ns, c), (g, s, ns)])
    xs = [torch.randn(*sh, device=dev, generator=gen) for sh in shapes]
    xs[3] = torch.softmax(xs[3], -1)
    cot = torch.randn(g, nq, c, device=dev, generator=gen)
    fn = ca.cisa_attention if single else ca.cisa_attention_shots
    plain = ca.cisa_attention_plain if single \
        else ca.cisa_attention_shots_plain
    grads = []
    for f in (fn, plain):
        leaves = [x.clone().requires_grad_() for x in xs]
        grads.append(torch.autograd.grad(f(*leaves, 0.125, 0.1), leaves,
                                         cot))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)


def test_roi_align_train_grad_matches_plain_autograd(dev):
    gen = torch.Generator(device=dev).manual_seed(5)
    feat = torch.randn(2, 10, 12, 64, device=dev, generator=gen)
    rois = _edge_rois(dev, gen)
    cot = torch.randn(2, rois.shape[1], 7, 7, 64, device=dev, generator=gen)
    before = ra.roi_align_pw.launches
    grads = []
    for f in (ra.roi_align_train, ra.roi_align_plain):
        x = feat.clone().requires_grad_()
        grads.append(torch.autograd.grad(f(x, rois), x, cot)[0])
    torch.testing.assert_close(grads[0], grads[1], rtol=TOL, atol=TOL)
    assert ra.roi_align_pw.launches == before + 1
