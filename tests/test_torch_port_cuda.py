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

from dana_tpu_torch.ops import bn_act as ba
from dana_tpu_torch.ops import cisa_attention as ca
from dana_tpu_torch.ops import roi_align as ra
from dana_tpu_torch.utils import trace

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = 1e-4      # float32 sums in another order than the plain version
# K2 against its plain version and K3: one pooling body, and weights that
# differ only in the order each entry sums its samples
K2_TOL = 1e-6
BUCKETS = [(608, 1024), (1024, 608), (704, 704), (608, 1216), (1216, 608)]


def launched(key):
    """The launches counted so far under `key` (utils/trace.py)."""
    return trace.counts()[key]


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
    before = launched('cisa_shots.float32')
    got = ca.cisa_attention_shots(q, k, v, u, d ** -0.5, 0.1)
    want = ca.cisa_attention_shots_plain(q, k, v, u, d ** -0.5, 0.1)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    assert launched('cisa_shots.float32') == before + 1


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
            before = launched('roi_align.float32')
            got = ra.roi_align(feat, rois, p, max_samples=max_samples)
            torch.testing.assert_close(
                got, ra.roi_align_plain(feat, rois, p,
                                        max_samples=max_samples),
                rtol=K2_TOL, atol=K2_TOL)
            torch.testing.assert_close(
                got, ra.roi_align_pw(feat, *ra.roi_weights(
                    rois, 10, 12, p, max_samples=max_samples)),
                rtol=K2_TOL, atol=K2_TOL)
            assert launched('roi_align.float32') == before + 1
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
        before = launched('roi_align_pw.float32')
        got = ra.roi_align_pw(feat, wy, wx)
        torch.testing.assert_close(got, ra.roi_align_pw_plain(feat, wy, wx),
                                   rtol=TOL, atol=TOL)
        torch.testing.assert_close(got, ra.roi_align(feat, rois, p),
                                   rtol=TOL, atol=TOL)
        assert launched('roi_align_pw.float32') == before + 1
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
    before = (launched('cisa_attention.float32'),
              launched('cisa_shots.float32'))
    got = ca.cisa_attention(q, k, v, u, d ** -0.5, 0.1)
    want = ca.cisa_attention_plain(q, k, v, u, d ** -0.5, 0.1)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    assert (launched('cisa_attention.float32'),
            launched('cisa_shots.float32')) == (before[0] + 1, before[1])


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
    before = launched('roi_align_pw.float32')
    grads = []
    for f in (ra.roi_align_train, ra.roi_align_plain):
        x = feat.clone().requires_grad_()
        grads.append(torch.autograd.grad(f(x, rois), x, cot)[0])
    torch.testing.assert_close(grads[0], grads[1], rtol=TOL, atol=TOL)
    assert launched('roi_align_pw.float32') == before + 1


@pytest.mark.parametrize('name', ['frcnn', 'fsod', 'meta', 'fgn', 'cisa'])
def test_framework_paths_match_plain(dev, name):
    """Each detector of models/frameworks.py, and cisa, at chip_smoke.py
    phase 8's shapes: its serving requests (Faster R-CNN: its eval
    forward) and training steps launch K2 once a request and K3 once a
    step (K1 only for cisa), and request 0 and step 0 agree with the
    plain versions on the kernel path's proposals and draws."""
    from dana_tpu_torch.utils import config as cfg
    config, params = cfg.get_model(name, way=2, shot=3, seed=0)
    serving, _ = chip_smoke.framework_serving(name, config, params, 0)
    training, _ = chip_smoke.framework_training(name, config, params, 0)
    assert serving['roi_align_fwd'] == chip_smoke.FW_REQUESTS
    assert training['roi_align_pw'] == chip_smoke.FW_STEPS
    assert (serving['cisa_shots'] > 0) == (name == 'cisa')


@pytest.mark.parametrize('case', ['c512', 'ls'])
def test_kernels_at_the_new_widths(dev, case):
    """K1's serving sites, K2 and K3 on VGG16's 512-channel maps and on
    the --ls canvas (832x1088, 1000 rois an image), and K1's training RPN
    site there (4 episodes), at chip_smoke.py phase 3's shapes."""
    gen = torch.Generator(device=dev).manual_seed(7)
    hw, c, r = ((608, 1024), 512, 300) if case == 'c512' \
        else (chip_smoke.LS_HW, 1024, chip_smoke.LS_POST_NMS)
    fh, fw = hw[0] // 16, hw[1] // 16
    for g, nq, ns in ((8, fh * fw, 400), (8, r * 49, 49), (4, fh * fw, 400)):
        q = torch.randn(g, nq, 256, device=dev, generator=gen)
        k = torch.randn(g, 3, ns, 256, device=dev, generator=gen)
        v = torch.randn(g, 3, ns, c, device=dev, generator=gen)
        u = torch.softmax(torch.randn(g, 3, ns, device=dev, generator=gen),
                          -1)
        torch.testing.assert_close(
            ca.cisa_attention_shots(q, k, v, u, 1 / 16, 0.1),
            ca.cisa_attention_shots_plain(q, k, v, u, 1 / 16, 0.1),
            rtol=TOL, atol=TOL)
        del q, k, v, u
    feat = torch.randn(8, fh, fw, c, device=dev, generator=gen)
    rois = chip_smoke.serving_rois(8, r, gen, dev, hw)
    torch.testing.assert_close(ra.roi_align(feat, rois),
                               ra.roi_align_plain(feat, rois),
                               rtol=K2_TOL, atol=K2_TOL)
    wy, wx = ra.roi_weights(rois[:4, :128], fh, fw, 7)
    torch.testing.assert_close(ra.roi_align_pw(feat[:4], wy, wx),
                               ra.roi_align_pw_plain(feat[:4], wy, wx),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize('label', ['res101', 'vgg16', 'pool', 'crop'])
def test_trunk_and_mode_paths_match_plain(dev, label):
    """chip_smoke.py phase 9's cases: their requests and steps launch K1
    at every attention site, and K2 (serving) or K3 (training) in align
    mode only; request 0 and step 0 agree with the plain versions."""
    _, name, fields, _ = next(c for c in chip_smoke.SLICE9
                              if c[0] == label)
    model = chip_smoke.slice9_model(name, fields, 0)
    serving, _ = chip_smoke.serving_path(0, model, label)
    training, _ = chip_smoke.training_path(0, model, label)
    align = fields.get('pooling_mode', 'align') == 'align'
    assert serving['cisa_shots'] == 2 * chip_smoke.REQUESTS
    assert serving['roi_align_fwd'] == chip_smoke.REQUESTS * align
    assert training['roi_align_pw'] == chip_smoke.STEPS * align


# the bf16 kernels against their plain versions on the same bf16 inputs:
# one bf16 ulp at the output's scale (float32 sums in another order can
# move a value across a rounding boundary)
BF16_ULP = 2.0 ** -7


def _bf16_close(got, want):
    assert got.dtype == want.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs().max().item()
    assert err <= BF16_ULP * want.float().abs().max().item(), err


# (G, S, Nq, Ns, D, C) against the bf16 kernel's tiles: 128 query rows a
# block, 64 keys a tile (one pass at Ns <= 64), 128 x 128 output tiles
@pytest.mark.parametrize('shape', [
    (2, 3, 100, 400, 256, 1024),     # RPN site, Nq below one row tile
    (1, 3, 14700, 49, 256, 1024),    # RoI site: one key tile, ragged Nq
    (2, 3, 300, 400, 256, 512),      # VGG16's channels, ragged Nq
    (2, 3, 77, 1, 256, 1024),        # Ns = 1
    (3, 2, 77, 57, 64, 1096),        # ragged Nq and Ns, a channel tail
    (1, 1, 40, 130, 32, 2048),       # D below one sub-tile, 16 channel tiles
    (1, 1, 200, 49, 256, 1096),      # S = 1, G = 1, Ns = 49
    (1, 3, 129, 400, 256, 1096),     # one row past a tile, G = 1
    (2, 1, 257, 1, 256, 512),        # S = 1, Ns = 1
    (1, 3, 640, 65, 448, 1032),      # the largest D, one key past a tile,
                                     # a v box wholly past C
    (4, 3, 2432, 400, 256, 1024),    # the training step's RPN site
    (4, 3, 6272, 49, 256, 1024),     # its RoI site (twice a step)
])
def test_cisa_bf16_kernel_matches_plain(dev, shape):
    g, s, nq, ns, d, c = shape
    gen = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn(*sh, device=dev, generator=gen).bfloat16()
               for sh in ((g, nq, d), (g, s, ns, d), (g, s, ns, c)))
    u = torch.softmax(torch.randn(g, s, ns, device=dev, generator=gen),
                      -1).bfloat16()
    before = (launched('cisa_shots.float32'),
              launched('cisa_shots.bfloat16'))
    got = ca.cisa_attention_shots(q, k, v, u, d ** -0.5, 0.1)
    _bf16_close(got, ca.cisa_attention_shots_plain(q, k, v, u, d ** -0.5,
                                                   0.1))
    assert (launched('cisa_shots.float32'),
            launched('cisa_shots.bfloat16')) == (before[0],
                                                       before[1] + 1)


@pytest.mark.parametrize('shape', [
    (2, 3, 100, 400, 256, 1024), (1, 3, 14700, 49, 256, 1024),
    (3, 2, 77, 57, 64, 1096), (2, 1, 257, 1, 256, 512)])
def test_cisa_bf16_phases_match_plain(dev, shape):
    """Phase A's P against its plain version (the same bits but where the
    float32 row sums, taken in another order, move a value across a bf16
    rounding boundary: one bf16 ulp of the value), and phase B on that P
    against its plain version (one bf16 ulp at the output's scale)."""
    g, s, nq, ns, d, c = shape
    gen = torch.Generator(device=dev).manual_seed(10)
    q, k, v = (torch.randn(*sh, device=dev, generator=gen).bfloat16()
               for sh in ((g, nq, d), (g, s, ns, d), (g, s, ns, c)))
    u = torch.softmax(torch.randn(g, s, ns, device=dev, generator=gen),
                      -1).bfloat16()
    p = ca.cisa_probs_bf16(q, k, u, d ** -0.5, 0.1)
    want = ca.cisa_probs_bf16_plain(q, k, u, d ** -0.5, 0.1)
    torch.testing.assert_close(p.float(), want.float(), rtol=BF16_ULP,
                               atol=1e-6)
    _bf16_close(ca.cisa_pv_bf16(p, v), ca.cisa_pv_bf16_plain(p, v))


@pytest.mark.parametrize('shape', [
    (2, 100, 400, 256, 1024),        # K4 at the RPN site's widths
    (1, 300, 49, 256, 512),          # one key tile, G = 1, ragged Nq
    (1, 77, 1, 256, 1096),           # Ns = 1, a channel tail
    (8, 2432, 400, 256, 1024),       # chip_smoke.py's K4 shape
])
def test_cisa_single_bf16_kernel_matches_plain(dev, shape):
    g, nq, ns, d, c = shape
    gen = torch.Generator(device=dev).manual_seed(8)
    q, k, v = (torch.randn(*sh, device=dev, generator=gen).bfloat16()
               for sh in ((g, nq, d), (g, ns, d), (g, ns, c)))
    u = torch.softmax(torch.randn(g, 1, ns, device=dev, generator=gen),
                      -1).bfloat16()
    before = launched('cisa_attention.bfloat16')
    _bf16_close(ca.cisa_attention(q, k, v, u, 1 / 16, 0.1),
                ca.cisa_attention_plain(q, k, v, u, 1 / 16, 0.1))
    assert launched('cisa_attention.bfloat16') == before + 1
    with pytest.raises(TypeError, match='one dtype'):
        ca.cisa_attention(q.float(), k, v, u, 1 / 16, 0.1)
    with pytest.raises(ValueError, match='D % 16'):
        ca.cisa_attention(q[..., :8].contiguous(), k[..., :8].contiguous(),
                          v, u, 1 / 16, 0.1)
    with pytest.raises(ValueError, match='shared memory'):
        ca.cisa_attention(torch.zeros(g, nq, 512, device=dev).bfloat16(),
                          torch.zeros(g, ns, 512, device=dev).bfloat16(),
                          v, u, 1 / 16, 0.1)


def _roi_align_bf16_case(feat, rois, p, max_samples=16, outside=()):
    """K2-bf16 against its plain version, one bf16 launch, zero rows for
    the rois wholly outside the map."""
    before = launched('roi_align.float32'), launched('roi_align.bfloat16')
    got = ra.roi_align(feat, rois, p, max_samples=max_samples)
    _bf16_close(got, ra.roi_align_plain(feat, rois, p,
                                        max_samples=max_samples))
    assert (launched('roi_align.float32'),
            launched('roi_align.bfloat16')) == (before[0], before[1] + 1)
    assert not got[:, list(outside)].any()


@pytest.mark.parametrize('max_samples', [16, 64])
@pytest.mark.parametrize('c', [40, 512, 1024])
def test_roi_align_bf16_kernel_matches_plain(dev, c, max_samples):
    """On the 10x12 map: the edge rois (outside, 1x1, degenerate, past the
    map on every side, at the sample cap), C past one 256-channel slice or
    below one warpgroup's 128 (C = 40 loads a 64-channel box at a time,
    512 and 1024 a chunk's four at once), P 7 and 5 (25 of the 64 tile
    rows)."""
    gen = torch.Generator(device=dev).manual_seed(9)
    feat = torch.randn(2, 10, 12, c, device=dev, generator=gen).bfloat16()
    rois = _kernel_rois(dev, gen, 5).bfloat16()     # as the model rounds
    for p in (7, 5):
        _roi_align_bf16_case(feat, rois, p, max_samples, _OUTSIDE)
    with pytest.raises(ValueError, match='16-byte groups'):
        ra.roi_align(feat[..., :12].contiguous(), rois)


# at the first query bucket's 38x64 map: the whole map (T = 38 x 64 = 2,432
# taps, 38 slots of 64), larger than the map from its corner and from
# outside it (samples skip cells at the cap), a 1x1 roi, rois wholly
# outside left of and below-right of the map
_SERVING_EDGE = [[0, 0, 1023, 607], [0, 0, 3000, 2500],
                 [-900, -900, 3000, 3000], [30, 30, 30.4, 30.2],
                 [-300, 20, -20, 60], [1100, 700, 1300, 900]]
_SERVING_OUTSIDE = (4, 5)


@pytest.mark.parametrize('case', [f'{h}x{w}' for h, w in BUCKETS]
                         + ['ls', 'whole_map'])
def test_roi_align_bf16_at_serving_shapes(dev, case):
    """K2-bf16 at chip_smoke.py phase 3's shapes: 8 maps of 1024 channels
    at every query bucket with 300 proposal-like rois an image, and on the
    --ls canvas with 1000; then the whole-map and larger-than-map rois at
    the first bucket for P 7 and 5 and max_samples 16 and 64."""
    gen = torch.Generator(device=dev).manual_seed(11)
    if case == 'whole_map':
        feat = torch.randn(2, 38, 64, 1024, device=dev,
                           generator=gen).bfloat16()
        rois = torch.cat([torch.tensor(_SERVING_EDGE, device=dev).expand(
            2, -1, -1), _edge_rois(dev, gen)], 1).contiguous().bfloat16()
        for p in (7, 5):
            for max_samples in (16, 64):
                _roi_align_bf16_case(feat, rois, p, max_samples,
                                     _SERVING_OUTSIDE)
        return
    hw, r = ((chip_smoke.LS_HW, chip_smoke.LS_POST_NMS) if case == 'ls'
             else (tuple(map(int, case.split('x'))), 300))
    feat = torch.randn(8, hw[0] // 16, hw[1] // 16, 1024, device=dev,
                       generator=gen).bfloat16()
    rois = chip_smoke.serving_rois(8, r, gen, dev, hw).bfloat16()
    _roi_align_bf16_case(feat, rois, 7)


def test_roi_align_bf16_at_training_shapes(dev):
    """K2-bf16 at the bf16 training step's shapes (chip_smoke.py phase 3):
    4 maps of 38x64x1024 and 128 rois an image drawn like the sampler's,
    one over the whole map, for P 7 and 5."""
    gen = torch.Generator(device=dev).manual_seed(12)
    feat = torch.randn(4, 38, 64, 1024, device=dev, generator=gen).bfloat16()
    rois = chip_smoke.training_rois(4, 128, gen, dev).bfloat16()
    for p in (7, 5):
        _roi_align_bf16_case(feat, rois, p)


def test_roi_align_train_bf16_grad_matches_plain_autograd(dev):
    """The training RoIAlign on a bf16 map: its forward launches K2-bf16
    (not K3), and its backward (`roi_align_combine_backward`, one bf16
    product with float32 accumulation) is autograd's of the plain combine
    path (float32 sums, one rounding) within one bf16 ulp, at the training
    step's shapes and on the edge rois."""
    gen = torch.Generator(device=dev).manual_seed(13)
    cases = [(torch.randn(4, 38, 64, 1024, device=dev, generator=gen),
              chip_smoke.training_rois(4, 128, gen, dev)),
             (torch.randn(2, 10, 12, 64, device=dev, generator=gen),
              _edge_rois(dev, gen))]
    for feat, rois in cases:
        feat, rois = feat.bfloat16(), rois.bfloat16()
        cot = torch.randn(*rois.shape[:2], 7, 7, feat.shape[-1], device=dev,
                          generator=gen).bfloat16()
        before = (launched('roi_align_pw.float32'),
                  launched('roi_align.bfloat16'))
        grads = []
        for f in (ra.roi_align_train, ra.roi_align_plain):
            x = feat.clone().requires_grad_()
            out = f(x, rois)
            grads.append(torch.autograd.grad(out, x, cot)[0])
            assert out.dtype == torch.bfloat16
        _bf16_close(grads[0], grads[1])
        assert (launched('roi_align_pw.float32'),
                launched('roi_align.bfloat16')) == (before[0], before[1] + 1)


@pytest.mark.parametrize('recipe', ['default_recipe', 'pure_bf16'])
def test_recipe_training_step_launches(dev, recipe):
    """One Trainer.step of chip_smoke.py phase 11's detector in the recipe:
    3 bf16 K1, 1 bf16 K2 and 1 NMS launches and no float32 kernel, and
    step 0 agrees with the plain versions (chip_smoke.py's bf16
    tolerances)."""
    from dana_tpu_torch.utils import config as cfg
    config, params = cfg.get_model('res50', way=2, shot=3, seed=0)
    model = (chip_smoke._recipe(config, recipe), params)
    launches, _ = chip_smoke.training_path(0, model, recipe, steps=1)
    assert launches == chip_smoke.launch_counts(cisa_shots_bf16=3,
                                                roi_align_fwd_bf16=1, nms=1)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('shot', chip_smoke.MULTIWAY_SHOTS)
@pytest.mark.parametrize('site', ['rpn', 'roi'])
def test_cisa_kernels_at_the_multiway_shots(dev, site, shot, dtype):
    """K1 and K1-bf16 at the serving sites of the N-way evaluation's shot
    counts (chip_smoke.py's BATCH groups; the RoI site keeps all S shots'
    scores resident in float32, the bf16 scratch P is [G, Nq, S, Nsp]):
    within TOL (float32) or one bf16 ulp of the plain version, one launch
    of the dtype's kernel."""
    nq, ns = {'rpn': (38 * 64, 400), 'roi': (300 * 49, 49)}[site]
    g, d, c = chip_smoke.BATCH, 256, 1024
    gen = torch.Generator(device=dev).manual_seed(shot)
    q, k, v = (torch.randn(*sh, device=dev, generator=gen).to(dtype)
               for sh in ((g, nq, d), (g, shot, ns, d), (g, shot, ns, c)))
    u = torch.softmax(torch.randn(g, shot, ns, device=dev, generator=gen),
                      -1).to(dtype)
    key = f'cisa_shots.{str(dtype)[6:]}'
    before = launched(key)
    got = ca.cisa_attention_shots(q, k, v, u, 1 / 16, 0.1)
    want = ca.cisa_attention_shots_plain(q, k, v, u, 1 / 16, 0.1)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    else:
        _bf16_close(got, want)
    assert launched(key) == before + 1


def _held(got, want):
    if got.dtype == torch.bfloat16:
        chip_smoke.check_bf16('kernel', got, want)
    else:
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


def test_kernels_launch_on_every_card(dev):
    """K1, K2 and K3 (and the bf16 forms) launched on each card present
    (cuda:1 too when there is one) from one process: each wrapper enters
    its tensors' device and stream, and counts the launch under that
    device."""
    for i in range(torch.cuda.device_count()):
        d = torch.device('cuda', i)
        gen = torch.Generator(device=d).manual_seed(i)
        for dt in (torch.float32, torch.bfloat16):
            q = torch.randn(2, 100, 256, device=d, generator=gen).to(dt)
            k = torch.randn(2, 3, 57, 256, device=d, generator=gen).to(dt)
            v = torch.randn(2, 3, 57, 1024, device=d, generator=gen).to(dt)
            u = torch.softmax(torch.randn(2, 3, 57, device=d, generator=gen),
                              -1).to(dt)
            key = f'{str(dt)[6:]}@{d}'
            before = launched(f'cisa_shots.{key}')
            got = ca.cisa_attention_shots(q, k, v, u, 0.0625, 0.1)
            want = ca.cisa_attention_shots_plain(q, k, v, u, 0.0625, 0.1)
            _held(got, want)
            assert launched(f'cisa_shots.{key}') == before + 1
            feat = torch.randn(2, 38, 64, 1024, device=d,
                               generator=gen).to(dt)
            rois = chip_smoke.serving_rois(2, 40, gen, d)
            before = launched(f'roi_align.{key}')
            got = ra.roi_align(feat, rois.to(dt), 7, 1 / 16)
            want = ra.roi_align_plain(feat, rois.to(dt), 7, 1 / 16)
            _held(got, want)
            assert launched(f'roi_align.{key}') == before + 1
        wy, wx = ra.roi_weights(rois, 38, 64, 7, 1 / 16)
        feat = feat.float()
        before = launched(f'roi_align_pw.float32@{d}')
        torch.testing.assert_close(ra.roi_align_pw(feat, wy, wx),
                                   ra.roi_align_pw_plain(feat, wy, wx),
                                   rtol=TOL, atol=TOL)
        assert launched(f'roi_align_pw.float32@{d}') == before + 1


# (kernel, cin, cout, stride, padding, rows, map): layer4's conv2, its
# strided first conv1, the stem (K = 147 padded to 152) and a channel count
# that is no multiple of 8
INT8_CONVS = {'layer4_conv2': (3, 512, 512, 1, 1, 300, 4),
              'layer4_conv1_s2': (1, 1024, 512, 2, 0, 300, 7),
              'stem': (7, 3, 64, 2, 3, 2, 96),
              'ragged': (3, 20, 44, 1, 1, 5, 9)}


@pytest.mark.parametrize('case', INT8_CONVS)
def test_int8_conv_int_mm_matches_plain(dev, case):
    """The int8 conv's `torch._int_mm` route (NHWC patches, padded operands)
    against the exact float64 conv: the int32 accumulators bit for bit, and
    the whole int8 conv the same."""
    from dana_tpu_torch.models import layers as L
    kh, cin, cout, stride, pad, n, hw = INT8_CONVS[case]
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(n, hw, hw, cin, device=dev, generator=gen) \
        .permute(0, 3, 1, 2)
    w = torch.randint(-127, 128, (cout, cin, kh, kh), device=dev,
                      dtype=torch.int8, generator=gen)
    xq, sx = L.quantize_activation(x)
    before = launched('int8_matmul.int8')
    got = L.int8_conv_acc(xq, w, stride, pad)
    assert launched('int8_matmul.int8') == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, L.int8_conv_acc_plain(xq, w, stride, pad))
    scale = torch.rand(cout, device=dev, generator=gen) / 127
    bias = torch.randn(cout, device=dev, generator=gen)
    y = L.dynamic_int8_conv(x, w, scale, bias, stride, pad)
    want = (L.int8_conv_acc_plain(xq, w, stride, pad).float()
            * (sx * scale) + bias)
    assert torch.equal(L.nchw_to_nhwc(y), want)


def test_int8_roi_align_int_mm_matches_plain(dev):
    """The int8 RoIAlign's per-image `torch._int_mm` products against the
    exact float64 ones, at a serving bucket's bf16 map (2 images, 300
    rois)."""
    from dana_tpu_torch.models import layers as L
    gen = torch.Generator(device=dev).manual_seed(1)
    feat = torch.randn(2, 38, 64, 1024, device=dev,
                       generator=gen).to(torch.bfloat16)
    rois = chip_smoke.serving_rois(2, 300, gen, dev)
    before = launched('int8_matmul.int8')
    got = ra.roi_align_int8(feat, rois)
    assert launched('int8_matmul.int8') == before + 2
    saved = L.int8_matmul
    L.int8_matmul = L.int8_matmul_plain
    try:
        want = ra.roi_align_int8(feat, rois)
    finally:
        L.int8_matmul = saved
    assert torch.equal(got, want)


def test_int8_matmul_refuses_short_products(dev):
    from dana_tpu_torch.models import layers as L
    a = torch.ones(16, 8, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match='more than 16 rows'):
        L.int8_matmul(a, a.t())


@pytest.mark.parametrize('m, k, n', [(38400, 4608, 512), (4800, 147, 64),
                                     (300, 13, 10)])
def test_int8_mm_op_on_the_card_is_exact(dev, m, k, n):
    """`dana_torch::int8_mm` on the card (`torch._int_mm`, operands padded
    to multiples of 8) equals the exact float64 product, counts one launch
    on its device, and passes opcheck."""
    from dana_tpu_torch.ops import int8_mm
    gen = torch.Generator(device=dev).manual_seed(m)
    a = torch.randint(-127, 128, (m, k), device=dev, dtype=torch.int8,
                      generator=gen)
    b = torch.randint(-127, 128, (k, n), device=dev, dtype=torch.int8,
                      generator=gen)
    key = f'int8_matmul.int8@{a.device}'
    before, by_dev = launched('int8_matmul.int8'), launched(key)
    got = int8_mm.int8_matmul(a, b)
    assert launched('int8_matmul.int8') == before + 1
    assert launched(key) == by_dev + 1
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, int8_mm.int8_matmul_plain(a, b))
    if m < 10000:
        torch.library.opcheck(int8_mm.int8_mm, (a, b))


def test_int8_request_on_data_rows_matches_one_device(dev):
    """An int8 ('all') detector on cuda:0 named twice (two data rows, one
    thread each, one activation scale) against the one-device request, on
    queries of which one is 8x the others, both on the one-device
    request's proposals (K1's and cuDNN's last bits reorder near-equal RPN
    scores, ROADMAP C1): RPN outputs and heads at TOL, detections
    tie-aware at BOX_ATOL (chip_smoke.py `compare_grid`, phase 4's
    tolerances); each row launches K1, K2 and the int8 products."""
    from dana_tpu_torch import quant
    from dana_tpu_torch.engine.predict import Predictor
    from dana_tpu_torch.models import dana
    from dana_tpu_torch.models import layers as L
    config = dana.DanaConfig(n_way=2, n_shot=1, test_pre_nms=300,
                             test_post_nms=50, roi_align_int8=True)
    tree = quant.quantize_params(dana.init_params(config, seed=0), 'all')
    gen = torch.Generator(device=dev).manual_seed(5)
    sup = (torch.randn(1, 224, 224, 3, device=dev, generator=gen) * 50)
    im = torch.randn(4, 256, 320, 3, device=dev, generator=gen) * 40
    im[2] *= 8
    info = torch.tensor([[256.0, 320.0, 1.0]] * 4, device=dev)
    one, rows = Predictor(tree, config), Predictor(tree, config,
                                                   devices=[dev, dev])
    for p in (one, rows):
        p.encode_supports(1, sup.cpu().numpy())
    before = (launched('cisa_shots.float32'), launched('roi_align.float32'),
              launched('int8_matmul.int8'))
    rows.forward(im, info, [1] * 4)
    assert (launched('cisa_shots.float32') - before[0],
            launched('roi_align.float32') - before[1],
            launched('int8_matmul.int8') - before[2]) == (4, 2, 2 * 53)
    diffs = chip_smoke.compare_grid(rows, one, im, info, [1] * 4,
                                    label='int8 rows')
    assert max(diffs.values()) <= TOL


# the NMS sites of the main paths: (B, N, M, IoU threshold)
NMS_SHAPES = {'serving': (8, 6000, 300, 0.7),
              'postprocess': (8, 300, 100, 0.3),
              'training': (4, 12000, 2000, 0.7)}


def _rpn_like_boxes(b, n, gen, d):
    """Score-sorted proposal-like boxes on a 608x1024 canvas: many
    overlapping clusters, so suppression chains run deep."""
    ctr = torch.rand(b, n, 2, device=d, generator=gen) * torch.tensor(
        [1024.0, 608.0], device=d)
    ctr = torch.round(ctr / 64) * 64 + torch.randn(
        b, n, 2, device=d, generator=gen) * 6
    wh = torch.exp(torch.rand(b, n, 2, device=d, generator=gen) * 3) * 16
    return torch.cat([ctr - wh / 2, ctr + wh / 2], -1).contiguous()


@pytest.mark.parametrize('site', NMS_SHAPES)
def test_nms_kernel_matches_plain(dev, site):
    """The NMS kernel against its plain version at the main paths' shapes,
    on proposal-like boxes and on chip_smoke.py's adversarial cases:
    positions and masks equal, one launch counted per call."""
    from dana_tpu_torch.ops import nms
    b, n, m, thr = NMS_SHAPES[site]
    gen = torch.Generator(device=dev).manual_seed(n)
    sb = _rpn_like_boxes(b, n, gen, dev)
    sv = torch.rand(b, n, device=dev, generator=gen) > (
        0.3 if site == 'postprocess' else 0.0)
    cases = {'site': (sb, sv, m), **chip_smoke.nms_cases(sb, sv, thr, m)}
    for name, (b_, v_, m_) in cases.items():
        before = launched('nms.float32')
        got = nms.nms_sorted(b_, v_, thr, m_, 512)
        assert launched('nms.float32') == before + 1
        want = nms.nms_sorted_plain(b_, v_, thr, m_, 512)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
            name
    assert got[0].dtype == torch.int64 and got[1].dtype == torch.bool


def test_custom_ops_opcheck_on_the_card(dev):
    from dana_tpu_torch.ops import nms
    gen = torch.Generator(device=dev).manual_seed(3)
    sb = _rpn_like_boxes(2, 300, gen, dev)
    sv = torch.rand(2, 300, device=dev, generator=gen) > 0.2
    torch.library.opcheck(nms.nms_sorted, (sb, sv, 0.7, 50, 512))
    for dt in (torch.float32, torch.bfloat16):
        q = torch.randn(2, 100, 256, device=dev, generator=gen).to(dt)
        k = torch.randn(2, 3, 57, 256, device=dev, generator=gen).to(dt)
        v = torch.randn(2, 3, 57, 1024, device=dev, generator=gen).to(dt)
        u = torch.softmax(torch.randn(2, 3, 57, device=dev, generator=gen),
                          -1).to(dt)
        torch.library.opcheck(ca.cisa_shots_op, (q, k, v, u, 0.0625, 0.1,
                                                 False))
        feat = torch.randn(2, 38, 64, 1024, device=dev, generator=gen).to(dt)
        rois = chip_smoke.serving_rois(2, 40, gen, dev)
        torch.library.opcheck(ra.roi_align_op, (feat, rois, 7, 1 / 16, 16))
        x = torch.randn(2, 64, 9, 10, device=dev, generator=gen).to(dt)
        s, o = (torch.randn(64, device=dev, generator=gen).to(dt)
                for _ in range(2))
        x = x.contiguous(memory_format=torch.channels_last)
        torch.library.opcheck(ba.bn_act_op, (x, s, o, x.flip(0), s, o))
        torch.library.opcheck(ba.bn_act_op, (x, s, o, None, None, None))


def test_export_round_trip_on_the_card(dev, tmp_path):
    """A tiny DAnA exported on the card (dana_tpu_torch/serve.py) launches
    K1, K2 and NMS from the artifact, and equals the live model bit for
    bit."""
    from dana_tpu_torch import serve
    from dana_tpu_torch.engine.postprocess import postprocess_batch
    from dana_tpu_torch.models import dana
    from dana_tpu_torch.utils.weights import from_jax_params
    config = dana.DanaConfig(n_way=2, n_shot=1, test_pre_nms=300,
                             test_post_nms=50)
    model = from_jax_params(dana.init_params(config, seed=0), config).to(dev)
    out = str(tmp_path / 'artifact')
    serve.export_predictor(model, config, out, buckets=((256, 320),),
                           batch_size=2, sup_size=224, device=dev)
    pred = serve.load(out)
    assert pred.device.type == 'cuda'
    gen = torch.Generator(device=dev).manual_seed(4)
    sup = torch.randn(1, 2, 224, 224, 3, device=dev, generator=gen) * 50
    im = torch.randn(2, 256, 320, 3, device=dev, generator=gen) * 40
    info = torch.tensor([[256.0, 320.0, 1.0]] * 2, device=dev)
    params = model.state_dict()
    counters = ('cisa_shots.float32', 'roi_align.float32', 'nms.float32')
    before = [launched(c) for c in counters]
    feats = pred.encode(params, sup)
    rows = tuple(torch.cat([f, f]) for f in feats)
    got = pred(params, im, info, *rows)
    assert [launched(c) - b for c, b in zip(counters, before)] == [2, 1, 2]
    with torch.inference_mode():
        live = dana.extract_support_feats(model, config, sup)
        o = dana.forward(model, config, im, info, support_feats=rows)
        want = postprocess_batch(o['rois'], o['cls_prob'], o['bbox_pred'],
                                 info)
    assert all(torch.equal(a, b) for a, b in zip(feats, live))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# (shape [N, C, H, W], channels last, residual: None / 'identity' / 'bn'):
# the trunk's epilogues at the cells' shapes (layer1 of a request of
# 8, the stem, layer3's last conv with its downsample, layer4 on 2400 rois)
# on the vector path, and the strided path (C off the 16-byte vector, or
# NCHW memory)
BN_ACT_CASES = {
    'layer1': ((8, 256, 152, 256), True, 'identity'),
    'stem': ((8, 64, 304, 512), True, None),
    'layer3_down': ((8, 1024, 38, 64), True, 'bn'),
    'layer4': ((2400, 2048, 4, 4), True, 'bn'),
    'odd_c': ((3, 37, 9, 11), True, 'bn'),
    'nchw': ((4, 64, 20, 24), False, 'identity'),
}


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('case', BN_ACT_CASES)
def test_bn_act_kernel_bit_equal_to_plain(dev, case, dtype):
    """The epilogue's kernel and its backward against the plain chain of
    PyTorch ops on the card (autograd's gradients for the backward), bit
    for bit, NaN and infinities included; one launch each."""
    shape, last, residual = BN_ACT_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(len(case))
    fmt = torch.channels_last if last else torch.contiguous_format

    def rand(*size):
        return torch.randn(size, device=dev, generator=gen).to(dtype)

    x0, r0, g = (rand(*shape).contiguous(memory_format=fmt)
                 for _ in range(3))
    x0[0, 0, 0, :3] = torch.tensor([float('nan'), float('inf'), -0.0])
    c = shape[1]
    s, o, sr, orr = rand(c) + 1, rand(c), rand(c) + 1, rand(c)
    rbn = (sr, orr) if residual == 'bn' else (None, None)
    keys = [f'{op}.{str(dtype)[6:]}' for op in ('bn_act', 'bn_act_backward')]
    outs = []
    for fn in (ba.bn_act_plain, ba.bn_act):
        x = x0.clone().requires_grad_()
        r = None if residual is None else r0.clone().requires_grad_()
        before = [launched(k) for k in keys]
        y = fn(x, s, o, r, *rbn)
        y.backward(g)
        assert [launched(k) - b for k, b in zip(keys, before)] == \
            ([1, 1] if fn is ba.bn_act else [0, 0])
        outs.append((y.detach(), x.grad, None if r is None else r.grad))
        del x, r, y
    for want, got in zip(*outs):
        if want is not None:
            assert got.stride() == want.stride()
            assert torch.equal(_bits(got), _bits(want))
    with torch.no_grad():
        r = None if residual is None else r0
        served = ba.bn_act(x0, s, o, r, *rbn)
        exported = ba.bn_act_op(x0, s, o, r, *rbn)
    assert torch.equal(_bits(served), _bits(outs[0][0]))
    assert torch.equal(_bits(exported), _bits(outs[0][0]))


@pytest.mark.parametrize('down', [True, False], ids=['down', 'identity'])
def test_bn_act_bottleneck_bit_equal_on_the_card(dev, down):
    """A float32 bottleneck on the card, channels last, against its forward
    before the epilogue: the output and the gradients of its input and of
    every conv weight bit for bit (cuDNN deterministic, TF32 off)."""
    import torch.nn.functional as F
    from dana_tpu_torch.models import layers as L
    from dana_tpu_torch.models import resnet

    def present(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)

    gen = torch.Generator(device=dev).manual_seed(5)
    block = resnet.Bottleneck(512 if down else 1024, 256, 2 if down else 1)
    block = block.to(dev)
    with torch.no_grad():
        for m in block.modules():
            if isinstance(m, L.FrozenBatchNorm2d):
                c = m.weight.numel()
                m.weight.copy_(torch.rand(c, device=dev, generator=gen) + .5)
                m.bias.copy_(torch.randn(c, device=dev, generator=gen))
                m.running_mean.copy_(torch.randn(c, device=dev,
                                                 generator=gen))
                m.running_var.copy_(torch.rand(c, device=dev,
                                               generator=gen) + .1)
            elif isinstance(m, L.Conv2d):
                m.weight.copy_(torch.randn(m.weight.shape, device=dev,
                                           generator=gen) * 0.03)
    x0 = torch.randn(4, block.conv1.in_channels, 38, 64, device=dev,
                     generator=gen).contiguous(
                         memory_format=torch.channels_last)
    outs = []
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        for fwd in (present, resnet.Bottleneck.forward):
            block.zero_grad(set_to_none=True)
            x = x0.clone().requires_grad_()
            y = fwd(block, x)
            y.backward(torch.ones_like(y))
            outs.append([y.detach(), x.grad,
                         *(p.grad for p in block.parameters())])
    assert len(outs[1]) == (6 if down else 5)
    for got, want in zip(outs[1], outs[0]):
        assert torch.equal(got, want)
