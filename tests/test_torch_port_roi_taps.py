"""The algorithm of the port's RoIAlign kernels (dana_tpu_torch/ops/csrc/
roi_align.cu), emulated in torch on the CPU and held to the JAX package.

The CUDA source cannot run here, so this file replays what it does, step by
step, at a small size:
  * K2's taps: per roi and axis, each sample in order adds its low and
    high bilinear weights into a dense row (explicitly rounded float32,
    no fused multiply-add), then each (roi, ph) row of bins keeps the rows
    h with Wy[ph, h] != 0 and the columns w with some Wx[pw, w] != 0;
  * the shared body's loop order: for each kept column, stage 1 over the
    kept rows, then stage 2 into the P outputs.
The result is held against JAX's float32 `roi_align` and both Pallas
kernels in interpret mode (`roi_align_pallas`, which builds the weights in
the kernel, and `roi_align_pallas_pw`), and the kept-tap counts against
the L2 byte model `chip_smoke.py` prints for the kernels.

The bf16 kernel (`roi_align_fwd_bf16`) pools each roi as one product over
the taps of `roi_align.roi_tap_extent`, the rectangle of its two axes'
sample spans, in chunks of 8 columns (zero-weighted past the span) and
stages of 64 taps.  Its premise is held against JAX's bf16 RoIAlign, run op
by op (`jax.disable_jit`, as tests/test_torch_port_precision.py runs it):
every nonzero combined weight lies inside the rectangle, the plain combine
with the weights cut to it is the plain combine bit for bit, and a replay
of the kernel's chunks and stages agrees with the plain version and JAX.
The emulations are test code only: nothing in the package uses them.
"""

import importlib
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dana_tpu.ops.roi_align import roi_align as jroi_align
from dana_tpu.ops.roi_align_pallas import (roi_align_pallas,
                                           roi_align_pallas_pw)

from dana_tpu_torch.ops import roi_align as troi

from test_torch_port_ops import _edge_rois

jra = importlib.import_module('dana_tpu.ops.roi_align')

# the emulation against JAX's float32 forms (XLA fuses and reorders their
# float32 arithmetic); the dense weights against the port's plain ones
TOL = 3e-6
WEIGHT_ATOL = 6e-8

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def _axis_taps(lo, hi, size, p, max_samples):
    """Dense [R, P, size] weights of one axis from roi start / end [R] in
    feature coordinates, sample by sample as the kernel adds them."""
    extent = torch.clamp(hi - lo, min=1.0)
    bin_ = extent / p
    q = torch.floor(extent / p)
    count = torch.clamp(q + (q * p < extent).float(), 1, max_samples)
    bins = torch.arange(p, dtype=torch.float32)
    u = torch.arange(size, dtype=torch.float32)
    dense = torch.zeros(lo.shape[0], p, size)
    for s in range(max_samples):
        x = ((lo[:, None] + bins * bin_[:, None])
             + (s + 0.5) * (bin_ / count)[:, None])            # [R, P]
        keep = (x >= -1.0) & (x <= size) & (s < count)[:, None]
        xc = torch.clamp(x, min=0.0)
        x_low = torch.clamp(torch.floor(xc), max=size - 1)
        frac = torch.where(x_low >= size - 1, 0.0, xc - x_low)
        x_high = torch.clamp(x_low + 1, max=size - 1)
        w = torch.where(keep, 1.0 / count[:, None], 0.0)
        lo_w, hi_w = w * (1.0 - frac), w * frac
        dense = dense + ((u == x_low[..., None]) * lo_w[..., None]
                         + (u == x_high[..., None]) * hi_w[..., None])
    return dense


def _taps(rois, h, w, p, max_samples, scale=1 / 16.0):
    """K2's dense rows from rois [B, R, 4|5]: (Wy [B,R,P,h], Wx [B,R,P,w])."""
    r = rois[..., -4:].float() * scale
    b, n = r.shape[:2]
    flat = r.reshape(-1, 4)
    wy = _axis_taps(flat[:, 1], flat[:, 3], h, p, max_samples)
    wx = _axis_taps(flat[:, 0], flat[:, 2], w, p, max_samples)
    return wy.reshape(b, n, p, h), wx.reshape(b, n, p, w)


def _kept(wy, wx):
    """Kept rows [B,R,P] and kept columns [B,R] of each (b, r, ph) row."""
    return (wy != 0).sum(-1), (wx != 0).any(-2).sum(-1)


def _pool(feat, wy, wx):
    """The shared body, one (b, r, ph) row of bins at a time, in its loop
    order."""
    b_, r_, p, _ = wy.shape
    out = torch.zeros(b_, r_, p, p, feat.shape[-1])
    for b in range(b_):
        for r in range(r_):
            cols = torch.nonzero((wx[b, r] != 0).any(0))[:, 0]
            for ph in range(p):
                rows = torch.nonzero(wy[b, r, ph] != 0)[:, 0]
                acc = torch.zeros(p, feat.shape[-1])
                for w in cols:
                    s1 = torch.zeros(feat.shape[-1])
                    for h in rows:
                        s1 = s1 + wy[b, r, ph, h] * feat[b, h, w]
                    acc = acc + wx[b, r, :, w, None] * s1
                out[b, r, ph] = acc
    return out


@pytest.mark.parametrize('max_samples', [16, 64])
@pytest.mark.parametrize('p', [7, 5])
def test_emulated_kernels_match_jax(p, max_samples):
    rng = np.random.default_rng(13)
    feat = rng.normal(size=(2, 10, 12, 8)).astype(np.float32)
    rois = _edge_rois()
    rois5 = np.concatenate([np.zeros((2, 14, 1), np.float32), rois], -1)
    wy, wx = _taps(torch.from_numpy(rois5), 10, 12, p, max_samples)
    got = _pool(torch.from_numpy(feat), wy, wx).numpy()
    f, r = jnp.asarray(feat), jnp.asarray(rois)
    want = {
        'roi_align': jroi_align(f, jnp.asarray(rois5), p, 1 / 16.0, 0,
                                max_samples),
        'roi_align_pallas': roi_align_pallas(f, r, p, 1 / 16.0, 0,
                                             max_samples, roi_block=4),
        'roi_align_pallas_pw': roi_align_pallas_pw(f, r, p, 1 / 16.0, 0,
                                                   max_samples)}
    for name, w in want.items():
        np.testing.assert_allclose(got, np.asarray(w), rtol=TOL, atol=TOL,
                                   err_msg=name)
    # the taps the kernel keeps are those of the port's plain weights, and
    # their values differ only in the order each entry sums its samples
    pw_y, pw_x = troi.roi_weights(torch.from_numpy(rois5), 10, 12, p,
                                  1 / 16.0, max_samples)
    for a, b in zip(_kept(wy, wx), _kept(pw_y, pw_x)):
        assert torch.equal(a, b)
    for a, b in zip((wy, wx), (pw_y, pw_x)):
        torch.testing.assert_close(a, b, rtol=0, atol=WEIGHT_ATOL)


def test_gather_model_counts_emulated_taps():
    """At the smoke's serving rois (seed 0, on the CPU's generator) the
    kept taps of K2's emulated build give `chip_smoke.roi_taps`' model:
    kept rows x kept columns x 4 C bytes through L2, summed over the
    (b, r, ph) rows, against 4 corner rows a sample for a block per
    output bin."""
    gen = torch.Generator().manual_seed(0)
    rois = chip_smoke.serving_rois(8, 300, gen, torch.device('cpu'))
    c, p = 1024, 7
    wy, wx = _taps(rois, 38, 64, p, 16)
    n_h, n_w = _kept(wy, wx)
    gather = 4 * c * (n_h * n_w[..., None]).sum().item()
    flops, model = chip_smoke.roi_taps(*troi.roi_weights(rois, 38, 64, p),
                                       c)
    assert gather == model
    assert flops == 2 * c * (n_w * (n_h.sum(-1) + p * p)).sum().item()
    counts = chip_smoke._sample_counts(rois, p)
    per_bin = 16 * c * p * p * (counts[..., 0] * counts[..., 1]).sum().item()
    assert 4 * gather < per_bin


# ------------------------------------------------------- the bf16 kernel

BF16 = torch.bfloat16
BF16_ULP = 2.0 ** -7    # one bf16 ulp at the output's scale


def _bf16_case(case):
    """(map height, width, rois [B, R, 5] float32 holding bf16 values, as
    the model hands them): the 10x12 map's edge rois plus one larger than
    the map and one wholly below-right of it, or proposal-like rois at the
    first query bucket's 38x64 map (chip_smoke.py's, with its whole-map and
    larger-than-map edge cases)."""
    if case == 'edge':
        more = np.array([[-900, -900, 3000, 3000], [300, 300, 400, 420]],
                        np.float32)
        boxes = np.concatenate([_edge_rois(), np.stack([more, more])], 1)
        h, w = 10, 12
    else:
        gen = torch.Generator().manual_seed(0)
        boxes = chip_smoke.serving_rois(2, 96, gen, torch.device('cpu')
                                        )[..., 1:].numpy()
        h, w = 38, 64
    rois = np.concatenate([np.zeros((*boxes.shape[:2], 1), np.float32),
                           boxes], -1)
    return h, w, torch.from_numpy(rois).to(BF16).float()


def _jax_weights(rois, h, w, p, max_samples):
    """JAX's float32 axis weights of each image's rois, op by op: (Wy
    [B,R,P,h], Wx [B,R,P,w]) as numpy."""
    wy, wx = [], []
    with jax.disable_jit():
        for img in rois.numpy():
            r = jnp.asarray(img[:, 1:]).astype(jnp.float32) * (1 / 16.0)
            wy.append(np.asarray(jra._axis_weights(r[:, 1], r[:, 3], h, p,
                                                   max_samples, 0)))
            wx.append(np.asarray(jra._axis_weights(r[:, 0], r[:, 2], w, p,
                                                   max_samples, 0)))
    return np.stack(wy), np.stack(wx)


def _replay_bf16(feat, wy, wx, rows, cols):
    """roi_align_fwd_bf16's product, roi by roi: the taps are the span's
    rows x its columns rounded up to 8 (map columns past the span read as
    they are, past the map as zeros, with zero weights), row by row; the
    combined weights bf16(Wy * Wx); float32 sums over stages of 64 taps,
    one rounding.  -> (out [B,R,P,P,C] bf16, the combined weights of the
    real taps [B][R] as [P,P,nh,nw] float32)."""
    b_, h, w, c = feat.shape
    p = wy.shape[2]
    out, weights = torch.zeros(b_, wy.shape[1], p, p, c), []
    for b in range(b_):
        weights.append([])
        for r in range(wy.shape[1]):
            ys, xs = torch.nonzero(rows[b, r])[:, 0], torch.nonzero(
                cols[b, r])[:, 0]
            y0, nh, x0, nw = ys[0].item(), len(ys), xs[0].item(), len(xs)
            assert ys[-1] - y0 + 1 == nh and xs[-1] - x0 + 1 == nw
            nwp = -(-nw // 8) * 8
            hh = torch.arange(y0, y0 + nh)[:, None].expand(nh, nwp)
            ww = torch.arange(x0, x0 + nwp)[None, :].expand(nh, nwp)
            f = torch.where((ww < w)[..., None],
                            feat[b, hh, ww.clamp(max=w - 1)].float(), 0.0)
            wxp = torch.zeros(p, nwp)
            wxp[:, :nw] = wx[b, r][:, x0:x0 + nw]
            a = (wy[b, r][:, None, y0:y0 + nh, None]
                 * wxp[None, :, None, :]).to(BF16).float()
            weights[b].append(a[..., :nw])
            a, f = a.reshape(p * p, -1), f.reshape(-1, c)
            acc = torch.zeros(p * p, c)
            for s0 in range(0, a.shape[1], 64):
                acc = acc + a[:, s0:s0 + 64] @ f[s0:s0 + 64]
            out[b, r] = acc.reshape(p, p, c)
    return out.to(BF16), weights


@pytest.mark.parametrize('max_samples', [16, 64])
@pytest.mark.parametrize('p', [7, 5])
@pytest.mark.parametrize('case', ['edge', 'serving'])
def test_tap_extent_holds_every_nonzero_jax_weight(case, p, max_samples):
    """Every nonzero combined weight bf16(Wy * Wx) of JAX's bf16 RoIAlign
    lies inside `roi_tap_extent`'s rectangle, and so does every nonzero
    weight of the port's plain version."""
    h, w, rois = _bf16_case(case)
    rows, cols = troi.roi_tap_extent(rois, h, w, p, 1 / 16.0, max_samples)
    jwy, jwx = _jax_weights(rois, h, w, p, max_samples)
    with jax.disable_jit():
        comb = np.asarray(jnp.einsum('brph,brqw->brpqhw', jwy, jwx).astype(
            jnp.bfloat16).astype(jnp.float32))
    nonzero = comb != 0
    assert nonzero.any()
    assert not (nonzero & ~(rows.numpy()[:, :, None, None, :, None]
                            & cols.numpy()[:, :, None, None, None, :])).any()
    wy, wx = troi.roi_weights(rois, h, w, p, 1 / 16.0, max_samples)
    assert not ((wy != 0) & ~rows[:, :, None]).any()
    assert not ((wx != 0) & ~cols[:, :, None]).any()


@pytest.mark.parametrize('max_samples', [16, 64])
@pytest.mark.parametrize('p', [7, 5])
@pytest.mark.parametrize('case', ['edge', 'serving'])
def test_combine_on_the_tap_extent_matches_plain_and_jax(case, p,
                                                         max_samples):
    """`roi_align_combine_plain` with the axis weights cut to the
    rectangle equals the uncut one bit for bit, and both are JAX's bf16
    RoIAlign (op by op) within one bf16 ulp at the output's scale; the
    replay of the bf16 kernel's chunks and stages forms exactly the plain
    combined weights on its taps and agrees with the plain version and JAX
    within the same ulp."""
    h, w, rois = _bf16_case(case)
    rng = np.random.default_rng(17)
    feat = torch.from_numpy(rng.normal(size=(rois.shape[0], h, w, 16)
                                       ).astype(np.float32)).to(BF16)
    rows, cols = troi.roi_tap_extent(rois, h, w, p, 1 / 16.0, max_samples)
    wy, wx = troi.roi_weights(rois, h, w, p, 1 / 16.0, max_samples)
    plain = troi.roi_align_combine_plain(feat, wy, wx)
    cut = troi.roi_align_combine_plain(feat, wy * rows[:, :, None],
                                       wx * cols[:, :, None])
    assert torch.equal(cut, plain)
    with jax.disable_jit():
        want = np.asarray(jra.roi_align(
            jnp.asarray(feat.float().numpy(), jnp.bfloat16),
            jnp.asarray(rois.numpy(), jnp.bfloat16), p, 1 / 16.0, 0,
            max_samples).astype(jnp.float32))
    tol = BF16_ULP * np.abs(want).max()
    assert np.abs(plain.float().numpy() - want).max() <= tol
    got, weights = _replay_bf16(feat, wy, wx, rows, cols)
    comb = torch.einsum('brph,brqw->brpqhw', wy, wx).to(BF16).float()
    for b, per_roi in enumerate(weights):
        for r, a in enumerate(per_roi):
            ys, xs = torch.nonzero(rows[b, r])[:, 0], torch.nonzero(
                cols[b, r])[:, 0]
            assert torch.equal(a, comb[b, r][:, :, ys][..., xs])
    assert np.abs(got.float().numpy() - plain.float().numpy()).max() <= tol
    assert np.abs(got.float().numpy() - want).max() <= tol
