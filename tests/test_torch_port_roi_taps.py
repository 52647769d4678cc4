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
the L2 byte model `chip_smoke.py` prints for the kernels.  The emulation is
test code only: nothing in the package uses it.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dana_tpu.ops.roi_align import roi_align as jroi_align
from dana_tpu.ops.roi_align_pallas import (roi_align_pallas,
                                           roi_align_pallas_pw)

from dana_tpu_torch.ops import roi_align as troi

from test_torch_port_ops import _edge_rois

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
