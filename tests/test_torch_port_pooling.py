"""The port's RoIPool (ops/roi_pool.py) and affine crop (ops/grid_sample.py)
against the JAX package's on the CPU, forward and gradient.

The maps come out of a ReLU with blocks of exact zeros and of one repeated
value, so bins hold ties: JAX's gradient splits evenly among tied values at
each of RoIPool's two stages (over W, then over H), and the crop's 2 x 2
max sends it to the first maximum, which the port must reproduce.  The
crop's maps keep the zeros but not the repeated value: its bilinear weights
sum to one only to float32 rounding, so samples of one non-zero value are
near-ties that each package's rounding breaks its own way.  The
rois hold the edge cases: outside the map (empty bins, out-of-bounds
corners), reversed, tiny, half-pixel corners (x.5 after the 1/16 scale,
which JAX's round sends to even), and a roi over the whole map.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dana_tpu_torch.ops import grid_sample as tgs
from dana_tpu_torch.ops import roi_pool as trp

# dana_tpu.ops re-exports the functions under the modules' names
jrp = importlib.import_module('dana_tpu.ops.roi_pool')
jgs = importlib.import_module('dana_tpu.ops.grid_sample')

GRAD_TOL = 1e-6        # RoIPool: of the gradient's largest magnitude
CROP_TOL = 1e-5


def _map(seed, b=2, h=11, w=14, c=8):
    """ReLU'd noise with a block of zeros and a block of one value."""
    rng = np.random.default_rng(seed)
    f = np.maximum(rng.normal(0, 1, (b, h, w, c)), 0).astype(np.float32)
    f[:, 2:6, 3:8] = 0.0
    f[:, 6:9, 9:13] = 0.75
    return f


def _rois(seed, b=2, r=32, h=11, w=14):
    """[B, R, 5] image-coordinate rois on a (16 h) x (16 w) image, edge
    cases first."""
    rng = np.random.default_rng(seed)
    edge = np.array([
        [-300, -200, -40, -20],           # outside: every bin empty
        [8, 24, 40, 56],                  # corners at x.5 on the map
        [24, 40, 88, 120],                # more half pixels (2.5, 5.5)
        [0, 0, 16 * w - 1, 16 * h - 1],   # the whole map
        [100, 90, 60, 50],                # reversed
        [30, 30, 30.4, 30.2],             # tiny
        [-40, -30, 100, 90],              # across the top-left edge
        [16 * w - 50, 16 * h - 40, 16 * w + 80, 16 * h + 60],
    ], np.float32)
    n = r - len(edge)
    xy = rng.uniform(-32, 16 * max(h, w), (b, n, 2))
    wh = rng.uniform(4, 160, (b, n, 2))
    boxes = np.concatenate([np.broadcast_to(edge, (b, len(edge), 4)),
                            np.concatenate([xy, xy + wh], -1)], 1)
    idx = np.broadcast_to(np.arange(b, dtype=np.float32)[:, None, None],
                          (b, r, 1))
    return np.concatenate([idx, boxes], -1).astype(np.float32)


def _jax_vjp(fn, feat, cot):
    out, vjp = jax.vjp(fn, jnp.asarray(feat))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(cot))[0])


def _port_vjp(fn, feat, cot):
    x = torch.from_numpy(feat).requires_grad_()
    out = fn(x)
    out.backward(torch.from_numpy(cot))
    return out.detach().numpy(), x.grad.numpy()


def _cot(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape) \
        .astype(np.float32)


@pytest.mark.parametrize('seed', [0, 1])
def test_roi_pool_matches_jax(seed):
    """Forward exact; the feature gradient within 1e-6 of its scale, ties
    split as JAX splits them."""
    feat, rois = _map(seed), _rois(seed)
    cot = _cot((2, 32, 7, 7, 8), seed)
    want, jgrad = _jax_vjp(lambda f: jrp.roi_pool(f, jnp.asarray(rois)),
                           feat, cot)
    got, grad = _port_vjp(lambda f: trp.roi_pool(f, torch.from_numpy(rois)),
                          feat, cot)
    np.testing.assert_array_equal(got, want)
    assert (want[:, 0] == 0).all()                     # empty bins: 0
    np.testing.assert_allclose(grad, jgrad, rtol=0,
                               atol=GRAD_TOL * np.abs(jgrad).max())
    # the ties: some gradient shares are a third, a half or a quarter of
    # a cotangent, so an argmax-only gradient could not match
    assert (np.abs(jgrad[:, 2:6, 3:8]) > 0).any()


def test_roi_pool_half_pixels_round_to_even():
    """The bin edges of a roi whose corners sit at x.5 on the map: round
    half to even (0.5 -> 0, 1.5 -> 2, 2.5 -> 2, 3.5 -> 4)."""
    lo = torch.tensor([0.5, 1.5, 2.5, 3.5])
    start, length = trp.bin_edges(lo, lo + 3, 20, 2)
    np.testing.assert_array_equal(start[:, 0].numpy(), [0, 2, 2, 4])
    feat, rois = _map(3), _rois(3)
    want = np.asarray(jrp.roi_pool(jnp.asarray(feat), jnp.asarray(rois)))
    got = trp.roi_pool(torch.from_numpy(feat), torch.from_numpy(rois))
    np.testing.assert_array_equal(got.numpy()[:, 1:3], want[:, 1:3])


def test_roi_pool_any_roi_count_matches_jax_padded():
    """300 rois an image (the serving count, no multiple of JAX's 32-roi
    chunk): against the JAX function on the same rois padded to 320, the
    first 300 rows, forward and gradient."""
    feat = _map(4, h=38, w=64, c=4)
    rois = _rois(4, r=300, h=38, w=64)
    pad = np.concatenate([rois, np.zeros((2, 20, 5), np.float32)], 1)
    cot = _cot((2, 300, 7, 7, 4), 4)
    cot_pad = np.concatenate([cot, np.zeros((2, 20, 7, 7, 4), np.float32)],
                             1)
    want, jgrad = _jax_vjp(lambda f: jrp.roi_pool(f, jnp.asarray(pad)),
                           feat, cot_pad)
    got, grad = _port_vjp(lambda f: trp.roi_pool(f, torch.from_numpy(rois)),
                          feat, cot)
    np.testing.assert_array_equal(got, want[:, :300])
    np.testing.assert_allclose(grad, jgrad, rtol=0,
                               atol=GRAD_TOL * np.abs(jgrad).max())


def test_roi_pool_chunks_do_not_change_the_result(monkeypatch):
    """A budget of one roi a chunk, with the chunks recomputed in the
    backward pass, gives the one-chunk result: the same forward, and the
    gradient but for the order in which the rois' shares of a pixel add
    up."""
    feat, rois = _map(5), _rois(5)
    cot = _cot((2, 32, 7, 7, 8), 5)
    fn = lambda f: trp.roi_pool(f, torch.from_numpy(rois))   # noqa: E731
    out, grad = _port_vjp(fn, feat, cot)
    monkeypatch.setattr(trp, 'CHUNK_BYTES', 1)
    out1, grad1 = _port_vjp(fn, feat, cot)
    np.testing.assert_array_equal(out1, out)
    np.testing.assert_allclose(grad1, grad, rtol=0,
                               atol=GRAD_TOL * np.abs(grad).max())


def test_grid_sample_matches_jax():
    """Bilinear samples inside, on the edge and outside the map (zeros),
    and the gradients for the map and the grid."""
    rng = np.random.default_rng(6)
    feat = _map(6, b=3, h=9, w=12, c=5)
    grid = rng.uniform(-1.4, 1.4, (3, 6, 7, 2)).astype(np.float32)
    grid[0, 0, :3] = [[-1, -1], [1, 1], [1, -1]]       # the corners
    cot = _cot((3, 6, 7, 5), 6)
    out, vjp = jax.vjp(jgs.grid_sample, jnp.asarray(feat), jnp.asarray(grid))
    jf, jg = (np.asarray(t) for t in vjp(jnp.asarray(cot)))
    f = torch.from_numpy(feat).requires_grad_()
    g = torch.from_numpy(grid).requires_grad_()
    got = tgs.grid_sample(f, g)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=0, atol=CROP_TOL)
    np.testing.assert_allclose(f.grad.numpy(), jf, rtol=0,
                               atol=CROP_TOL * np.abs(jf).max())
    np.testing.assert_allclose(g.grad.numpy(), jg, rtol=0,
                               atol=CROP_TOL * np.abs(jg).max())
    assert (got.detach().numpy()[np.abs(grid).max(-1) > 1.2] == 0).any()


def test_affine_grid_matches_jax():
    theta = np.random.default_rng(7).normal(0, 2, (4, 2, 3)) \
        .astype(np.float32)
    want = np.asarray(jgs.affine_grid(jnp.asarray(theta), (14, 10)))
    got = tgs.affine_grid(torch.from_numpy(theta), (14, 10)).numpy()
    assert got.shape == (4, 14, 10, 2)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=CROP_TOL * np.abs(want).max())


@pytest.mark.parametrize('seed', [0, 1])
def test_roi_crop_pool_matches_jax(seed):
    """The crop of each roi, forward and feature gradient, with rois out of
    bounds (zero samples) and ties in the 2 x 2 max (the zero block)."""
    feat, rois = _map(seed), _rois(seed)
    feat[:, 6:9, 9:13] = 0.0        # exact ties only (the module doc)
    cot = _cot((2, 32, 7, 7, 8), seed)
    want, jgrad = _jax_vjp(
        lambda f: jgs.roi_crop_pool(f, jnp.asarray(rois)), feat, cot)
    got, grad = _port_vjp(
        lambda f: tgs.roi_crop_pool(f, torch.from_numpy(rois)), feat, cot)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=CROP_TOL * np.abs(want).max())
    np.testing.assert_allclose(grad, jgrad, rtol=0,
                               atol=CROP_TOL * np.abs(jgrad).max())
    assert (want[:, 0] == 0).all()                # outside: zero samples


def test_roi_crop_pool_chunks_do_not_change_the_result(monkeypatch):
    feat, rois = _map(8), _rois(8)
    fn = lambda f: tgs.roi_crop_pool(f, torch.from_numpy(rois))  # noqa
    whole = fn(torch.from_numpy(feat))
    monkeypatch.setattr(tgs, 'CHUNK_BYTES', 1)
    assert torch.equal(fn(torch.from_numpy(feat)), whole)
