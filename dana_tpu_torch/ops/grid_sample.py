"""Bilinear grid sampling and the affine RoI crop (port of
dana_tpu/ops/grid_sample.py, POOLING_MODE='crop').  Plain PyTorch: the
JAX package computes it in XLA, not in a Pallas kernel.

`grid_sample` is torch 1.2's F.grid_sample over NHWC maps: bilinear, zero
padding, align_corners=True, written as the JAX function writes it (four
gathered corners, each zero outside the map, weighted by its lerp
factors), so that its gradients are the JAX function's too.
`roi_crop_pool` builds each roi's affine theta from its corners, samples
a 2P x 2P grid of it and max-pools 2 x 2, as the JAX function does with
its `max_pool=True` (the config's CROP_RESIZE_WITH_MAX_POOL is read by
neither package).  The JAX function samples from the batch's maps
repeated once per roi; here each roi reads its own image's map through a
flat index, a chunk of rois at a time, so no copy of the maps is made.

Dtypes follow the JAX function's promotion: theta is computed in the
rois' dtype, the affine grid in float32 (its `linspace` is float32, and
float32 wins over a bf16 theta), so the lerp weights are float32 and a
bf16 map's samples, crops and pooled result come out in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# sampled crops (four corners of 2P x 2P points) per chunk (bytes)
CHUNK_BYTES = 256 << 20


def _sample(flat, base, h: int, w: int, grid):
    """flat [M, C] map rows; base [N] the flat index of each sample set's
    map; grid [N, ..., 2] normalised (x, y) -> [N, ..., C]."""
    x = (grid[..., 0] + 1.0) * (w - 1) / 2.0
    y = (grid[..., 1] + 1.0) * (h - 1) / 2.0
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    x1 = x0 + 1
    y1 = y0 + 1
    base = base.reshape(-1, *([1] * (x.dim() - 1)))

    def gather(yi, xi):
        inb = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        idx = (base + torch.clamp(yi, 0, h - 1).long() * w
               + torch.clamp(xi, 0, w - 1).long())
        g = flat.index_select(0, idx.reshape(-1)).reshape(*idx.shape, -1)
        return torch.where(inb[..., None], g, 0.0)

    wa = ((x1 - x) * (y1 - y))[..., None]
    wb = ((x1 - x) * (y - y0))[..., None]
    wc = ((x - x0) * (y1 - y))[..., None]
    wd = ((x - x0) * (y - y0))[..., None]
    return (wa * gather(y0, x0) + wb * gather(y1, x0)
            + wc * gather(y0, x1) + wd * gather(y1, x1))


def grid_sample(feat, grid):
    """feat [N, H, W, C]; grid [N, Hg, Wg, 2] normalised (x, y) in [-1, 1]
    -> [N, Hg, Wg, C] (bilinear, zeros outside, align_corners=True)."""
    n, h, w, c = feat.shape
    base = torch.arange(n, device=feat.device) * (h * w)
    return _sample(feat.reshape(n * h * w, c), base, h, w, grid)


def affine_grid(theta, out_hw):
    """F.affine_grid with align_corners=True: theta [N, 2, 3] -> grid
    [N, H, W, 2] in float32 (a bf16 theta is promoted, as in JAX)."""
    hh, ww = out_hw
    dev = theta.device
    gy, gx = torch.meshgrid(torch.linspace(-1.0, 1.0, hh, device=dev),
                            torch.linspace(-1.0, 1.0, ww, device=dev),
                            indexing='ij')
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)   # [H, W, 3]
    return torch.einsum('nij,hwj->nhwi', theta.float(), base)


def roi_crop_pool(feat, rois, output_size: int = 7,
                  spatial_scale: float = 1.0 / 16.0):
    """The crop of each roi: feat [B, H, W, C], rois [B, R, 5] in image
    coordinates (a leading batch-index column, ignored; rois are grouped
    per image) -> [B, R, P, P, C] in float32, for a bf16 map too (the
    module's docstring says why).  Differentiable in feat."""
    b, h, w, c = feat.shape
    r = rois.shape[1]
    p = output_size
    box = rois[..., 1:5] * spatial_scale
    x1, y1, x2, y2 = box.unbind(-1)
    zero = torch.zeros_like(x1)
    theta = torch.stack([
        torch.stack([(x2 - x1) / (w - 1), zero,
                     (x1 + x2 - w + 1) / (w - 1)], dim=-1),
        torch.stack([zero, (y2 - y1) / (h - 1),
                     (y1 + y2 - h + 1) / (h - 1)], dim=-1)], dim=-2)
    grid = affine_grid(theta.reshape(b * r, 2, 3), (2 * p, 2 * p))
    base = torch.arange(b, device=feat.device).repeat_interleave(r) * (h * w)
    flat = feat.reshape(b * h * w, c)
    n = max(1, CHUNK_BYTES // (4 * (2 * p) ** 2 * c * 4))
    outs = []
    for s in range(0, b * r, n):
        crops = _sample(flat, base[s:s + n], h, w, grid[s:s + n])
        pooled = F.max_pool2d(crops.permute(0, 3, 1, 2), 2, 2)
        outs.append(pooled.permute(0, 2, 3, 1))
    return torch.cat(outs).reshape(b, r, p, p, c)
