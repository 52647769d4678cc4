"""RoIPool (max pooling per bin) over NHWC features (port of
dana_tpu/ops/roi_pool.py, POOLING_MODE='pool').  Plain PyTorch: the JAX
package computes it in XLA, not in a Pallas kernel.

Bin edges are exact integers, as the JAX function and the reference CUDA
kernel compute them: the roi's corners times the scale, rounded half to
even (`torch.round`, as `jnp.round`), an extent of end - start + 1 (at
least 1), bin p spanning [floor(p * extent / P), ceil((p + 1) * extent /
P)) past the start, clamped to the map.  An empty bin gives 0.

The JAX function takes a masked max over W for each x-bin and then over H
for each y-bin; its gradient splits evenly among tied values at each of
the two stages separately (ties are common: the maps come out of a ReLU).
This version keeps the two stages and their gradient (`torch.amax` splits
ties evenly, as JAX's max does; `torch.max(dim)` would not): for a chunk
of rois it gathers each bin's window, the rows of the y-bin times the
columns of the x-bin, padded with -inf to the widest bin of the call (read
on the host: one `trace.sync` at site `roi_pool`), and
reduces the columns, then the rows.  Rows outside the y-bins get no
gradient in the JAX function either, so gathering only the bins' rows
changes nothing.  Chunks are sized to a fixed budget of gathered bytes,
and with autograd each chunk is recomputed in the backward pass
(`torch.utils.checkpoint`), so training memory does not grow with the
rois.  Any number of rois works.

As in the JAX function, the maxes are taken on the map upcast to float32
and the result is cast back to the map's dtype: on a bf16 map the values
are the same, and the gradient's shares of tied values (and of bins that
overlap) sum in float32 and round once.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from dana_tpu_torch.utils import trace

# gathered bin windows per chunk (bytes)
CHUNK_BYTES = 256 << 20


def bin_edges(lo, hi, size: int, pooled: int):
    """Roi start / end `lo`, `hi` [...] in feature coordinates -> (start,
    length) [..., pooled] int64 of each bin along one axis, clamped to
    [0, size]."""
    start = torch.round(lo).long()
    end = torch.round(hi).long()
    extent = torch.clamp(end - start + 1, min=1)[..., None]
    p = torch.arange(pooled, device=lo.device)
    scaled = p * extent
    b_start = torch.clamp(torch.div(scaled, pooled, rounding_mode='floor')
                          + start[..., None], 0, size)
    b_end = torch.clamp(torch.div(scaled + extent + pooled - 1, pooled,
                                  rounding_mode='floor')
                        + start[..., None], 0, size)
    return b_start, torch.clamp(b_end - b_start, min=0)


def _pool_chunk(flat, rows, lh, cols, lw):
    """flat [B*H*W, C]; for n rois: rows [n, P, Kh], the flat index of
    each y-bin's first pixel of every row (image offset included), lh [n,
    P] how many of the Kh are real, cols [n, Q, Kw] each x-bin's columns,
    lw [n, Q] how many are real -> [n, P, Q, C]: the masked max over the
    bin's columns, then over its rows (-inf where a bin is empty)."""
    kh, kw = rows.shape[-1], cols.shape[-1]
    index = rows[..., None, None] + cols[:, None, None]      # [n,P,Kh,Q,Kw]
    valid = ((torch.arange(kh, device=flat.device) < lh[..., None])
             [..., None, None]
             & (torch.arange(kw, device=flat.device) < lw[..., None])
             [:, None, None])
    g = flat.index_select(0, index.reshape(-1)).reshape(*index.shape, -1)
    g = torch.where(valid[..., None], g, float('-inf'))
    return torch.amax(torch.amax(g, dim=4), dim=2)


def roi_pool(feat, rois, output_size: int = 7,
             spatial_scale: float = 1.0 / 16.0):
    """Max RoI pooling: feat [B, H, W, C], rois [B, R, 4|5] in image
    coordinates (a leading batch-index column is ignored; rois are grouped
    per image) -> [B, R, P, P, C] in feat's dtype.  Differentiable in
    feat."""
    b, h, w, c = feat.shape
    r = rois.shape[1]
    p = output_size
    box = rois[..., -4:].float() * spatial_scale
    ys, lh = bin_edges(box[..., 1], box[..., 3], h, p)        # [B,R,P]
    xs, lw = bin_edges(box[..., 0], box[..., 2], w, p)
    kh, kw = (max(int(v), 1) for v in
              trace.sync(torch.stack([lh.max(), lw.max()]), 'roi_pool'))
    img = torch.arange(b, device=feat.device)[:, None, None, None] * (h * w)
    rows = img + torch.clamp(ys[..., None] + torch.arange(
        kh, device=feat.device), max=h - 1) * w                # [B,R,P,Kh]
    cols = torch.clamp(xs[..., None] + torch.arange(kw, device=feat.device),
                       max=w - 1)                              # [B,R,Q,Kw]
    per_roi = p * kh * p * kw * c * 4
    n = max(1, CHUNK_BYTES // per_roi)
    grad = torch.is_grad_enabled() and feat.requires_grad
    flat = feat.float().reshape(b * h * w, c)
    parts = [t.reshape(b * r, *t.shape[2:]) for t in (rows, lh, cols, lw)]
    outs = []
    for s in range(0, b * r, n):
        args = (flat, *(t[s:s + n] for t in parts))
        outs.append(checkpoint(_pool_chunk, *args, use_reentrant=False)
                    if grad else _pool_chunk(*args))
    out = torch.cat(outs).reshape(b, r, p, p, c)
    return torch.where(torch.isfinite(out), out, 0.0).to(feat.dtype)
