"""RoIAlign forward over NHWC features (port of dana_tpu/ops/roi_align.py,
float32 path, and of the Pallas kernel in dana_tpu/ops/roi_align_pallas.py).

`roi_align` is the port's RoIAlign: on a CUDA tensor it launches the
hand-written kernel `csrc/roi_align_fwd.cu`, on a CPU tensor it runs
`roi_align_plain`, the separable form of the JAX package:

    pooled[r, ph, pw, c] = sum_h sum_w Wy[r, ph, h] * Wx[r, pw, w] * feat[h, w, c]

with Wy / Wx built per axis from the roi coordinates (adaptive sample
count by floor plus exact-product correction, capped at `max_samples`,
and the clamp rules of the reference CUDA kernel).
"""

from __future__ import annotations

import ctypes

import torch

from dana_tpu_torch.ops import build


def _axis_weights(lo, hi, size: int, pooled: int, max_samples: int):
    """[..., pooled, size] interpolation weights for one axis from roi
    start/end `lo`, `hi` [...] in feature coordinates."""
    extent = torch.clamp(hi - lo, min=1.0)
    bin_sz = extent / pooled
    # ceil(extent / pooled), exact for every extent: a reciprocal multiply
    # would make ceil(21 * (1/7)) = 4
    q = torch.floor(extent / pooled)
    count = q + (q * pooled < extent).to(q.dtype)
    count = torch.clamp(count, 1, max_samples)

    dev, dt = lo.device, lo.dtype
    p = torch.arange(pooled, device=dev, dtype=dt)
    s = torch.arange(max_samples, device=dev, dtype=dt)
    x = (lo[..., None, None] + p[:, None] * bin_sz[..., None, None]
         + (s + 0.5) * (bin_sz / count)[..., None, None])       # [...,P,S]
    smask = s < count[..., None, None]

    in_range = (x >= -1.0) & (x <= size)
    xc = torch.clamp(x, min=0.0)
    x_low = torch.clamp(torch.floor(xc), max=size - 1)
    frac = torch.where(x_low >= size - 1, 0.0, xc - x_low)
    x_high = torch.clamp(x_low + 1, max=size - 1)

    w = (smask & in_range).to(dt) / count[..., None, None]
    u = torch.arange(size, device=dev, dtype=dt)
    contrib = ((u == x_low[..., None]) * (w * (1.0 - frac))[..., None]
               + (u == x_high[..., None]) * (w * frac)[..., None])
    return contrib.sum(dim=-2)                                  # [...,P,size]


def roi_align_plain(feat, rois, output_size: int = 7,
                    spatial_scale: float = 1.0 / 16.0, max_samples: int = 16):
    """feat [B,H,W,C] float32, rois [B,R,4|5] (a leading batch-index
    column is ignored; rois are grouped per image) -> [B,R,P,P,C]."""
    b, h, w, c = feat.shape
    r = rois[..., -4:].float() * spatial_scale
    wy = _axis_weights(r[..., 1], r[..., 3], h, output_size,
                       max_samples)                             # [B,R,P,H]
    wx = _axis_weights(r[..., 0], r[..., 2], w, output_size,
                       max_samples)                             # [B,R,P,W]
    outs = []
    for i in range(b):      # per image: the [R,P,W,C] stage is large
        tmp = torch.einsum('rph,hwc->rpwc', wy[i], feat[i])
        outs.append(torch.einsum('rqw,rpwc->rpqc', wx[i], tmp))
    return torch.stack(outs)


def _lib():
    lib = build.load('roi_align_fwd')
    if lib.roi_align_fwd_f32.argtypes is None:
        lib.roi_align_fwd_f32.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.roi_align_fwd_f32.restype = ctypes.c_int
        lib.roi_align_fwd_max_samples.restype = ctypes.c_int
    return lib


def roi_align(feat, rois, output_size: int = 7,
              spatial_scale: float = 1.0 / 16.0, max_samples: int = 16):
    """RoIAlign forward: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Same arguments as `roi_align_plain`."""
    if feat.device.type == 'cpu':
        return roi_align_plain(feat, rois, output_size, spatial_scale,
                               max_samples)
    if feat.device.type != 'cuda' or rois.device != feat.device:
        raise ValueError('roi_align: feat and rois must be on one CUDA '
                         f'device (got {feat.device}, {rois.device})')
    if feat.dtype != torch.float32 or rois.dtype != torch.float32:
        raise TypeError('roi_align kernel takes float32 feat and rois '
                        f'(got {feat.dtype}, {rois.dtype})')
    if feat.dim() != 4 or rois.dim() != 3 or rois.shape[-1] not in (4, 5) \
            or rois.shape[0] != feat.shape[0]:
        raise ValueError(f'roi_align: bad shapes feat {tuple(feat.shape)}, '
                         f'rois {tuple(rois.shape)}')
    if not (feat.is_contiguous() and rois.is_contiguous()):
        raise ValueError('roi_align kernel takes contiguous tensors')
    lib = _lib()
    if max_samples > lib.roi_align_fwd_max_samples():
        raise ValueError(f'roi_align kernel supports max_samples <= '
                         f'{lib.roi_align_fwd_max_samples()}')
    b, h, w, c = feat.shape
    r = rois.shape[1]
    out = torch.empty(b, r, output_size, output_size, c, device=feat.device,
                      dtype=torch.float32)
    with torch.cuda.device(feat.device):
        err = lib.roi_align_fwd_f32(
            feat.data_ptr(), rois.data_ptr(), out.data_ptr(), b, r, h, w, c,
            rois.shape[-1], output_size, spatial_scale, max_samples,
            torch.cuda.current_stream(feat.device).cuda_stream)
    build.check(err, 'roi_align_fwd')
    roi_align.launches += 1
    return out


roi_align.launches = 0
