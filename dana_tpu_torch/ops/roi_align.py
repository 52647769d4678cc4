"""RoIAlign over NHWC features (port of dana_tpu/ops/roi_align.py, float32
path, and of the two Pallas kernels in dana_tpu/ops/roi_align_pallas.py).

RoIAlign is separable (the JAX package's float32 form):

    pooled[r, ph, pw, c] = sum_h sum_w Wy[r, ph, h] * Wx[r, pw, w] * feat[h, w, c]

with Wy / Wx built per axis from the roi coordinates (`roi_weights`:
adaptive sample count by floor plus exact-product correction, capped at
`max_samples`, and the clamp rules of the reference CUDA kernel).

Two entries, each a hand-written kernel for CUDA tensors and its plain
version for CPU tensors.  Both kernels are in `csrc/roi_align.cu` and share
one body that pools a row of bins (b, r, ph) from its kept taps; they
differ in where the taps come from:
  * `roi_align` (serving): the kernel builds Wy / Wx from the rois; plain
    twin `roi_align_plain`.
  * `roi_align_pw` (training): the kernel takes precomputed Wy / Wx; plain
    twin `roi_align_pw_plain`.
Both take P = 5 or 7, C % 4 == 0 and 16-byte aligned feat (the body reads
float4 channel groups), and raise on anything else.
`roi_align_train` is the training step's differentiable RoIAlign: it
builds Wy / Wx once, pools with `roi_align_pw` and, in the backward,
contracts the same weights with the output gradient in plain tensor
math (no gradient for the rois, which come from the sampler).
"""

from __future__ import annotations

import ctypes

import torch

from dana_tpu_torch.ops import build


def _axis_weights(lo, hi, size: int, pooled: int, max_samples: int):
    """[..., pooled, size] interpolation weights for one axis from roi
    start/end `lo`, `hi` [...] in feature coordinates."""
    extent = torch.clamp(hi - lo, min=1.0)
    # IEEE division on every device, as the kernel divides: PyTorch on CUDA
    # turns a division by a Python number into a product with its float32
    # reciprocal, which moved bin widths by an ulp against the CPU and K2
    pooled_t = torch.full_like(extent, pooled)
    bin_sz = extent / pooled_t
    # ceil(extent / pooled), exact for every extent: a reciprocal multiply
    # would make ceil(21 * (1/7)) = 4
    q = torch.floor(extent / pooled_t)
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


def roi_weights(rois, h: int, w: int, output_size: int = 7,
                spatial_scale: float = 1.0 / 16.0, max_samples: int = 16):
    """rois [B,R,4|5] in image coordinates (a leading batch-index column
    is ignored) on an h x w feature map -> (Wy [B,R,P,h], Wx [B,R,P,w])."""
    r = rois[..., -4:].float() * spatial_scale
    wy = _axis_weights(r[..., 1], r[..., 3], h, output_size, max_samples)
    wx = _axis_weights(r[..., 0], r[..., 2], w, output_size, max_samples)
    return wy, wx


def roi_align_pw_plain(feat, wy, wx):
    """feat [B,H,W,C], Wy [B,R,P,H], Wx [B,R,P,W] -> [B,R,P,P,C]: the two
    contractions, per image (the [R,P,W,C] stage is large)."""
    outs = []
    for i in range(feat.shape[0]):
        tmp = torch.einsum('rph,hwc->rpwc', wy[i], feat[i])
        outs.append(torch.einsum('rqw,rpwc->rpqc', wx[i], tmp))
    return torch.stack(outs)


def roi_align_pw_backward(grad, wy, wx):
    """The gradient of `roi_align_pw_plain` for feat: grad [B,R,P,P,C] ->
    [B,H,W,C], grad_feat[h,w] = sum_{r,p} Wy[r,p,h] sum_q Wx[r,q,w]
    grad[r,p,q], two contractions per image."""
    outs = []
    for i in range(grad.shape[0]):
        tmp = torch.einsum('rqw,rpqc->rpwc', wx[i], grad[i])
        outs.append(torch.einsum('rph,rpwc->hwc', wy[i], tmp))
    return torch.stack(outs)


def roi_align_plain(feat, rois, output_size: int = 7,
                    spatial_scale: float = 1.0 / 16.0, max_samples: int = 16):
    """feat [B,H,W,C] float32, rois [B,R,4|5] (a leading batch-index
    column is ignored; rois are grouped per image) -> [B,R,P,P,C]."""
    wy, wx = roi_weights(rois, feat.shape[1], feat.shape[2], output_size,
                         spatial_scale, max_samples)
    return roi_align_pw_plain(feat, wy, wx)


def _lib():
    lib = build.load('roi_align')
    if lib.roi_align_fwd_f32.argtypes is None:
        lib.roi_align_fwd_f32.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.roi_align_fwd_f32.restype = ctypes.c_int
        lib.roi_align_fwd_max_samples.restype = ctypes.c_int
        lib.roi_align_pw_f32.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.roi_align_pw_f32.restype = ctypes.c_int
        lib.roi_align_pw_pooled_ok.argtypes = [ctypes.c_int]
        lib.roi_align_pw_pooled_ok.restype = ctypes.c_int
    return lib


def _check_body(name, feat, p):
    """The shared body's contract (float4 channels, P = 5 or 7); -> the
    loaded library."""
    c = feat.shape[-1]
    if c % 4 or feat.data_ptr() % 16:
        raise ValueError(f'{name} kernel reads feat as float4: needs '
                         f'C % 4 == 0 (C={c}) and 16-byte aligned feat')
    lib = _lib()
    if not lib.roi_align_pw_pooled_ok(p):
        raise ValueError(f'{name} kernel is built for P = 5 and 7 '
                         f'(got {p})')
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
    lib = _check_body('roi_align', feat, output_size)
    if not 1 <= max_samples <= lib.roi_align_fwd_max_samples():
        raise ValueError(f'roi_align kernel supports 1 <= max_samples <= '
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


def roi_align_pw(feat, wy, wx):
    """RoIAlign from precomputed axis weights: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.  Same arguments as
    `roi_align_pw_plain`."""
    if feat.device.type == 'cpu':
        return roi_align_pw_plain(feat, wy, wx)
    ts = (feat, wy, wx)
    if feat.device.type != 'cuda' or any(t.device != feat.device for t in ts):
        raise ValueError('roi_align_pw: inputs must be on one CUDA device '
                         f'(got {[str(t.device) for t in ts]})')
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError('roi_align_pw kernel takes float32 inputs '
                        f'(got {[t.dtype for t in ts]})')
    if feat.dim() != 4 or wy.dim() != 4 or wx.dim() != 4:
        raise ValueError('roi_align_pw: bad ranks')
    b, h, w, c = feat.shape
    r, p = wy.shape[1:3]
    if wy.shape != (b, r, p, h) or wx.shape != (b, r, p, w):
        raise ValueError(f'roi_align_pw: shapes feat {tuple(feat.shape)}, '
                         f'wy {tuple(wy.shape)}, wx {tuple(wx.shape)} do '
                         'not agree')
    if not all(t.is_contiguous() for t in ts):
        raise ValueError('roi_align_pw kernel takes contiguous tensors')
    lib = _check_body('roi_align_pw', feat, p)
    out = torch.empty(b, r, p, p, c, device=feat.device, dtype=torch.float32)
    with torch.cuda.device(feat.device):
        err = lib.roi_align_pw_f32(
            feat.data_ptr(), wy.data_ptr(), wx.data_ptr(), out.data_ptr(),
            b, r, h, w, c, p,
            torch.cuda.current_stream(feat.device).cuda_stream)
    build.check(err, 'roi_align_pw')
    roi_align_pw.launches += 1
    return out


roi_align_pw.launches = 0


class _RoIAlignPW(torch.autograd.Function):
    """roi_align_pw with the plain contraction backward; gradient for feat
    only (the weights come from the rois, which have none)."""

    @staticmethod
    def forward(ctx, feat, wy, wx):
        ctx.save_for_backward(wy, wx)
        return roi_align_pw(feat, wy, wx)

    @staticmethod
    def backward(ctx, grad):
        wy, wx = ctx.saved_tensors
        return roi_align_pw_backward(grad.contiguous(), wy, wx), None, None


def roi_align_train(feat, rois, output_size: int = 7,
                    spatial_scale: float = 1.0 / 16.0, max_samples: int = 16):
    """The training step's RoIAlign, differentiable in feat: Wy / Wx are
    built once, pooled with `roi_align_pw` (K3 on the card) and kept for
    the backward.  Same arguments and result as `roi_align_plain`."""
    with torch.no_grad():
        wy, wx = roi_weights(rois, feat.shape[1], feat.shape[2],
                             output_size, spatial_scale, max_samples)
    return _RoIAlignPW.apply(feat, wy.contiguous(), wx.contiguous())
