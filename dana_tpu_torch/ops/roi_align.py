"""RoIAlign over NHWC features (port of dana_tpu/ops/roi_align.py, its
float32 path and its bfloat16 "combine" path, and of the two Pallas kernels
in dana_tpu/ops/roi_align_pallas.py).

RoIAlign is separable (the JAX package's float32 form):

    pooled[r, ph, pw, c] = sum_h sum_w Wy[r, ph, h] * Wx[r, pw, w] * feat[h, w, c]

with Wy / Wx built per axis from the roi coordinates (`roi_weights`:
adaptive sample count by floor plus exact-product correction, capped at
`max_samples`, and the clamp rules of the reference CUDA kernel).

Two entries, each a hand-written kernel for CUDA tensors and its plain
version for CPU tensors; `roi_align` enters through one registered op,
`dana_torch::roi_align` (`roi_align_op`), with a fake implementation, so
a traced or exported serving program holds the kernel as one call.  Their
float32 kernels are in `csrc/roi_align.cu` and share one body that pools
a row of bins (b, r, ph) from its kept taps; they differ in where the
taps come from:
  * `roi_align` (serving): the kernel builds Wy / Wx from the rois; plain
    twin `roi_align_plain`.
  * `roi_align_pw` (training): the kernel takes precomputed Wy / Wx; plain
    twin `roi_align_pw_plain`.
Both take P = 5 or 7, C % 4 == 0 and 16-byte aligned feat (the body reads
float4 channel groups), and raise on anything else.

In bfloat16 (the precision recipe's serving path) `roi_align` launches
`roi_align_fwd_bf16` (C % 8 == 0), whose arithmetic is the JAX package's
bf16 path: each tap's weight is bf16(Wy * Wx), the product of the float32
axis weights rounded to bf16, the sums are float32 and the output is
rounded to bf16 once; its plain twin is `roi_align_combine_plain`.  The
kernel does it as one tensor-core product a roi over the roi's kept taps,
the rectangle `roi_tap_extent` gives; the axis weights are the same float32
ones (rois taken in float32).  Both wrappers count each launch in the
counter table (`utils/trace.py` `launched`): `roi_align.float32`,
`roi_align.bfloat16` and `roi_align_pw.float32`, each also by device.
`roi_align_train` is the training step's differentiable RoIAlign: it
builds Wy / Wx once and keeps them for the backward (no gradient for the
rois, which come from the sampler).  On a float32 map it pools with
`roi_align_pw` and its backward contracts the same weights with the
output gradient (`roi_align_pw_backward`); on a bf16 map it pools with
`roi_align` (K2-bf16) and its backward is the VJP of the JAX package's
bf16 combine path, bf16(sum bf16(Wy * Wx) * grad) with float32 sums
(`roi_align_combine_backward`).  Both backward passes are plain tensor
math.

`roi_align_int8` is the JAX package's int8 serving RoIAlign, which it
takes on a map that is not float32 under TPU.QUANT_INT8: the combined
weights and the map quantized to int8 and one exact int32 product an
image, which XLA computes outside any Pallas kernel; on the card the
product is `torch._int_mm`.
"""

from __future__ import annotations

import ctypes

import torch

from dana_tpu_torch.ops import build
from dana_tpu_torch.utils import trace


def _axis_samples(lo, hi, size: int, pooled: int, max_samples: int):
    """The bilinear samples of one axis from roi start/end `lo`, `hi` [...]
    in feature coordinates: (low index, high index, low weight, high
    weight) [..., pooled, max_samples] (weight 0 past the bin's count), and
    the count [...]."""
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
    return x_low, x_high, w * (1.0 - frac), w * frac, count


def _axis_weights(lo, hi, size: int, pooled: int, max_samples: int):
    """[..., pooled, size] interpolation weights for one axis from roi
    start/end `lo`, `hi` [...] in feature coordinates."""
    x_low, x_high, w_low, w_high, _ = _axis_samples(lo, hi, size, pooled,
                                                    max_samples)
    u = torch.arange(size, device=lo.device, dtype=lo.dtype)
    contrib = ((u == x_low[..., None]) * w_low[..., None]
               + (u == x_high[..., None]) * w_high[..., None])
    return contrib.sum(dim=-2)                                  # [...,P,size]


def _axis_span(lo, hi, size: int, pooled: int, max_samples: int):
    """[..., size] bool: the span of the map one axis's samples touch, from
    the low index of bin 0's first sample to the high index of bin P-1's
    last (the indices grow with the sample)."""
    x_low, x_high, _, _, count = _axis_samples(lo, hi, size, pooled,
                                               max_samples)
    first = x_low[..., 0, 0]
    last = torch.gather(x_high[..., -1, :], -1,
                        count.long()[..., None] - 1)[..., 0]
    u = torch.arange(size, device=lo.device, dtype=lo.dtype)
    return (u >= first[..., None]) & (u <= last[..., None])


def roi_weights(rois, h: int, w: int, output_size: int = 7,
                spatial_scale: float = 1.0 / 16.0, max_samples: int = 16):
    """rois [B,R,4|5] in image coordinates (a leading batch-index column
    is ignored) on an h x w feature map -> (Wy [B,R,P,h], Wx [B,R,P,w])."""
    r = rois[..., -4:].float() * spatial_scale
    wy = _axis_weights(r[..., 1], r[..., 3], h, output_size, max_samples)
    wx = _axis_weights(r[..., 0], r[..., 2], w, output_size, max_samples)
    return wy, wx


def roi_tap_extent(rois, h: int, w: int, output_size: int = 7,
                   spatial_scale: float = 1.0 / 16.0, max_samples: int = 16):
    """The taps the bf16 kernel pools for each roi: (rows [B,R,h], columns
    [B,R,w]) bool, each axis's span of the map from the low index of bin
    0's first sample to the high index of bin P-1's last; the taps are
    rows x columns.  Every nonzero weight lies inside (a sample's indices
    lie between those two); rows and columns inside it may weigh 0 (gaps
    between capped samples, samples outside the map).  For the byte model
    of the kernel and its tests; the serving path does not call it."""
    r = rois[..., -4:].float() * spatial_scale
    return (_axis_span(r[..., 1], r[..., 3], h, output_size, max_samples),
            _axis_span(r[..., 0], r[..., 2], w, output_size, max_samples))


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


def roi_align_combine_plain(feat, wy, wx):
    """bf16 feat [B,H,W,C], float32 Wy [B,R,P,H], Wx [B,R,P,W] ->
    [B,R,P,P,C] in feat's dtype: the JAX bf16 path, per image: the
    combined weights bf16(Wy[p,h] * Wx[q,w]) [R,P,P,H,W] against the map
    with float32 sums, rounded once."""
    b, h, w, c = feat.shape
    outs = []
    for i in range(b):
        comb = torch.einsum('rph,rqw->rpqhw', wy[i], wx[i]).to(feat.dtype)
        out = comb.float().reshape(-1, h * w) @ feat[i].float().reshape(
            h * w, c)
        outs.append(out.reshape(*comb.shape[:3], c).to(feat.dtype))
    return torch.stack(outs)


def roi_align_combine_backward(grad, wy, wx):
    """The gradient of `roi_align_combine_plain` for feat, the VJP of the
    JAX package's bf16 combine path: grad [B,R,P,P,C] bf16, float32 Wy
    [B,R,P,H], Wx [B,R,P,W] -> [B,H,W,C] in grad's dtype,
    bf16(sum_{r,p,q} bf16(Wy[r,p,h] * Wx[r,q,w]) * grad[r,p,q]) with
    float32 sums, rounded once.  One product over all images: the combined
    weights [B, R*P*P, H*W] against the gradient [B, R*P*P, C]; on the card
    a bf16 product with float32 accumulation (cuBLAS rounds its float32
    sums once; `use_full_f32` keeps its split sums in float32), on the CPU
    the same in float32."""
    b, r, p, _, c = grad.shape
    h, w = wy.shape[-1], wx.shape[-1]
    comb = torch.einsum('brph,brqw->brpqhw', wy, wx).to(grad.dtype) \
        .reshape(b, r * p * p, h * w)
    g = grad.reshape(b, r * p * p, c)
    if grad.device.type == 'cuda':
        out = torch.bmm(comb.transpose(1, 2), g)
    else:
        out = torch.bmm(comb.float().transpose(1, 2), g.float())
    return out.to(grad.dtype).reshape(b, h, w, c)


def roi_align_plain(feat, rois, output_size: int = 7,
                    spatial_scale: float = 1.0 / 16.0, max_samples: int = 16):
    """feat [B,H,W,C] float32 or bfloat16, rois [B,R,4|5] (a leading
    batch-index column is ignored; rois are grouped per image) ->
    [B,R,P,P,C] in feat's dtype."""
    wy, wx = roi_weights(rois, feat.shape[1], feat.shape[2], output_size,
                         spatial_scale, max_samples)
    if feat.dtype == torch.float32:
        return roi_align_pw_plain(feat, wy, wx)
    return roi_align_combine_plain(feat, wy, wx)


def quantize_roi_weights(wy, wx):
    """One image's axis weights Wy [R,P,H], Wx [R,P,W] (float32) -> the
    JAX package's int8 RoIAlign weights: the combined weights Wy[p,h] *
    Wx[q,w] [R,P,P,H,W] in float32, quantized per (roi, bin) row by its
    exact max (sw = max(rowmax, 1e-8) / 127; the weights are >= 0, so no
    clip) -> (wq int8 [R*P*P, H*W], sw float32 [R,P,P]).  A row's max is
    the product of its two factors' maxes: float32 rounding is monotone,
    so for factors >= 0 the largest rounded product is the rounded product
    of the largest factors."""
    r, p, h = wy.shape
    comb = wy[:, :, None, :, None] * wx[:, None, :, None, :]
    rowmax = wy.amax(-1)[:, :, None] * wx.amax(-1)[:, None, :]
    sw = torch.clamp(rowmax, min=1e-8) / torch.full_like(rowmax, 127.0)
    wq = comb.div_(sw[..., None, None]).round_().to(torch.int8)
    return wq.reshape(r * p * p, -1), sw


def quantize_map(f):
    """One image's map [H,W,C] -> (fq int8 [H*W, C], sf float32 0-d): the
    per-image scale sf = max(max|f|, 1e-8) / 127 and clip(round(f / sf),
    -127, 127)."""
    ff = f.float()
    lo, hi = torch.aminmax(ff)
    amax = torch.maximum(-lo, hi)
    sf = torch.clamp(amax, min=1e-8) / torch.full_like(amax, 127.0)
    fq = (ff / sf).round_().clamp_(-127, 127).to(torch.int8)
    return fq.reshape(-1, f.shape[-1]), sf


def roi_align_int8(feat, rois, output_size: int = 7,
                   spatial_scale: float = 1.0 / 16.0, max_samples: int = 16):
    """The JAX package's int8 serving RoIAlign (`roi_align(int8=True)` on a
    map that is not float32): per image, the combined weights quantized per
    (roi, bin) row (`quantize_roi_weights`) against the map quantized per
    image (`quantize_map`), the exact int32 product (`layers.int8_matmul`:
    `torch._int_mm` on CUDA tensors, its plain version on CPU tensors),
    then acc * (sw * sf) cast to feat's dtype.  Same arguments and result
    shape as `roi_align_plain`; counts each call in the counter table's
    `roi_align_int8.runs`.
    The weights are `roi_weights`' float32 axis weights, as the other
    paths use."""
    from dana_tpu_torch.models.layers import int8_matmul
    b, h, w, c = feat.shape
    wy, wx = roi_weights(rois, h, w, output_size, spatial_scale, max_samples)
    outs = []
    for i in range(b):
        wq, sw = quantize_roi_weights(wy[i], wx[i])
        fq, sf = quantize_map(feat[i])
        acc = int8_matmul(wq, fq)
        out = acc.float().reshape(*sw.shape, c) * (sw[..., None] * sf)
        outs.append(out.to(feat.dtype))
    trace.count('roi_align_int8.runs')
    return torch.stack(outs)


def _lib():
    lib = build.load('roi_align')
    if lib.roi_align_fwd_f32.argtypes is None:
        lib.roi_align_fwd_f32.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.roi_align_fwd_f32.restype = ctypes.c_int
        lib.roi_align_fwd_bf16.argtypes = lib.roi_align_fwd_f32.argtypes
        lib.roi_align_fwd_bf16.restype = ctypes.c_int
        lib.roi_align_fwd_max_samples.restype = ctypes.c_int
        lib.roi_align_pw_f32.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.roi_align_pw_f32.restype = ctypes.c_int
        lib.roi_align_pw_pooled_ok.argtypes = [ctypes.c_int]
        lib.roi_align_pw_pooled_ok.restype = ctypes.c_int
    return lib


def _check_body(name, feat, p):
    """The shared body's contract (16-byte channel groups, P = 5 or 7);
    -> the loaded library."""
    c, step = feat.shape[-1], 16 // feat.element_size()
    groups = 'float4' if step == 4 else f'16-byte groups of {step} channels'
    if c % step or feat.data_ptr() % 16:
        raise ValueError(f'{name} kernel reads feat as {groups}: needs '
                         f'C % {step} == 0 (C={c}) and 16-byte aligned feat')
    lib = _lib()
    if not lib.roi_align_pw_pooled_ok(p):
        raise ValueError(f'{name} kernel is built for P = 5 and 7 '
                         f'(got {p})')
    return lib


@torch.library.custom_op('dana_torch::roi_align', mutates_args=())
def roi_align_op(feat: torch.Tensor, rois: torch.Tensor, output_size: int,
                 spatial_scale: float, max_samples: int) -> torch.Tensor:
    """`roi_align` as one registered op: CPU tensors run `roi_align_plain`,
    CUDA tensors the kernel of feat's dtype, one launch counted on
    `roi_align`."""
    return roi_align_plain(feat, rois, output_size, spatial_scale,
                           max_samples)


@roi_align_op.register_fake
def _(feat, rois, output_size, spatial_scale, max_samples):
    return feat.new_empty(feat.shape[0], rois.shape[1], output_size,
                          output_size, feat.shape[-1])


@roi_align_op.register_kernel('cuda')
def _(feat, rois, output_size, spatial_scale, max_samples):
    if feat.device.type != 'cuda' or rois.device != feat.device:
        raise ValueError('roi_align: feat and rois must be on one CUDA '
                         f'device (got {feat.device}, {rois.device})')
    bf16 = feat.dtype == torch.bfloat16
    if bf16 and rois.dtype in (torch.bfloat16, torch.float32):
        rois = rois.float()
    elif feat.dtype != torch.float32 or rois.dtype != torch.float32:
        raise TypeError('roi_align kernels take float32 feat and rois, or '
                        f'bf16 feat (got {feat.dtype}, {rois.dtype})')
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
                      dtype=feat.dtype)
    entry = lib.roi_align_fwd_bf16 if bf16 else lib.roi_align_fwd_f32
    with torch.cuda.device(feat.device):
        err = entry(
            feat.data_ptr(), rois.data_ptr(), out.data_ptr(), b, r, h, w, c,
            rois.shape[-1], output_size, spatial_scale, max_samples,
            torch.cuda.current_stream(feat.device).cuda_stream)
    build.check(err, 'roi_align_fwd_bf16' if bf16 else 'roi_align_fwd')
    trace.launched('roi_align', feat.device, feat.dtype)
    return out


def roi_align(feat, rois, output_size: int = 7,
              spatial_scale: float = 1.0 / 16.0, max_samples: int = 16):
    """RoIAlign forward through `roi_align_op`: the CUDA kernel of feat's
    dtype for CUDA tensors (float32 feat with float32 rois; bf16 feat with
    float32 or bf16 rois, read as float32), the plain version for CPU
    tensors; tensors on another device are refused.  Same arguments as
    `roi_align_plain`."""
    if feat.device.type not in ('cpu', 'cuda') \
            or rois.device.type not in ('cpu', 'cuda'):
        raise ValueError('roi_align: feat and rois must be CPU or CUDA '
                         f'tensors (got {feat.device}, {rois.device})')
    return roi_align_op(feat, rois, int(output_size), float(spatial_scale),
                        int(max_samples))


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
    trace.launched('roi_align_pw', feat.device, torch.float32)
    return out


class _RoIAlignTrain(torch.autograd.Function):
    """The training RoIAlign from the rois' axis weights Wy, Wx: float32
    feat pools with `roi_align_pw` (K3) and contracts the weights back in
    the backward; bf16 feat pools with `roi_align` (K2-bf16, which builds
    the same weights from the rois) and takes the combine path's VJP.
    Gradient for feat only (the weights come from the rois, which have
    none)."""

    @staticmethod
    def forward(ctx, feat, rois, wy, wx, output_size, spatial_scale,
                max_samples):
        ctx.save_for_backward(wy, wx)
        if feat.dtype == torch.float32:
            return roi_align_pw(feat, wy, wx)
        return roi_align(feat, rois, output_size, spatial_scale, max_samples)

    @staticmethod
    def backward(ctx, grad):
        wy, wx = ctx.saved_tensors
        fn = roi_align_pw_backward if grad.dtype == torch.float32 \
            else roi_align_combine_backward
        return fn(grad.contiguous(), wy, wx), None, None, None, None, None, \
            None


def roi_align_train(feat, rois, output_size: int = 7,
                    spatial_scale: float = 1.0 / 16.0, max_samples: int = 16):
    """The training step's RoIAlign, differentiable in feat: Wy / Wx are
    built once from the rois (in float32, as K2-bf16 reads bf16 rois) and
    kept for the backward; a float32 map pools with `roi_align_pw` (K3 on
    the card), a bf16 map with `roi_align` (K2-bf16).  Same arguments and
    result as `roi_align_plain`."""
    with torch.no_grad():
        wy, wx = roi_weights(rois, feat.shape[1], feat.shape[2],
                             output_size, spatial_scale, max_samples)
    return _RoIAlignTrain.apply(feat, rois.contiguous(), wy.contiguous(),
                                wx.contiguous(), output_size, spatial_scale,
                                max_samples)
