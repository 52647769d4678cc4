"""The trunk's BN-act epilogue: a frozen BatchNorm, the block's residual
and the ReLU after a trunk conv in one pass.

    y = relu((x * s + o) + r')      r' = r, or r * s_r + o_r, or absent

x is a conv's output [N, C, H, W], s and o its frozen BN's scale and
offset [C] (models/layers.py `frozen_bn_affine`), r the block's residual:
the block's input, or the downsample conv's output under its own BN (s_r,
o_r).  It replaces no Pallas kernel (the JAX package leaves the chain to
XLA, which fuses it into the conv); it was added because PyTorch runs the
chain as three to nine elementwise passes over the conv's output, where
one read of x (and r) and one write of y is the least.  The pass is bound
by its bytes at 3.35 TB/s.

`bn_act` runs `_BnAct`, the one autograd formula, which calls the kernel
wrappers directly; under a trace it is the registered op
`dana_torch::bn_act` (with a fake implementation, no autograd formula),
so an exported serving program holds one call.  CPU tensors run
`bn_act_plain`, the chain as separate PyTorch ops; CUDA float32 and
bfloat16 tensors launch `csrc/bn_act.cu`, which rounds after every
operation as those ops do (`__fmul_rn` / `__fadd_rn`, a round to bfloat16
after each in bfloat16), so its output equals the plain chain's bit for
bit; a CUDA tensor of another dtype is refused.  The backward reads the
incoming gradient g and the saved output y once: m = (y <= 0) ? 0 : g
(PyTorch's ReLU backward), g_x = m * s and g_r = m * s_r, or m itself for
an identity residual: autograd's gradients of the plain chain, bit for
bit.

The kernels read the layout from the strides: x, r and y (g, y, g_x and
g_r) in one layout with the channels innermost, dense, C a multiple of
the 16-byte vector (4 float32, 8 bfloat16) and 16-byte aligned pointers
take the vector path; anything else the strided path.  Each launch is
counted in the counter table (utils/trace.py `launched`): `bn_act.<dtype>`
and `bn_act_backward.<dtype>`, each also by device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from dana_tpu_torch.ops import build
from dana_tpu_torch.utils import trace

_DTYPES = {torch.float32: 'f32', torch.bfloat16: 'bf16'}
_BLOCKS_PER_SM = 8


def _c(v):
    """A per-channel vector [C] broadcast over NCHW."""
    return v[:, None, None]


def bn_act_plain(x, scale, offset, residual=None, rscale=None, roffset=None):
    """The epilogue as the separate PyTorch ops it replaces: the frozen BN
    (`x * s + o`), the residual's own BN, the sum and the ReLU, each
    rounded to x's dtype."""
    y = x * _c(scale) + _c(offset)
    if residual is not None:
        if rscale is not None:
            residual = residual * _c(rscale) + _c(roffset)
        y = y + residual
    return F.relu(y)


def bn_act_backward_plain(grad, y, scale, rscale, residual):
    """Autograd's backward of `bn_act_plain` from its output y ->
    (g_x, g_r): g_r is m, or m * s_r under a residual BN, and None
    without a residual."""
    m = torch.ops.aten.threshold_backward(grad, y, 0)
    if not residual:
        return m * _c(scale), None
    return m * _c(scale), (m if rscale is None else m * _c(rscale))


@torch.library.custom_op('dana_torch::bn_act', mutates_args=())
def bn_act_op(x: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor,
              residual: Optional[torch.Tensor],
              rscale: Optional[torch.Tensor],
              roffset: Optional[torch.Tensor]) -> torch.Tensor:
    """The epilogue as one op, the call an exported program holds: x
    [N,C,H,W], scale / offset [C] in x's dtype, residual (optional) like
    x, rscale / roffset (both or neither, with a residual) its BN -> y
    like x.  CPU tensors: `bn_act_plain`.  It has no autograd formula:
    a program is exported for serving, without gradients."""
    return bn_act_plain(x, scale, offset, residual, rscale, roffset)


@bn_act_op.register_fake
def _(x, scale, offset, residual, rscale, roffset):
    return torch.empty_like(x)


def _forward(x, scale, offset, residual, rscale, roffset):
    """The epilogue on x's device: the kernel on a CUDA card,
    `bn_act_plain` on the CPU."""
    if x.is_cuda:
        return _forward_cuda(x, scale, offset, residual, rscale, roffset)
    if x.device.type != 'cpu':
        raise ValueError(f'bn_act: operands must be CPU or CUDA tensors (got '
                         f'{x.device})')
    return bn_act_plain(x, scale, offset, residual, rscale, roffset)


def bn_act_backward(grad, y, scale, rscale, residual):
    """The epilogue's backward from its output y on y's device (the kernel
    on a CUDA card, `bn_act_backward_plain` on the CPU) -> (g_x, g_r, None
    when `residual` is False)."""
    if y.is_cuda:
        return _backward_cuda(grad, y, scale, rscale, residual)
    return bn_act_backward_plain(grad, y, scale, rscale, residual)


class _BnAct(torch.autograd.Function):
    """The epilogue's one autograd formula, differentiable in x and the
    residual; the kernels are called directly, not through the op's
    dispatch, which costs more host time a launch than the kernel's own
    wrapper (PERF.md §6), and the training forward is bound by the
    host's launches."""

    @staticmethod
    def forward(ctx, x, scale, offset, residual, rscale, roffset):
        if any(ctx.needs_input_grad[i] for i in (1, 2, 4, 5)):
            raise ValueError("bn_act: a frozen BN's scale and offset take "
                             'no gradient')
        y = _forward(x, scale, offset, residual, rscale, roffset)
        ctx.save_for_backward(y, scale, rscale)
        ctx.residual = residual is not None
        return y

    @staticmethod
    def backward(ctx, grad):
        y, scale, rscale = ctx.saved_tensors
        want_r = ctx.residual and ctx.needs_input_grad[3]
        gx, gr = bn_act_backward(grad, y, scale, rscale, want_r)
        return (gx if ctx.needs_input_grad[0] else None, None, None, gr,
                None, None)


# ------------------------------------------------------------------ CUDA

class _Shapes(ctypes.Structure):
    """csrc/bn_act.cu `Shapes`: the sizes [N, C, H, W] and the strides, in
    elements, of up to four operands, for the strided path."""
    _fields_ = [('size', ctypes.c_int64 * 4),
                ('stride', (ctypes.c_int64 * 4) * 4)]


@functools.cache
def _lib():
    lib = build.load('bn_act')
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for name in _DTYPES.values():
        fwd = getattr(lib, f'bn_act_{name}')
        fwd.argtypes = [ptr] * 8 + [i64] + [i32] * 4 + [ptr]
        bwd = getattr(lib, f'bn_act_backward_{name}')
        bwd.argtypes = [ptr] * 7 + [i64] + [i32] * 3 + [ptr]
        fwd.restype = bwd.restype = ctypes.c_int
    return lib


@functools.cache
def _max_blocks(device):
    """A launch's most blocks: enough resident threads on every SM to keep
    its loads in flight."""
    return (torch.cuda.get_device_properties(device).multi_processor_count
            * _BLOCKS_PER_SM)


def _layout(ts):
    """-> (the strided path's shapes, or None where the tensors ts
    [N,C,H,W] take the vector path: one dense layout with the channels
    innermost, C a multiple of the 16-byte vector, every pointer 16-byte
    aligned)."""
    t0 = ts[0]
    if (t0.shape[1] % (16 // t0.element_size()) == 0
            and t0.is_contiguous(memory_format=torch.channels_last)
            and all(t.stride() == t0.stride() and t.data_ptr() % 16 == 0
                    for t in ts)):
        return None
    shapes = _Shapes()
    shapes.size[:] = list(t0.shape)
    for k, t in enumerate(ts):
        shapes.stride[k][:] = list(t.stride())
    return shapes


def _check(name, ts, vectors):
    """One CUDA device and dtype for every operand, [N,C,H,W] tensors of
    one shape, contiguous 16-byte aligned [C] vectors."""
    t0 = ts[0]
    if t0.dim() != 4:
        raise ValueError(f'{name} kernel takes [N,C,H,W] tensors (got '
                         f'{tuple(t0.shape)})')
    for t in (*ts, *vectors):
        if t.device != t0.device or t.dtype != t0.dtype:
            raise TypeError(f'{name}: every operand must be {t0.dtype} on '
                            f'{t0.device} (got {t.dtype} on {t.device})')
    if any(t.shape != t0.shape for t in ts):
        raise ValueError(f'{name}: operands {[tuple(t.shape) for t in ts]} '
                         'differ in shape')
    c = t0.shape[1]
    if any(v.shape != (c,) or not v.is_contiguous() or v.data_ptr() % 16
           for v in vectors):
        raise ValueError(f'{name} kernel reads contiguous, 16-byte aligned '
                         f'[C={c}] vectors')


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def _byref(shapes):
    """The strided path's shapes for the kernel, or a null pointer, which
    selects the vector path."""
    return None if shapes is None else ctypes.byref(shapes)


@bn_act_op.register_kernel('cuda')
def _forward_cuda(x, scale, offset, residual, rscale, roffset):
    if x.dtype not in _DTYPES:
        raise TypeError(f'bn_act kernel takes float32 or bfloat16 (got '
                        f'{x.dtype})')
    if (rscale is None) != (roffset is None) \
            or (residual is None and rscale is not None):
        raise ValueError('bn_act: a residual BN takes rscale, roffset and '
                         'the residual')
    ts = [x] if residual is None else [x, residual]
    vectors = [v for v in (scale, offset, rscale, roffset) if v is not None]
    _check('bn_act', ts, vectors)
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    shapes = _layout([*ts, y] if residual is not None else [x, x, y])
    with torch.cuda.device(x.device):
        err = getattr(_lib(), f'bn_act_{_DTYPES[x.dtype]}')(
            x.data_ptr(), scale.data_ptr(), offset.data_ptr(),
            _ptr(residual), _ptr(rscale), _ptr(roffset), y.data_ptr(),
            _byref(shapes), x.numel(), x.shape[1],
            int(residual is not None), int(rscale is not None),
            _max_blocks(x.device), _stream(x))
    build.check(err, 'bn_act')
    trace.launched('bn_act', x.device, x.dtype)
    return y


def _backward_cuda(grad, y, scale, rscale, residual):
    if y.dtype not in _DTYPES:
        raise TypeError(f'bn_act_backward kernel takes float32 or bfloat16 '
                        f'(got {y.dtype})')
    vectors = [scale] if rscale is None else [scale, rscale]
    _check('bn_act_backward', [grad, y], vectors)
    # in the layout PyTorch's ReLU backward gives: y's
    gx = torch.empty_like(y)
    gr = torch.empty_like(y) if residual else None
    if gx.numel() == 0:
        return gx, gr
    mode = 0 if not residual else 1 if rscale is None else 2
    shapes = _layout([grad, y, gx, gx if gr is None else gr])
    with torch.cuda.device(y.device):
        err = getattr(_lib(), f'bn_act_backward_{_DTYPES[y.dtype]}')(
            grad.data_ptr(), y.data_ptr(), scale.data_ptr(), _ptr(rscale),
            gx.data_ptr(), _ptr(gr), _byref(shapes), y.numel(), y.shape[1],
            mode, _max_blocks(y.device), _stream(y))
    build.check(err, 'bn_act_backward')
    trace.launched('bn_act_backward', y.device, y.dtype)
    return gx, gr


def bn_act(x, scale, offset, residual=None, rscale=None, roffset=None):
    """The epilogue, differentiable in x and the residual (same arguments
    as `bn_act_plain`): the kernel for CUDA float32 / bfloat16 tensors,
    `bn_act_plain` for CPU tensors.  Under a trace (`torch.export`) it is
    the op `dana_torch::bn_act`, one call in the program."""
    if torch.compiler.is_compiling():
        return bn_act_op(x, scale, offset, residual, rscale, roffset)
    return _BnAct.apply(x, scale, offset, residual, rscale, roffset)
