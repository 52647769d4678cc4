"""Building blocks (port of dana_tpu/models/layers.py).

Convolutions and linears are torch's (`Conv2d` and `Linear` below keep
nn.Conv2d's and nn.Linear's parameters and names), activations too (F.relu;
F.leaky_relu's default slope 0.01 is the JAX one).  Mixed precision as in
the JAX layers: the parameters stay float32 masters, and each layer
computes in its input's dtype, casting its weights per call (a no-op in
float32).  The casts are explicit, not `torch.autocast`: autocast's op
lists (softmax and reductions promoted to float32, among others) do not
follow the JAX package's precision islands.
The trunk's modules work on NCHW tensors, which the public functions
make from NHWC inputs with a permute (a channels_last view, so cuDNN
keeps the NHWC memory order).  The trunk's BatchNorm is always frozen: an
affine transform with stored running statistics, as in the reference
detector; FGN's head has BatchNorms that train (`BatchNorm2d`).
Int8 serving (dana_tpu_torch/quant.py) swaps a trunk conv for a
`QuantConv2d`, the JAX package's dynamically quantized int8 conv: exact
int32 sums, on the card through `torch._int_mm` (`int8_matmul`, the op
`dana_torch::int8_mm`); on a grid its activation scale is the max over
every data row's input (`ScaleGroup`).

The numpy `init_*` helpers draw in the same order as the JAX package's,
so one seed gives both packages the same weights.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import threading

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dana_tpu_torch.ops.int8_mm import (int8_matmul,  # noqa: F401
                                        int8_matmul_plain, int_mm_operands)
from dana_tpu_torch.parallel.distributed import current_group
from dana_tpu_torch.utils import trace


class Conv2d(nn.Conv2d):
    """nn.Conv2d in its input's dtype: the weight and bias cast per call."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class QuantConv2d(nn.Module):
    """An int8-quantized conv (dana_tpu_torch/quant.py): buffers `w_int8`
    [O, C, kh, kw] int8, `w_scale` [O] float32 (per output channel) and
    `bias` [O] float32 (a quantized conv always has one: its BN's folded
    offset, or VGG16's own), under the name of the conv it replaces, so
    the state dict keeps the reference module names.  forward runs
    `dynamic_int8_conv`, whose activation scale is x's own max |x|, or
    under a `ScaleGroup` the max over every data row's input."""

    def __init__(self, cin, cout, kernel_size, stride=1, padding=0):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.register_buffer('w_int8', torch.zeros(
            cout, cin, kernel_size, kernel_size, dtype=torch.int8))
        self.register_buffer('w_scale', torch.zeros(cout))
        self.register_buffer('bias', torch.zeros(cout))

    def forward(self, x):
        return self.quantized_conv(x, self.w_int8, self.stride,
                                   self.padding)

    def quantized_conv(self, x, w_int8, stride, padding):
        """`dynamic_int8_conv` of x with this conv's scales and bias and
        the int8 weight `w_int8` (its own, or a rewrite of it with the same
        output channels: the space-to-depth stem's)."""
        amax = None if scale_group_row() is None \
            else group_amax(activation_amax(x))
        return dynamic_int8_conv(x, w_int8, self.w_scale, self.bias, stride,
                                 padding, amax)


def activation_amax(x):
    """max |x| over the whole of x, float32 0-d (one `aminmax` pass, no
    |x| tensor): the local half of the int8 conv's activation scale."""
    lo, hi = torch.aminmax(x.float())
    return torch.maximum(-lo, hi)


def activation_scale(amax):
    """The int8 conv's activation scale from max |x|: sx = max(amax, 1e-6)
    / 127, divided by a tensor, so every device divides as IEEE does
    (PyTorch on CUDA turns a division by a Python number into a product
    with its reciprocal)."""
    return torch.clamp(amax, min=1e-6) / torch.full_like(amax, 127.0)


def quantize_at(x, sx):
    """x quantized at the scale sx: clip(round(x / sx), -127, 127) (half
    to even), int8 in x's memory format."""
    return (x.float() / sx).round_().clamp_(-127, 127).to(torch.int8)


def quantize_activation(x, amax=None):
    """The dynamic per-tensor int8 quantization of the JAX package's int8
    conv -> (xq int8 in x's memory format, sx float32 0-d): sx from max |x|
    over the whole tensor (`activation_amax`), or from `amax` when the
    tensor the JAX conv sees is larger than x (a `ScaleGroup`'s max over
    every part of it)."""
    xf = x.float()
    sx = activation_scale(activation_amax(xf) if amax is None else amax)
    return quantize_at(xf, sx), sx


# a row that never reaches its next quantized conv fails the others' wait
_BARRIER_TIMEOUT_S = 600.0


class ScaleGroup:
    """The data rows of one grid request, which a quantized conv sees as
    one tensor: the JAX package's conv takes one activation scale over the
    global batch (GSPMD reduces the max across the chips), so every row's
    conv takes the max over all rows' inputs.  Each row runs in a thread of
    its own, inside `join(index)`; at each quantized conv every row leaves
    its local max |x| and waits at a barrier, then copies the rows' maxima
    to the lead device, reduces them there and copies the result back to
    its own, all in stream order (no host sync).  The slots alternate
    between two sets: a row can be at most one conv ahead of another.  A
    row that raises breaks the barrier, so the others raise too."""

    def __init__(self, size, lead):
        self.size, self.lead = int(size), torch.device(lead)
        self._barrier = threading.Barrier(self.size,
                                          timeout=_BARRIER_TIMEOUT_S)
        self._slots = ([None] * self.size, [None] * self.size)
        self._calls = threading.local()

    @contextlib.contextmanager
    def join(self, index):
        """Run this thread's row `index` in the group."""
        token = _SCALE_GROUP.set((self, int(index)))
        self._calls.n = 0
        try:
            yield self
        except BaseException:
            self._barrier.abort()
            raise
        finally:
            _SCALE_GROUP.reset(token)

    def amax(self, index, local):
        """The max over every row's `local` (0-d), on local's device."""
        slots = self._slots[self._calls.n % 2]
        self._calls.n += 1
        slots[index] = local
        self._barrier.wait()
        lead = torch.stack([t.to(self.lead) for t in slots]).amax()
        return lead.to(local.device)


_SCALE_GROUP = contextvars.ContextVar('dana_int8_scale_group', default=None)


def group_amax(local):
    """max |x| of the tensor a quantized conv sees: `local`, or under a
    `ScaleGroup` the max over every row's."""
    joined = _SCALE_GROUP.get()
    if joined is None:
        return local
    group, index = joined
    return group.amax(index, local)


def scale_group_row():
    """The row index this thread serves in a `ScaleGroup`, or None."""
    joined = _SCALE_GROUP.get()
    return None if joined is None else joined[1]


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def im2col_nhwc(xq, kh, kw, stride, padding):
    """[N, H, W, C] (any dtype) -> the conv's patches [N, Ho, Wo, kh*kw*C],
    each patch ordered (kh, kw, C), zero padded by `padding` (an int, or
    (rows, columns)): one strided slice per tap, concatenated (a 1x1 conv
    is its strided input)."""
    n, h, w, c = xq.shape
    ph, pw = _pair(padding)
    if ph or pw:
        xq = F.pad(xq, (0, 0, pw, pw, ph, ph))
    ho = (h + 2 * ph - kh) // stride + 1
    wo = (w + 2 * pw - kw) // stride + 1
    taps = [xq[:, i:i + stride * (ho - 1) + 1:stride,
               j:j + stride * (wo - 1) + 1:stride]
            for i in range(kh) for j in range(kw)]
    return taps[0] if len(taps) == 1 else torch.cat(taps, dim=-1)


def int8_conv_acc(xq, w_int8, stride=1, padding=0):
    """The int8 conv's exact int32 accumulators: xq [N, C, H, W] int8,
    w_int8 [O, C, kh, kw] int8, padding an int or (rows, columns) -> [N,
    Ho, Wo, O] int32: one `int8_matmul` (the op `dana_torch::int8_mm`:
    `torch._int_mm` on CUDA tensors, the exact float64 product on CPU
    tensors) of `conv_as_matmul`'s operands, so a traced program holds the
    same call for either device."""
    cols, wmat, shape = conv_as_matmul(xq, w_int8, stride, padding)
    return int8_matmul(cols, wmat).reshape(shape)


def conv_as_matmul(xq, w_int8, stride, padding):
    """The conv as one product: (the NHWC patches [N*Ho*Wo, kh*kw*C]
    (`im2col_nhwc`), the weights [kh*kw*C, O], the output shape [N, Ho,
    Wo, O])."""
    o, c, kh, kw = w_int8.shape
    cols = im2col_nhwc(xq.permute(0, 2, 3, 1), kh, kw, stride, padding)
    n, ho, wo, k = cols.shape
    # [O, kh*kw*C] rows (a view for a 1x1 conv), taken as [K, O]
    wmat = w_int8.permute(0, 2, 3, 1).reshape(o, k).t()
    return cols.reshape(n * ho * wo, k), wmat, (n, ho, wo, o)


def int8_conv_acc_plain(xq, w_int8, stride=1, padding=0):
    """`int8_conv_acc` as a float64 convolution of the int8 values, exact
    for the same reason as `int8_matmul_plain` (|acc| <= 127**2 * C kh kw,
    7.4e7 at 4608 terms); cuDNN is kept out on CUDA tensors (its float64
    algorithms need not sum exactly)."""
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(xq.double(), w_int8.double(), None, stride, padding)
    return acc.to(torch.int32).permute(0, 2, 3, 1)


def dynamic_int8_conv(x, w_int8, w_scale, bias, stride=1, padding=0,
                      amax=None):
    """The JAX package's dynamically quantized int8 conv
    (`layers._dynamic_int8_conv`) on NCHW x: `quantize_activation` (at
    max |x| of x, or `amax` when the conv's tensor is larger than x), the
    exact s8 x s8 -> s32 conv (`int8_conv_acc`; padding an int or (rows,
    columns)), then acc * (sx * w_scale) + bias in float32, cast back to
    x's dtype.  Returns an NCHW view of NHWC memory (channels_last, as the
    trunk runs); counts each call in the counter table's
    `dynamic_int8_conv.runs`."""
    xq, sx = quantize_activation(x, amax)
    acc = int8_conv_acc(xq, w_int8, stride, padding)
    y = acc.float().mul_(sx * w_scale)
    if bias is not None:
        y = y.add_(bias)
    trace.count('dynamic_int8_conv.runs')
    return nhwc_to_nchw(y.to(x.dtype))


class Linear(nn.Linear):
    """nn.Linear in its input's dtype: the weight and bias cast per call."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm2d in eval mode, eps 1e-5, over NCHW.  Its buffers carry
    the reference names (weight, bias, running_mean, running_var)."""

    def __init__(self, c, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer('weight', torch.ones(c))
        self.register_buffer('bias', torch.zeros(c))
        self.register_buffer('running_mean', torch.zeros(c))
        self.register_buffer('running_var', torch.ones(c))

    def forward(self, x):
        return frozen_batchnorm(x, self.weight, self.bias, self.running_mean,
                                self.running_var, self.eps)


class BatchNorm2d(nn.Module):
    """A head's BatchNorm2d over NCHW whose affine trains (FGN's bn1 and
    bn2): weight and bias are parameters, the running statistics buffers.
    forward(x, batch_stats): with batch statistics, which update the
    running ones in place (momentum 0.1; the biased variance normalises,
    the unbiased one enters the running variance, as torch's train-mode
    BatchNorm2d does), formed, applied and updated in float32 and cast back
    to x's dtype (the JAX package's `batchnorm_train`), else with the
    stored statistics.  Under data parallelism (the step's BatchGroup) the
    batch statistics are the global batch's: the count, then the sum and
    the sum of squared deviations from the global mean, each summed over
    the ranks with its gradient."""

    def __init__(self, c, eps=1e-5, momentum=0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer('running_mean', torch.zeros(c))
        self.register_buffer('running_var', torch.ones(c))

    def forward(self, x, batch_stats=False):
        if not batch_stats and x.dtype != self.weight.dtype:
            # the stored statistics in another precision, as the JAX head
            # applies them
            return frozen_batchnorm(x, self.weight, self.bias,
                                    self.running_mean, self.running_var,
                                    self.eps)
        g = current_group()
        if batch_stats and g.distributed:
            return self._global_batch_norm(x.float(), g).to(x.dtype)
        return F.batch_norm(x.float(), self.running_mean, self.running_var,
                            self.weight, self.bias, training=batch_stats,
                            momentum=self.momentum, eps=self.eps).to(x.dtype)

    def _global_batch_norm(self, x, g):
        dims = (0, 2, 3)
        n = g.all_sum(torch.tensor(float(x.numel() // x.shape[1]),
                                   device=x.device))
        mean = g.sum(x.sum(dims)) / n
        centred = x - mean[:, None, None]
        var = g.sum((centred * centred).sum(dims)) / n
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean)
            self.running_var.mul_(1 - m).add_(m * var * n / (n - 1))
        scale = self.weight * torch.rsqrt(var + self.eps)
        return centred * scale[:, None, None] + self.bias[:, None, None]


def frozen_batchnorm(x, weight, bias, running_mean, running_var, eps=1e-5):
    """x * scale + offset over the channel axis 1 (NCHW), in x's dtype:
    scale and offset are formed from the float32 statistics, then cast."""
    scale = weight * torch.rsqrt(running_var + eps)
    offset = bias - running_mean * scale
    scale, offset = scale.to(x.dtype), offset.to(x.dtype)
    return x * scale[:, None, None] + offset[:, None, None]


def max_pool(x, window=3, stride=2, ceil_mode=True):
    """Max pool without padding (NCHW); the defaults are the ResNet stem's
    3x3 / stride 2 ceil-mode pool, VGG's pools are 2 / 2 floor."""
    return F.max_pool2d(x, window, stride, 0, ceil_mode=ceil_mode)


def avg_pool(x, window, stride):
    """Average pool, count including padding (NCHW)."""
    return F.avg_pool2d(x, window, stride, count_include_pad=True)


def nhwc_to_nchw(x):
    """[B,H,W,C] -> [B,C,H,W] as a channels_last view (no copy)."""
    return x.permute(0, 3, 1, 2)


def nchw_to_nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


# ----------------------------------------------------------------------------
# numpy initializers, in the JAX layout (HWIO convs, [in, out] linears)
# ----------------------------------------------------------------------------

def init_conv(rng: np.random.Generator, kh, kw, cin, cout, bias=False,
              std=None):
    """He-normal conv init (std = sqrt(2 / fan_out))."""
    if std is None:
        std = math.sqrt(2.0 / (kh * kw * cout))
    p = {'weight': rng.normal(0.0, std, (kh, kw, cin, cout)).astype(np.float32)}
    if bias:
        p['bias'] = np.zeros((cout,), np.float32)
    return p


def init_bn(c):
    return {'weight': np.ones((c,), np.float32),
            'bias': np.zeros((c,), np.float32),
            'running_mean': np.zeros((c,), np.float32),
            'running_var': np.ones((c,), np.float32)}


def init_linear_uniform(rng: np.random.Generator, cin, cout):
    """torch's default nn.Linear init: weight, then bias, uniform within
    1 / sqrt(cin)."""
    bound = 1.0 / math.sqrt(cin)
    return {'weight': rng.uniform(-bound, bound, (cin, cout))
            .astype(np.float32),
            'bias': rng.uniform(-bound, bound, (cout,)).astype(np.float32)}


def init_linear(rng: np.random.Generator, cin, cout, std=0.01, bias=True):
    p = {'weight': rng.normal(0.0, std, (cin, cout)).astype(np.float32)}
    if bias:
        p['bias'] = np.zeros((cout,), np.float32)
    return p
