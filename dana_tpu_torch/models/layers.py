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

The numpy `init_*` helpers draw in the same order as the JAX package's,
so one seed gives both packages the same weights.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dana_tpu_torch.parallel.distributed import current_group


class Conv2d(nn.Conv2d):
    """nn.Conv2d in its input's dtype: the weight and bias cast per call."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


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
