"""Building blocks (port of dana_tpu/models/layers.py).

Convolutions, linears and activations are torch's own (nn.Conv2d,
nn.Linear, F.relu; F.leaky_relu's default slope 0.01 is the JAX one).
The trunk's modules work on NCHW tensors, which the public functions
make from NHWC inputs with a permute (a channels_last view, so cuDNN
keeps the NHWC memory order).  BatchNorm is always frozen: an affine
transform with stored running statistics, as in the reference detector.

The numpy `init_*` helpers draw in the same order as the JAX package's,
so one seed gives both packages the same weights.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


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


def frozen_batchnorm(x, weight, bias, running_mean, running_var, eps=1e-5):
    """x * scale + offset over the channel axis 1 (NCHW)."""
    scale = weight * torch.rsqrt(running_var + eps)
    offset = bias - running_mean * scale
    return x * scale[:, None, None] + offset[:, None, None]


def max_pool(x):
    """The stem's 3x3 / stride 2 / pad 0 ceil-mode max pool (NCHW)."""
    return F.max_pool2d(x, 3, 2, 0, ceil_mode=True)


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


def init_linear(rng: np.random.Generator, cin, cout, std=0.01, bias=True):
    p = {'weight': rng.normal(0.0, std, (cin, cout)).astype(np.float32)}
    if bias:
        p['bias'] = np.zeros((cout,), np.float32)
    return p
