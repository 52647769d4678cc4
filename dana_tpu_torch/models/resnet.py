"""ResNet trunk of the detector (port of dana_tpu/models/resnet.py).

Caffe-style bottleneck: the stride sits on the 1x1 conv1, not on conv2 as
in torchvision; the stem max pool is 3/2/0 with ceil_mode.  Module names
follow the torch state_dict (`layer1.0.downsample.0.weight`), so a JAX
param tree or a reference checkpoint fills them by name.

`ARCH_LAYERS` is the JAX package's table: ResNet-18/34 of basic blocks,
ResNet-50/101/152 of bottlenecks.  The detector runs the bottleneck ones
(its heads take 1024 base channels, `DanaConfig.feat_dim`); the basic
ones, whose layer3 has 256 channels, are held at module level.

`base_forward` is RCNN_base (conv1..layer3, stride 16); `top_forward` is
RCNN_top (layer4).  Both take and return NHWC.  A `ResNet` has the
detector's trunk members (`base`, `tail`, `feat_dim`, `tail_dim`,
`tail_range`, `freeze`), as models/vgg.py's `VGG16` does.

The stem takes either input, by its channel count, as the JAX package's
`stem` does: a canvas [B, H, W, 3] runs the direct 7x7/2 conv1, and a
space-to-depth input [B, H/2+3, W/2+3, 12] packed on the host
(data/blob.py `s2d_pack`, TPU.STEM_S2D) runs `conv1_s2d`, a dense 4x4/1
VALID conv (cuDNN) with the weight rewritten by `stem_w4`; the two give
the same map.  An int8 conv1 (quant.py, scope 'all') is rewritten the
same way, which keeps its per-output-channel scales.
"""

from __future__ import annotations

import numpy as np
import torch.nn as nn
import torch.nn.functional as F

from dana_tpu_torch.models import layers as L

ARCH_LAYERS = {
    'resnet18': ('basic', [2, 2, 2, 2]),
    'resnet34': ('basic', [3, 4, 6, 3]),
    'resnet50': ('bottleneck', [3, 4, 6, 3]),
    'resnet101': ('bottleneck', [3, 4, 23, 3]),
    'resnet152': ('bottleneck', [3, 8, 36, 3]),
}


def _downsample(inplanes, out, stride):
    if stride == 1 and inplanes == out:
        return None
    return nn.Sequential(L.Conv2d(inplanes, out, 1, stride, bias=False),
                         L.FrozenBatchNorm2d(out))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = L.Conv2d(inplanes, planes, 1, stride, bias=False)
        self.bn1 = L.FrozenBatchNorm2d(planes)
        self.conv2 = L.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = L.FrozenBatchNorm2d(planes)
        self.conv3 = L.Conv2d(planes, out, 1, bias=False)
        self.bn3 = L.FrozenBatchNorm2d(out)
        self.downsample = _downsample(inplanes, out, stride)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class BasicBlock(nn.Module):
    """Two 3x3 convs, the stride on the first."""
    expansion = 1

    def __init__(self, inplanes, planes, stride):
        super().__init__()
        self.conv1 = L.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = L.FrozenBatchNorm2d(planes)
        self.conv2 = L.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = L.FrozenBatchNorm2d(planes)
        self.downsample = _downsample(inplanes, planes, stride)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


_BLOCKS = {'basic': BasicBlock, 'bottleneck': Bottleneck}


def dims(arch):
    """(base channels, RoI-tail channels) of `arch`: layer3's and
    layer4's."""
    expansion = _BLOCKS[ARCH_LAYERS[arch][0]].expansion
    return 256 * expansion, 512 * expansion


class ResNet(nn.Module):
    """conv1/bn1 stem and layer1..layer4 (no fc: the detector drops it)."""
    tail_range = 'layer4'       # the RoI tail's profiler range name

    def __init__(self, arch='resnet50'):
        super().__init__()
        kind, counts = ARCH_LAYERS[arch]
        block = _BLOCKS[kind]
        self.feat_dim, self.tail_dim = dims(arch)
        self.conv1 = L.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = L.FrozenBatchNorm2d(64)
        inplanes = 64
        for li, (planes, blocks) in enumerate(zip([64, 128, 256, 512],
                                                  counts)):
            stride = 1 if li == 0 else 2
            seq = []
            for b in range(blocks):
                seq.append(block(inplanes, planes, stride if b == 0 else 1))
                inplanes = planes * block.expansion
            setattr(self, f'layer{li + 1}', nn.Sequential(*seq))

    def base(self, x):
        return base_forward(x, self)

    def tail(self, pooled):
        """layer4 and its spatial mean: [N,P,P,C] -> [N, tail_dim]."""
        return top_forward(pooled, self).mean(dim=(1, 2))

    def freeze(self, fixed_blocks):
        """Fix the stem (conv1) and layer1..layer{fixed_blocks}, as the JAX
        package's `trainable_mask` does."""
        self.conv1.requires_grad_(False)
        for i in range(1, fixed_blocks + 1):
            getattr(self, f'layer{i}').requires_grad_(False)


def stem_w4(w7):
    """conv1's weight [O, C, 7, 7] (OIHW, float or int8) -> the space-to-
    depth weight [O, 4C, 4, 4]: zero-extended bottom and right to 8x8,
    each spatial axis split into (4 blocks, 2 phases), the phases put
    before C, so input channel (i2 * 2 + j2) * C + c at block (a, b) is
    tap (2a + i2, 2b + j2) of channel c (the JAX package's `_stem_w4`,
    there in HWIO)."""
    o, c = w7.shape[:2]
    w8 = F.pad(w7, (0, 1, 0, 1))                          # [O, C, 8, 8]
    w4 = w8.reshape(o, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
    return w4.reshape(o, 4 * c, 4, 4)


def conv1_s2d(xd, conv1):
    """conv1 on a space-to-depth input xd [B, 12, H/2+3, W/2+3] (NCHW
    view): a 4x4/1 VALID conv over 12 channels with `stem_w4`'s weight ->
    the direct 7x7/2 conv1's [B, O, H/2, W/2].  An int8 conv1
    (`layers.QuantConv2d`) runs its int8 conv on the rewritten int8
    weight."""
    if isinstance(conv1, L.QuantConv2d):
        return conv1.quantized_conv(xd, stem_w4(conv1.w_int8), 1, 0)
    bias = None if conv1.bias is None else conv1.bias.to(xd.dtype)
    return F.conv2d(xd, stem_w4(conv1.weight).to(xd.dtype), bias)


def conv7x7s2_s2d(x, conv1):
    """conv1 (7x7/2, pad 3) of a canvas x [B, H, W, C] (NHWC, H and W
    even) through the space-to-depth rewrite on the device: pad 3, pack
    2x2 blocks into 4C channels, then `conv1_s2d` -> NHWC [B, H/2, W/2,
    O].  The JAX package's `_conv7x7s2_s2d`; the detector packs on the
    host instead (data/blob.py `s2d_pack`)."""
    b, h, w, c = x.shape
    out_h, out_w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    ph, pw = 2 * (out_h - 1) + 8 - h, 2 * (out_w - 1) + 8 - w
    xp = F.pad(x, (0, 0, 3, pw - 3, 3, ph - 3))
    hp, wp = xp.shape[1:3]
    xd = xp.reshape(b, hp // 2, 2, wp // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    xd = xd.reshape(b, hp // 2, wp // 2, 4 * c)
    return L.nchw_to_nhwc(conv1_s2d(L.nhwc_to_nchw(xd), conv1))


def stem_conv(y, backbone):
    """conv1 of the NCHW input y: 3 channels direct, 12 space-to-depth."""
    if y.shape[1] == 12:
        return conv1_s2d(y, backbone.conv1)
    return backbone.conv1(y)


def base_forward(x, backbone: ResNet):
    """[B, H, W, 3] canvases, or their space-to-depth packing [B, H/2+3,
    W/2+3, 12] -> [B, H/16, W/16, 4 * 64 * expansion]."""
    y = L.nhwc_to_nchw(x)
    y = L.max_pool(F.relu(backbone.bn1(stem_conv(y, backbone))))
    y = backbone.layer3(backbone.layer2(backbone.layer1(y)))
    return L.nchw_to_nhwc(y)


def top_forward(x, backbone: ResNet):
    """layer4: [N, h, w, C] -> [N, h/2, w/2, 2C]."""
    return L.nchw_to_nhwc(backbone.layer4(L.nhwc_to_nchw(x)))


def init_params(arch='resnet50', seed=0):
    """Random-init numpy backbone tree in the JAX layout, drawn exactly
    as the JAX package draws it (He conv init; SkipInit zeroes each
    block's last conv, conv3 of a bottleneck and conv2 of a basic block,
    so a random-init forward stays sane)."""
    kind, counts = ARCH_LAYERS[arch]
    expansion = _BLOCKS[kind].expansion
    rng = np.random.default_rng(seed)
    params = {'conv1': L.init_conv(rng, 7, 7, 3, 64), 'bn1': L.init_bn(64)}
    inplanes = 64
    for li, (planes, blocks) in enumerate(zip([64, 128, 256, 512], counts)):
        layer = {}
        stride = 1 if li == 0 else 2
        for b in range(blocks):
            s = stride if b == 0 else 1
            out = planes * expansion
            if kind == 'bottleneck':
                blk = {
                    'conv1': L.init_conv(rng, 1, 1, inplanes, planes),
                    'bn1': L.init_bn(planes),
                    'conv2': L.init_conv(rng, 3, 3, planes, planes),
                    'bn2': L.init_bn(planes),
                    'conv3': L.init_conv(rng, 1, 1, planes, out),
                    'bn3': L.init_bn(out),
                }
            else:
                blk = {
                    'conv1': L.init_conv(rng, 3, 3, inplanes, planes),
                    'bn1': L.init_bn(planes),
                    'conv2': L.init_conv(rng, 3, 3, planes, planes),
                    'bn2': L.init_bn(planes),
                }
            last = blk['conv3' if kind == 'bottleneck' else 'conv2']
            last['weight'] = np.zeros_like(last['weight'])
            if s != 1 or inplanes != out:
                blk['downsample'] = {
                    '0': L.init_conv(rng, 1, 1, inplanes, out),
                    '1': L.init_bn(out),
                }
            layer[str(b)] = blk
            inplanes = out
        params[f'layer{li + 1}'] = layer
    return params
