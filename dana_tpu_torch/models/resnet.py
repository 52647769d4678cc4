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
RCNN_top (layer4).  Both take and return NHWC.  Only the direct
3-channel stem is ported.  A `ResNet` has the detector's trunk members
(`base`, `tail`, `feat_dim`, `tail_dim`, `tail_range`, `freeze`), as
models/vgg.py's `VGG16` does.
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


def base_forward(x, backbone: ResNet):
    """[B, H, W, 3] -> [B, H/16, W/16, 4 * 64 * expansion]."""
    y = L.nhwc_to_nchw(x)
    y = L.max_pool(F.relu(backbone.bn1(backbone.conv1(y))))
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
