"""ResNet trunk of the detector (port of dana_tpu/models/resnet.py).

Caffe-style bottleneck: the stride sits on the 1x1 conv1, not on conv2 as
in torchvision; the stem max pool is 3/2/0 with ceil_mode.  Module names
follow the torch state_dict (`layer1.0.downsample.0.weight`), so a JAX
param tree or a reference checkpoint fills them by name.

`base_forward` is RCNN_base (conv1..layer3, stride 16, 1024 channels);
`top_forward` is RCNN_top (layer4, 2048 channels).  Both take and return
NHWC.  Only the direct 3-channel stem is ported.
"""

from __future__ import annotations

import numpy as np
import torch.nn as nn
import torch.nn.functional as F

from dana_tpu_torch.models import layers as L

ARCH_LAYERS = {
    'resnet50': [3, 4, 6, 3],
}


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, planes, 1, stride, bias=False)
        self.bn1 = L.FrozenBatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = L.FrozenBatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = L.FrozenBatchNorm2d(out)
        if stride != 1 or inplanes != out:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, out, 1, stride, bias=False),
                L.FrozenBatchNorm2d(out))
        else:
            self.downsample = None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class ResNet(nn.Module):
    """conv1/bn1 stem and layer1..layer4 (no fc: the detector drops it)."""

    def __init__(self, arch='resnet50'):
        super().__init__()
        counts = ARCH_LAYERS[arch]
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = L.FrozenBatchNorm2d(64)
        inplanes = 64
        for li, (planes, blocks) in enumerate(zip([64, 128, 256, 512],
                                                  counts)):
            stride = 1 if li == 0 else 2
            seq = []
            for b in range(blocks):
                seq.append(Bottleneck(inplanes, planes,
                                      stride if b == 0 else 1))
                inplanes = planes * Bottleneck.expansion
            setattr(self, f'layer{li + 1}', nn.Sequential(*seq))


def base_forward(x, backbone: ResNet):
    """[B, H, W, 3] -> [B, H/16, W/16, 1024]."""
    y = L.nhwc_to_nchw(x)
    y = L.max_pool(F.relu(backbone.bn1(backbone.conv1(y))))
    y = backbone.layer3(backbone.layer2(backbone.layer1(y)))
    return L.nchw_to_nhwc(y)


def top_forward(x, backbone: ResNet):
    """layer4: [N, h, w, 1024] -> [N, h/2, w/2, 2048]."""
    return L.nchw_to_nhwc(backbone.layer4(L.nhwc_to_nchw(x)))


def init_params(arch='resnet50', seed=0):
    """Random-init numpy backbone tree in the JAX layout, drawn exactly
    as the JAX package draws it (He conv init; SkipInit zeroes each
    block's conv3 so a random-init forward stays sane)."""
    counts = ARCH_LAYERS[arch]
    rng = np.random.default_rng(seed)
    params = {'conv1': L.init_conv(rng, 7, 7, 3, 64), 'bn1': L.init_bn(64)}
    inplanes = 64
    for li, (planes, blocks) in enumerate(zip([64, 128, 256, 512], counts)):
        layer = {}
        stride = 1 if li == 0 else 2
        for b in range(blocks):
            s = stride if b == 0 else 1
            out = planes * 4
            blk = {
                'conv1': L.init_conv(rng, 1, 1, inplanes, planes),
                'bn1': L.init_bn(planes),
                'conv2': L.init_conv(rng, 3, 3, planes, planes),
                'bn2': L.init_bn(planes),
                'conv3': L.init_conv(rng, 1, 1, planes, out),
                'bn3': L.init_bn(out),
            }
            blk['conv3']['weight'] = np.zeros_like(blk['conv3']['weight'])
            if s != 1 or inplanes != out:
                blk['downsample'] = {
                    '0': L.init_conv(rng, 1, 1, inplanes, out),
                    '1': L.init_bn(out),
                }
            layer[str(b)] = blk
            inplanes = out
        params[f'layer{li + 1}'] = layer
    return params
