"""Operations of convolutions and linears, and the ResNet-50 C4 trunk's
convolutions at an input size."""

from __future__ import annotations

import math

BLOCKS = (3, 4, 6, 3)
WIDTHS = (64, 128, 256, 512)


def conv_flops(n, cin, cout, k, ho, wo):
    """2 multiply-adds' operations per tap, input channel, output."""
    return 2 * n * cout * ho * wo * cin * k * k


def linear_flops(rows, cin, cout):
    return 2 * rows * cin * cout


def _out(size, k, stride, pad):
    return (size + 2 * pad - k) // stride + 1


def resnet50_convs(h, w, stages=(1, 2, 3)):
    """[(name, cin, cout, k, ho, wo)] of the trunk's convolutions on an h x
    w input: the stem (with stage 1) and the bottlenecks of `stages` (4 is
    layer4, which takes layer3's map at h x w)."""
    convs = []
    c = 1024 if stages[0] == 4 else 64
    if stages[0] == 1:
        h, w = _out(h, 7, 2, 3), _out(w, 7, 2, 3)
        convs.append(('conv1', 3, 64, 7, h, w))
        h, w = math.ceil((h - 3) / 2) + 1, math.ceil((w - 3) / 2) + 1
    for li in stages:
        planes = WIDTHS[li - 1]
        for b in range(BLOCKS[li - 1]):
            s = 2 if (b == 0 and li > 1) else 1
            p = f'layer{li}.{b}'
            ho, wo = _out(h, 1, s, 0), _out(w, 1, s, 0)
            convs += [(f'{p}.conv1', c, planes, 1, ho, wo),
                      (f'{p}.conv2', planes, planes, 3, ho, wo),
                      (f'{p}.conv3', planes, 4 * planes, 1, ho, wo)]
            if b == 0:
                convs.append((f'{p}.downsample.0', c, 4 * planes, 1, ho, wo))
            c, h, w = 4 * planes, ho, wo
    return convs


def trunk_flops(n, h, w, stages=(1, 2, 3)):
    return sum(conv_flops(n, ci, co, k, ho, wo)
               for _, ci, co, k, ho, wo in resnet50_convs(h, w, stages))


def trunk_backward_flops(n, h, w, stages=(1, 2, 3), frozen=('conv1',
                                                            'layer1.')):
    """The backward of the trunk with its stem and layer1 frozen: a weight
    gradient for each trained conv, an input gradient for each conv whose
    input carries one (not the first block of layer2, whose input is
    layer1's)."""
    total = 0
    for name, ci, co, k, ho, wo in resnet50_convs(h, w, stages):
        if name.startswith(frozen):
            continue
        f = conv_flops(n, ci, co, k, ho, wo)
        first = name in ('layer2.0.conv1', 'layer2.0.downsample.0')
        total += f if first else 2 * f
    return total


def map_size(h, w):
    """layer3's map of an h x w input."""
    *_, ho, wo = resnet50_convs(h, w)[-1]
    return ho, wo
