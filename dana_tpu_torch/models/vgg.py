"""VGG16 trunk of the detector (port of dana_tpu/models/vgg.py).

The py-faster-rcnn split: conv1_1..conv5_3 with the 2 x 2 / stride 2
floor max pools after blocks 1-4 only (no fifth pool) as the stride-16
base (512 channels), and fc6 / fc7 with ReLU as the RoI tail (4096).
Module names follow torchvision's vgg16 (`features.0`, `classifier.0`,
`classifier.3`), so a JAX param tree, a reference state dict or a
torchvision checkpoint (utils/weights.py `torchvision_vgg16_params`)
fills them by name.  `base_forward` and `tail_forward` take NHWC.  A
`VGG16` has the detector's trunk members (`base`, `tail`, `feat_dim`,
`tail_dim`, `tail_range`, `freeze`), as models/resnet.py's `ResNet` does.
"""

from __future__ import annotations

import numpy as np
import torch.nn as nn
import torch.nn.functional as F

from dana_tpu_torch.models import layers as L

# torchvision vgg16's features: convs (their output channels) and 'M' max
# pools, without the fifth pool
_CFG = [64, 64, 'M', 128, 128, 'M', 256, 256, 256, 'M',
        512, 512, 512, 'M', 512, 512, 512]


def _conv_indices():
    """The index in torchvision's `features` of each conv of _CFG (a conv
    is followed by its ReLU, a pool stands alone)."""
    idx, i = [], 0
    for v in _CFG:
        if v == 'M':
            i += 1
        else:
            idx.append(i)
            i += 2
    return idx


CONV_IDX = _conv_indices()
FEAT_DIM = 512
TAIL_DIM = 4096


class VGG16(nn.Module):
    """features (the 13 convs, keyed by their torchvision index) and
    classifier (fc6 '0', fc7 '3')."""
    feat_dim, tail_dim = FEAT_DIM, TAIL_DIM
    tail_range = 'fc'           # the RoI tail's profiler range name

    def __init__(self):
        super().__init__()
        convs, cin = {}, 3
        for idx, v in zip(CONV_IDX, [v for v in _CFG if v != 'M']):
            convs[str(idx)] = L.Conv2d(cin, v, 3, 1, 1)
            cin = v
        self.features = nn.ModuleDict(convs)
        self.classifier = nn.ModuleDict({
            '0': L.Linear(FEAT_DIM * 7 * 7, TAIL_DIM),
            '3': L.Linear(TAIL_DIM, TAIL_DIM)})

    def base(self, x):
        return base_forward(x, self)

    def tail(self, pooled):
        """fc6 / fc7, no spatial mean: [N,P,P,C] -> [N, tail_dim]."""
        return tail_forward(pooled, self)

    def freeze(self, fixed_blocks):
        """Fix nothing: the JAX package's `trainable_mask` names no VGG
        layer, so the trunk trains whole (py-faster-rcnn would fix
        conv1-conv2)."""


def base_forward(x, backbone: VGG16):
    """[B, H, W, 3] -> [B, H/16, W/16, 512] (floor pools)."""
    y = L.nhwc_to_nchw(x)
    convs = iter(CONV_IDX)
    for v in _CFG:
        if v == 'M':
            y = L.max_pool(y, 2, 2, ceil_mode=False)
        else:
            y = F.relu(backbone.features[str(next(convs))](y))
    return L.nchw_to_nhwc(y)


def tail_forward(pooled, backbone: VGG16):
    """fc6 / fc7 on [..., 7, 7, 512] -> [..., 4096]: flattened in CHW
    order, as torchvision's fc6 reads it."""
    lead = pooled.shape[:-3]
    x = pooled.movedim(-1, -3).reshape(*lead, -1)
    x = F.relu(backbone.classifier['0'](x))
    return F.relu(backbone.classifier['3'](x))


def init_params(seed: int = 0) -> dict:
    """Random-init numpy tree in the JAX layout, drawn as the JAX package
    draws it (He-normal convs with zero biases, fc6 and fc7 normal std
    0.01)."""
    rng = np.random.default_rng(seed)
    features, cin = {}, 3
    for idx, v in zip(CONV_IDX, [v for v in _CFG if v != 'M']):
        features[str(idx)] = L.init_conv(rng, 3, 3, cin, v, bias=True)
        cin = v
    classifier = {
        '0': L.init_linear(rng, FEAT_DIM * 7 * 7, TAIL_DIM, std=0.01),
        '3': L.init_linear(rng, TAIL_DIM, TAIL_DIM, std=0.01),
    }
    return {'features': features, 'classifier': classifier}
