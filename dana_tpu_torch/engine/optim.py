"""The training optimizer (port of dana_tpu/engine/optim.py): torch SGD
with the reference's parameter groups, the frozen trunk stages, the
trainable-only gradient clip and the non-finite step check.

The reference's groups: biases take lr * (DOUBLE_BIAS + 1) and no weight
decay (unless BIAS_DECAY), everything else lr and WEIGHT_DECAY.  torch's
SGD then computes g += wd * p; v = mu * v + g; p -= lr * v, the JAX
package's `sgd_update` (its velocity starts at zero, so its first
v = g + wd * p is torch's first momentum buffer).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from dana_tpu_torch.utils import config as cfg


def freeze_fixed(model: nn.Module):
    """Make the detector trainable except the trunk's stem (conv1) and
    layer1..layer{FIXED_BLOCKS}, which get requires_grad False: no
    gradient is recorded for them and their .grad stays None.  Every
    BatchNorm of the trunk is a frozen buffer already
    (layers.FrozenBatchNorm2d).  -> the model."""
    model.requires_grad_(True)
    model.backbone.conv1.requires_grad_(False)
    for i in range(1, cfg.FIXED_BLOCKS + 1):
        getattr(model.backbone, f'layer{i}').requires_grad_(False)
    return model


def make_sgd(model: nn.Module, lr: float) -> torch.optim.SGD:
    """torch SGD (momentum TRAIN_MOMENTUM) over the trainable parameters
    in two groups: biases (lr * (TRAIN_DOUBLE_BIAS + 1), weight decay only
    with TRAIN_BIAS_DECAY) and the rest (lr, TRAIN_WEIGHT_DECAY)."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    bias = [p for n, p in named if n.endswith('bias')]
    rest = [p for n, p in named if not n.endswith('bias')]
    wd = cfg.TRAIN_WEIGHT_DECAY
    return torch.optim.SGD(
        [{'params': bias, 'lr': lr * (cfg.TRAIN_DOUBLE_BIAS + 1),
          'weight_decay': wd if cfg.TRAIN_BIAS_DECAY else 0.0},
         {'params': rest, 'lr': lr, 'weight_decay': wd}],
        lr=lr, momentum=cfg.TRAIN_MOMENTUM)


def clip_gradients(grads, clip_norm: float):
    """Scale the gradients in place by min(1, clip_norm / total norm), the
    norm over all of them (the trainable parameters' only)."""
    total = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, (clip_norm / total.clamp(min=1e-12))
                        .clamp(max=1.0))


def nonfinite(loss, grads) -> torch.Tensor:
    """A float tensor [1] on the loss's device: 1 where the loss or any
    gradient holds a NaN or an infinity, else 0, from one fused check of
    the gradients (torch's AMP unscale with a scale of 1, which leaves
    them unchanged)."""
    found = (~torch.isfinite(loss.detach())).float().reshape(1)
    torch._amp_foreach_non_finite_check_and_unscale_(
        grads, found, torch.ones(1, device=loss.device))
    return found
