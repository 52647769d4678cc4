"""The training optimizer (port of dana_tpu/engine/optim.py): torch SGD
with the reference's parameter groups, the frozen trunk stages, the
trainable-only gradient clip and the non-finite step check.

The reference's groups: biases take lr * (DOUBLE_BIAS + 1) and no weight
decay (unless BIAS_DECAY), everything else lr and WEIGHT_DECAY.  torch's
SGD then computes g += wd * p; v = mu * v + g; p -= lr * v, the JAX
package's `sgd_update` (its velocity starts at zero, so its first
v = g + wd * p is torch's first momentum buffer).  The defaults are the
engine's (TRAIN_* constants); the training CLI passes its config tree's
values (cfgs/res50.yml: weight decay 1e-4, no doubled bias lr).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from dana_tpu_torch.utils import config as cfg

# the heads that train in the finetune flow: the JAX package's
# `finetune_mask` head keys (each detector has some of them: DAnA no
# RCNN_cls_score, FSOD only RCNN_bbox_pred)
FINETUNE_HEADS = ('RCNN_cls_score', 'RCNN_bbox_pred', 'output_score_layer',
                  'rcnn_transform_layer')


def freeze_fixed(model: nn.Module, fixed_blocks: int = cfg.FIXED_BLOCKS):
    """Make the detector trainable except what its trunk fixes
    (`freeze`: a ResNet's stem (conv1) and layer1..layer{fixed_blocks}),
    which gets requires_grad False: no gradient is recorded for it and
    its .grad stays None.
    Every BatchNorm of the trunk is a frozen buffer already
    (layers.FrozenBatchNorm2d); a head's BatchNorm (FGN's) trains its
    affine, and its running statistics are buffers, as the JAX package's
    `trainable_mask` has them.  A VGG16 trunk trains whole, as
    `trainable_mask` leaves it (it names no VGG layer; py-faster-rcnn
    would freeze conv1-conv2).  -> the model."""
    model.requires_grad_(True)
    model.backbone.freeze(fixed_blocks)
    return model


def freeze_to_heads(model: nn.Module):
    """The finetune flow's freeze (the JAX package's `finetune_mask`,
    reference FasterRCNN.finetune, faster_rcnn.py:192-204): only the
    detection heads (FINETUNE_HEADS) keep requires_grad, where they had
    it.
    -> the model."""
    for name, child in model.named_children():
        if name not in FINETUNE_HEADS:
            child.requires_grad_(False)
    return model


def make_sgd(model: nn.Module, lr: float, momentum=cfg.TRAIN_MOMENTUM,
             weight_decay=cfg.TRAIN_WEIGHT_DECAY,
             double_bias=cfg.TRAIN_DOUBLE_BIAS,
             bias_decay=cfg.TRAIN_BIAS_DECAY) -> torch.optim.SGD:
    """torch SGD over the trainable parameters in two groups: biases (lr *
    (double_bias + 1), weight decay only with bias_decay) and the rest (lr,
    weight_decay).  Each group keeps its factor on the lr as 'lr_mult'
    (`set_lr`)."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    bias = [p for n, p in named if n.endswith('bias')]
    rest = [p for n, p in named if not n.endswith('bias')]
    mult = double_bias + 1.0
    return torch.optim.SGD(
        [{'params': bias, 'lr': lr * mult, 'lr_mult': mult,
          'weight_decay': weight_decay if bias_decay else 0.0},
         {'params': rest, 'lr': lr, 'lr_mult': 1.0,
          'weight_decay': weight_decay}],
        lr=lr, momentum=momentum)


def set_lr(optimizer: torch.optim.Optimizer, lr: float):
    """Set the base lr of every group, each times its 'lr_mult'."""
    for g in optimizer.param_groups:
        g['lr'] = lr * g['lr_mult']


def _by_device(tensors):
    """{device: [tensors on it]} in first-seen order (tensor parallelism
    puts a layer's shards on several devices)."""
    out = {}
    for t in tensors:
        out.setdefault(t.device, []).append(t)
    return out


def clip_gradients(grads, clip_norm: float):
    """Scale the gradients in place by min(1, clip_norm / total norm), the
    norm over all of them (the trainable parameters' only)."""
    groups = _by_device(grads)
    lead = grads[0].device
    total = torch.linalg.vector_norm(torch.cat(
        [torch.stack(torch._foreach_norm(gs)).to(lead)
         for gs in groups.values()]))
    scale = (clip_norm / total.clamp(min=1e-12)).clamp(max=1.0)
    for dev, gs in groups.items():
        torch._foreach_mul_(gs, scale.to(dev))


def nonfinite(loss, grads) -> torch.Tensor:
    """A float tensor [1] on the loss's device: 1 where the loss or any
    gradient holds a NaN or an infinity, else 0, from one fused check of
    the gradients (torch's AMP unscale with a scale of 1, which leaves
    them unchanged)."""
    found = (~torch.isfinite(loss.detach())).float().reshape(1)
    for dev, gs in _by_device(grads).items():
        f = found if dev == loss.device else torch.zeros(1, device=dev)
        torch._amp_foreach_non_finite_check_and_unscale_(
            gs, f, torch.ones(1, device=dev))
        if f is not found:
            found = torch.maximum(found, f.to(loss.device))
    return found
