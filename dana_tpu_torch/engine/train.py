"""The training entry point: one episodic SGD step of a detector, DAnA,
cisa or a sibling of models/frameworks.py (port of
dana_tpu/engine/train.py `loss_fn` and `make_train_step`).

The step's loss is the sum of the four heads' losses; its gradient
reaches every trainable parameter, never a ResNet's frozen stem and
layer1 (a VGG16 trunk trains whole); a step whose loss or gradients are
not finite changes neither the parameters nor the momentum and reports
skipped = 1.  FGN's head
BatchNorms with config.bn_train update their running statistics in the
forward, as the JAX step merges them after its update, skipped or not.

The config's precision recipe (compute_dtype, attention_dtype,
head_dtype) sets the activations' dtypes only: the parameters stay
float32 masters, every layer casts them to its input's dtype, so the
gradients, the momentum and the SGD update are float32, as in the JAX
step.

Data parallelism: with `group` (parallel/distributed.py `BatchGroup`) of
W ranks, one process per device, each rank's batch is its row block of
the global batch and the step is the global batch's step, as the JAX
step on a data mesh is: the parameters are broadcast from rank 0 at the
start; the forward runs inside the group, so the batch-coupled losses,
the draws and the batch-statistics BatchNorm see the global batch; one
flattened all-reduce averages the gradients before the non-finite check
and the clip, so every rank skips or steps together; the metrics are the
global batch's.  On one process (`group` None) nothing is communicated.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from dana_tpu_torch import quant
from dana_tpu_torch.engine import optim
from dana_tpu_torch.models import dana, frameworks
from dana_tpu_torch.parallel.distributed import SINGLE
from dana_tpu_torch.utils import config as cfg
from dana_tpu_torch.utils import trace
from dana_tpu_torch.utils.device import resolve_device, use_full_f32
from dana_tpu_torch.utils.weights import (from_jax_params, velocity_from_jax,
                                          velocity_to_jax)

LOSSES = ('rpn_loss_cls', 'rpn_loss_box', 'rcnn_loss_cls', 'rcnn_loss_bbox')


class Trainer:
    """Trainer(params, config, device='cuda', lr=..., seed=0, clip_norm=0.0,
    fixed_blocks=..., finetune=False, **sgd).

    params: the JAX package's param tree (numpy leaves) of
    config.framework's detector, or its module (a checkpoint read by
    `utils.checkpoint.load_checkpoint`).  The device
    defaults to the card and the constructor raises without CUDA unless
    device='cpu' is passed; float32 math runs without TF32
    (utils.device.use_full_f32).
    Trainable: everything but a ResNet trunk's stem and
    layer1..fixed_blocks (optim.freeze_fixed; a VGG16 trunk trains whole);
    with `finetune`, only the detection heads of that set
    (optim.freeze_to_heads).  `sgd`: momentum, weight_decay, double_bias,
    bias_decay for `optim.make_sgd`, at the engine's defaults.
    The target layers draw from a torch.Generator on the device, seeded by
    `seed`.  clip_norm > 0 clips the trainable gradients' total norm.
    `state()` and `load_state()` carry the momentum buffers and the
    generator's state through a checkpoint.  `group`: the BatchGroup of a
    data-parallel run (module docstring); every rank seeds its generator
    alike and draws the global batch's draws.
    """

    def __init__(self, params, config: dana.DanaConfig, device='cuda',
                 lr: float = cfg.TRAIN_LEARNING_RATE, seed: int = 0,
                 clip_norm: float = 0.0, fixed_blocks: int = cfg.FIXED_BLOCKS,
                 finetune: bool = False, group=None, **sgd):
        self.device = resolve_device(device)
        use_full_f32()
        model = params if isinstance(params, torch.nn.Module) \
            else from_jax_params(params, config)
        if quant.count_int8(model):
            raise ValueError('a quantized (int8) model serves only: train '
                             'the float tree, as the JAX package does')
        self.model = optim.freeze_fixed(model.to(self.device), fixed_blocks)
        if finetune:
            optim.freeze_to_heads(self.model)
        self.config = config
        self.group = group or SINGLE
        for t in list(self.model.parameters()) + list(self.model.buffers()):
            self.group.broadcast_(t.data)
        self._sgd = sgd
        self._lr = lr
        self.rebuild_optimizer()
        self.clip_norm = clip_norm
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def rebuild_optimizer(self):
        """The trainable parameters and a fresh optimizer over them (after
        the model's layers were replaced, `parallel.shard_state_tp`)."""
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        self.optimizer = optim.make_sgd(self.model, self._lr, **self._sgd)

    @property
    def lr(self) -> float:
        """The base lr (biases take it times their group's factor)."""
        return self._lr

    @lr.setter
    def lr(self, value: float):
        self._lr = float(value)
        optim.set_lr(self.optimizer, self._lr)

    def state(self) -> dict:
        """-> {'velocity': the momentum buffers as a JAX velocity tree,
        'generator': the generator's state, a uint8 numpy array}."""
        return {'velocity': velocity_to_jax(self.model, self.optimizer),
                'generator': self.generator.get_state().numpy()}

    def load_state(self, velocity=None, generator=None):
        """Restore what `state()` gave (either part may be None): the
        momentum buffers of the trainable parameters from a JAX velocity
        tree, the generator from its state."""
        if velocity is not None:
            for p, buf in velocity_from_jax(velocity, self.model).items():
                if p.requires_grad:
                    self.optimizer.state[p]['momentum_buffer'] = \
                        buf.to(self.device)
        if generator is not None:
            self.generator.set_state(
                torch.from_numpy(np.asarray(generator, np.uint8)))

    def step(self, batch, draws=None):
        """One SGD step on `batch`: dict(im_data [B,H,W,3] uint8 or float,
        im_info [B,3], gt_boxes [B,G,5], support_ims [B, n_way*n_shot,
        H, W, 3] float (Faster R-CNN reads none; on a ResNet trunk the
        queries and supports may be space-to-depth packed, 12 channels,
        data/blob.py `s2d_pack`), and for Meta R-CNN
        all_gt_boxes [B,G',5], every class's gt, for its RPN targets), numpy
        arrays or tensors (in a data-parallel run, this rank's rows).
        `draws` (a dict keyed by rpn.DRAW_KEYS, the global batch's)
        replaces the generator's draws.  -> dict of 0-dim tensors on the
        device: the four losses, loss, fg_cnt, bg_cnt (the global
        batch's) and skipped (read on the host once, to decide the
        update).  One unit of utils/trace.py: the range `dana.entry.step`
        and a record of the step; the batch and the draws are uploaded in
        `dana.entry.upload`."""
        with trace.unit('step'):
            return self._step(batch, draws)

    def _step(self, batch, draws):
        with record_function('dana.entry.upload'):
            b = {k: trace.upload(v, self.device) for k, v in batch.items()}
            if draws is not None:
                draws = {k: self.group.rows(trace.upload(v, self.device))
                         for k, v in draws.items()}
        for p in self.params:
            p.grad = None
        sup, all_gt = b.get('support_ims'), b.get('all_gt_boxes')
        with self.group:
            out = frameworks.forward(
                self.model, self.config, b['im_data'], b['im_info'].float(),
                support_ims=None if sup is None else sup.float(),
                training=True, gt_boxes=b['gt_boxes'].float(),
                all_gt_boxes=None if all_gt is None else all_gt.float(),
                draws=self.generator if draws is None else draws)
        total = sum(out[k] for k in LOSSES)
        with record_function('dana.backward'):
            total.backward()
        labels = out['rois_label']
        metrics = dict({k: out[k].detach() for k in LOSSES},
                       loss=total.detach(), fg_cnt=(labels > 0).sum(),
                       bg_cnt=(labels == 0).sum())
        if self.group.distributed:
            metrics = self._global_metrics(metrics)
        skipped = self.update(metrics['loss'])
        return dict(metrics, skipped=skipped[0])

    def _global_metrics(self, m):
        """The global batch's metrics from every rank's: the losses'
        mean (each rank's loss is its share of the global loss), the
        counts' sum; one all-reduce."""
        keys = list(m)
        vec = self.group.all_sum(torch.stack([m[k].float() for k in keys]))
        return {k: v if k.endswith('_cnt') else v / self.group.size
                for k, v in zip(keys, vec.unbind())}

    def _mean_gradients(self):
        """Average the trainable gradients over the ranks: one flattened
        all-reduce."""
        grads = [p.grad for p in self.params if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        self.group.reduce_(flat)
        flat /= self.group.size
        for g, src in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(src.view_as(g))

    def update(self, loss):
        """The SGD update from the trainable parameters' .grad, clipped
        first when clip_norm > 0; nothing changes where `loss` or a
        gradient is not finite.  In a data-parallel run `loss` is the
        global loss and the gradients are first averaged over the ranks.
        -> skipped, a float tensor [1]."""
        with record_function('dana.update'):
            if self.group.distributed:
                self._mean_gradients()
            grads = [p.grad for p in self.params]
            skipped = optim.nonfinite(loss, grads)
            if not trace.sync(skipped, 'update')[0]:
                if self.clip_norm:
                    optim.clip_gradients(grads, self.clip_norm)
                self.optimizer.step()
        return skipped
