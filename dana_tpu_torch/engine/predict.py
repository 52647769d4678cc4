"""The serving entry point: a predictor that encodes each class's
supports once and answers detection requests (port of the JAX package's
eval loop, inference.py `encode_supports` / `predict`, and
engine/train.py `predict_step`)."""

from __future__ import annotations

import torch
import torch.nn as nn
from torch.profiler import record_function

from dana_tpu_torch.engine.postprocess import postprocess_batch
from dana_tpu_torch.models import dana
from dana_tpu_torch.utils import config as cfg
from dana_tpu_torch.utils.device import resolve_device, use_full_f32
from dana_tpu_torch.utils.weights import from_jax_params


class Predictor:
    """Predictor(params, config, device='cuda', postprocess=None).

    params: the JAX package's param tree (numpy leaves) or a built
    `dana.DAnA` module.  The device defaults to the card and the
    constructor raises without CUDA unless device='cpu' is passed; on the
    card float32 math runs without TF32 (utils.device.use_full_f32).
    `postprocess` is the detection postprocess's keywords
    (`utils.config.postprocess_kwargs` of the CLI's tree; the built-in
    tree's when None).
    """

    def __init__(self, params, config: dana.DanaConfig, device='cuda',
                 postprocess=None):
        self.device = resolve_device(device)
        if self.device.type == 'cuda':
            use_full_f32()
        model = params if isinstance(params, nn.Module) \
            else from_jax_params(params, config)
        self.model = model.to(self.device)
        self.config = config
        self.postprocess = postprocess or cfg.postprocess_kwargs()
        self._sup_cache = {}

    @torch.inference_mode()
    def encode_supports(self, cls, support_ims):
        """Encode one class's supports [n_shot, H, W, 3] (float, mean-
        subtracted) once and cache them under `cls`."""
        ims = torch.as_tensor(support_ims, device=self.device)[None]
        self._sup_cache[int(cls)] = dana.extract_support_feats(
            self.model, self.config, ims)
        return self._sup_cache[int(cls)]

    def has_supports(self, cls):
        return int(cls) in self._sup_cache

    def batch_support_feats(self, classes):
        """Cached (feat [B,n,h,w,C], pooled [B,n,7,7,C]) for the query
        batch's target classes."""
        fs = [self._sup_cache[int(c)] for c in classes]
        return (torch.cat([f[0] for f in fs]), torch.cat([f[1] for f in fs]))

    @torch.inference_mode()
    def predict(self, im_data, im_info, classes):
        """im_data [B,H,W,3] uint8 BGR or float mean-subtracted, im_info
        [B,3] (height, width, scale), classes [B] whose supports were
        encoded -> (dets [B,100,5], valid [B,100]) on the device.  Host
        arrays or tensors; a tensor in pinned memory is copied without
        blocking the host."""
        with record_function('dana.upload'):
            im_data = torch.as_tensor(im_data).to(self.device,
                                                  non_blocking=True)
            im_info = torch.as_tensor(im_info).to(self.device,
                                                  non_blocking=True).float()
            support_feats = self.batch_support_feats(classes)
        out = dana.forward(self.model, self.config, im_data, im_info,
                           support_feats=support_feats)
        with record_function('dana.postprocess'):
            return postprocess_batch(
                out['rois'], out['cls_prob'], out['bbox_pred'], im_info,
                bbox_stds=self.config.bbox_normalize_stds,
                bbox_means=self.config.bbox_normalize_means,
                **self.postprocess)
