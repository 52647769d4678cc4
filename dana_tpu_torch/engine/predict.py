"""The serving entry point: a predictor that answers detection requests
(port of the JAX package's eval loop, inference.py `encode_supports` /
`predict`, and engine/train.py `predict_step`).  DAnA and cisa encode
each class's supports once and serve from that cache; FSOD, Meta R-CNN
and FGN take each request's support images and encode them with it, as
the JAX CLI does.  Faster R-CNN is refused: its class-specific deltas
[B, R, 8] meet the postprocess's 4 bbox stds, which the JAX package's
postprocess cannot broadcast either."""

from __future__ import annotations

import torch
import torch.nn as nn
from torch.profiler import record_function

from dana_tpu_torch.engine.postprocess import postprocess_batch
from dana_tpu_torch.models import dana, frameworks
from dana_tpu_torch.utils import config as cfg
from dana_tpu_torch.utils.device import resolve_device, use_full_f32
from dana_tpu_torch.utils.weights import from_jax_params


class Predictor:
    """Predictor(params, config, device='cuda', postprocess=None).

    params: the JAX package's param tree (numpy leaves) of
    config.framework's detector, or its built module.  The device defaults
    to the card and the constructor raises without CUDA unless
    device='cpu' is passed; on the card float32 math runs without TF32
    (utils.device.use_full_f32).  The detector computes in the config's
    precision recipe (compute_dtype, attention_dt, head_dt); the support
    cache holds compute_dtype features, and the postprocess takes
    float32.
    `postprocess` is the detection postprocess's keywords
    (`utils.config.postprocess_kwargs` of the CLI's tree; the built-in
    tree's when None).
    """

    def __init__(self, params, config: dana.DanaConfig, device='cuda',
                 postprocess=None):
        self.device = resolve_device(device)
        if config.framework == 'frcnn':
            raise ValueError(
                'frcnn has no serving path: its class-specific deltas [B, R, '
                '8] meet the postprocess\'s 4 bbox stds, which the JAX '
                'package\'s postprocess (engine/postprocess.py:38) cannot '
                'broadcast either')
        if self.device.type == 'cuda':
            use_full_f32()
        model = params if isinstance(params, nn.Module) \
            else from_jax_params(params, config)
        self.model = model.to(self.device)
        self.config = config
        self.postprocess = postprocess or cfg.postprocess_kwargs()
        self._sup_cache = {}

    @property
    def caches_supports(self):
        """True for DAnA and cisa (encode_supports, then predict by
        class); False for the siblings (predict with support_ims)."""
        return self.config.framework in dana.CACHED_SUPPORTS

    @torch.inference_mode()
    def encode_supports(self, cls, support_ims):
        """Encode one class's supports [n_shot, H, W, 3] (float, mean-
        subtracted) once and cache them under `cls` (DAnA and cisa)."""
        if not self.caches_supports:
            raise ValueError(f'{self.config.framework} keeps no support '
                             'cache: pass each request\'s support_ims')
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
    def predict(self, im_data, im_info, classes=None, support_ims=None):
        """im_data [B,H,W,3] uint8 BGR or float mean-subtracted, im_info
        [B,3] (height, width, scale), and for DAnA and cisa classes [B]
        whose supports were encoded, for the siblings support_ims [B,
        n_shot, H, W, 3] float mean-subtracted -> (dets [B,100,5], valid
        [B,100]) on the device.  Host arrays or tensors; a tensor in pinned
        memory is copied without blocking the host."""
        with record_function('dana.upload'):
            im_data = torch.as_tensor(im_data).to(self.device,
                                                  non_blocking=True)
            im_info = torch.as_tensor(im_info).to(self.device,
                                                  non_blocking=True).float()
            if self.caches_supports:
                kw = dict(support_feats=self.batch_support_feats(classes))
            else:
                kw = dict(support_ims=torch.as_tensor(support_ims).to(
                    self.device, non_blocking=True).float())
        out = frameworks.forward(self.model, self.config, im_data, im_info,
                                 **kw)
        with record_function('dana.postprocess'):
            return postprocess_batch(
                out['rois'], out['cls_prob'].float(),
                out['bbox_pred'].float(), im_info,
                bbox_stds=self.config.bbox_normalize_stds,
                bbox_means=self.config.bbox_normalize_means,
                **self.postprocess)
