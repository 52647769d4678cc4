"""Attention maps of the RPN's CISA site (port of dana_tpu/models/viz.py).

`rpn_attention_relevance` gives, for each cell of a query's stride-16
map, how peaked its attention over one support's tokens is: the q and k
projections of the RPN site (per-shot positional tables and centring, as
the model builds its tokens), a softmax over each shot's keys, the max over
the keys and the mean over the shots.  The model's own forward never forms
the attention matrix (K1 fuses it away), so this is plain torch math on the
detector's modules.  `overlay_heatmap` draws such a map on an image (numpy,
nearest-neighbour upsampling).  tools/torch_visualize_attention.py and
utils/fsod_logger.py `FSODInferenceLogger.write_attention` use both.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dana_tpu_torch.models import dana


def rpn_attention_relevance(model, config, query_blob, support_blob):
    """query_blob [H, W, 3] and support_blob [sh, sw, 3] or [n, sh, sw, 3]
    (BGR, mean-subtracted) -> [H/16, W/16] float32 numpy relevance: the
    peakiness of each query cell's support attention, in (0, 1].  Runs on
    the device of `model` (a detector module) in config.compute_dtype."""
    dev = next(model.parameters()).device
    q = torch.as_tensor(np.asarray(query_blob, np.float32), device=dev)[None]
    sup = torch.as_tensor(np.asarray(support_blob, np.float32), device=dev)
    if sup.dim() == 3:
        sup = sup[None]
    with torch.inference_mode():
        base = dana.trunk_base(model, q.to(config.compute_dtype))
        sfeat = dana.trunk_base(model, sup.to(config.compute_dtype))
        _, h, w, c = base.shape
        n, sh, sw = sfeat.shape[:3]
        q_tokens = base.reshape(1, h * w, c)
        s_tokens = sfeat.reshape(1, n, sh * sw, c)
        if config.pos_encoding:
            s_tokens = s_tokens + torch.as_tensor(
                dana.positional_encoding(sh * sw, config.feat_dim),
                device=dev)
        qm = model.rpn_adapt_q_layer(q_tokens)
        qm = qm - qm.mean(dim=-2, keepdim=True)
        km = model.rpn_adapt_k_layer(s_tokens)
        km = km - km.mean(dim=-2, keepdim=True)             # per shot
        attn = torch.softmax(torch.einsum('bqd,bskd->bsqk', qm, km)
                             / math.sqrt(config.rpn_reduce_dim), dim=-1)
        heat = attn.amax(dim=-1).mean(dim=1)[0].reshape(h, w)
    return heat.float().cpu().numpy()


def overlay_heatmap(im_rgb, heat, alpha=0.5):
    """A [h, w] map (any scale) over an [H, W, 3] uint8 image as red
    intensity: min-max normalised, nearest-neighbour upsampled ->
    uint8 [H, W, 3]."""
    im = np.asarray(im_rgb).astype(np.float32)
    H, W = im.shape[:2]
    h, w = heat.shape
    heat = np.asarray(heat, np.float32)
    rng = heat.max() - heat.min()
    heat = (heat - heat.min()) / (rng if rng > 0 else 1.0)
    ys = np.clip((np.arange(H) * h) // max(H, 1), 0, h - 1)
    xs = np.clip((np.arange(W) * w) // max(W, 1), 0, w - 1)
    up = heat[np.ix_(ys, xs)]
    out = im.copy()
    out[..., 0] = (1 - alpha * up) * im[..., 0] + alpha * up * 255.0
    out[..., 1] = (1 - alpha * up) * im[..., 1]
    out[..., 2] = (1 - alpha * up) * im[..., 2]
    return np.clip(out, 0, 255).astype(np.uint8)
