#!/usr/bin/env python3
"""The RPN site's attention over a query, drawn on the query, on the
PyTorch port (the counterpart of tools/visualize_attention.py; the
reference README's attention_visualization.jpg).

    python3 tools/torch_visualize_attention.py <query> <support> <out.ppm>
        [checkpoint.dkpt|.pth] [--device cpu]

Reads both images with the port's reader (PPM or `.npy` in numpy, other
formats through cv2 when it imports), preprocesses the query as the
loaders do and the support as a whole-image crop, computes the relevance
of each stride-16 query cell (models/viz.py `rpn_attention_relevance`) on
the 2-way 1-shot detector (the checkpoint's weights, with or without the
BA block as it holds them, or random ones from seed 0), colours it with a
numpy jet map, upsamples it bilinearly to the query and blends it half and
half with the query.  A `.ppm` / `.pnm` output is
written in numpy, any other through cv2.  Runs on the card unless --device
cpu is given.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def jet(x):
    """[..., ] values in [0, 1] -> [..., 3] uint8 BGR of the jet colour
    map (blue -> cyan -> yellow -> red)."""
    x = np.asarray(x, np.float32)[..., None]
    rgb = np.clip(1.5 - np.abs(4 * x - np.array([3, 2, 1], np.float32)),
                  0, 1)
    return (rgb[..., ::-1] * 255).round().astype(np.uint8)


def attention_map(model, config, query_im, support_im, c):
    """BGR images -> ([h, w] relevance, query im_info)."""
    from dana_tpu_torch.data import blob
    from dana_tpu_torch.models.viz import rpn_attention_relevance
    q, info = blob.query_blob(query_im, c.PIXEL_MEANS)
    sh, sw = support_im.shape[:2]
    s = blob.support_blob(support_im, [0, 0, sw - 1, sh - 1], c.PIXEL_MEANS)
    return rpn_attention_relevance(model, config, q, s), info


def overlay(query_im, rel):
    """The jet-coloured relevance, normalised to [0, 1] and resized to the
    query image, blended half and half with it -> uint8 BGR."""
    from dana_tpu_torch.data import blob
    rel = (rel - rel.min()) / (np.ptp(rel) + 1e-9)
    heat = jet(rel).astype(np.float32)
    heat = blob.resize_linear(heat, (query_im.shape[0], query_im.shape[1]))
    return np.clip(0.5 * query_im + 0.5 * heat, 0, 255).astype(np.uint8)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('query')
    ap.add_argument('support')
    ap.add_argument('out')
    ap.add_argument('checkpoint', nargs='?')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)

    from dana_tpu_torch.data import blob
    from dana_tpu_torch.models import dana
    from dana_tpu_torch.utils import checkpoint as ck
    from dana_tpu_torch.utils.config import default_cfg
    from dana_tpu_torch.utils.device import resolve_device
    from dana_tpu_torch.utils.weights import from_jax_params
    c = default_cfg()
    config = dana.DanaConfig(n_way=2, n_shot=1)
    if args.checkpoint:
        payload = ck.read_checkpoint(args.checkpoint)
        # the BA block's layer is in the checkpoint or not (DAnA or cisa)
        ba = any(k.startswith('rpn_channel_k_layer') for k in
                 payload['model'])
        config = dana.DanaConfig(n_way=2, n_shot=1, semantic_enhance=ba)
        model, _ = ck.load_checkpoint(args.checkpoint, config, payload)
    else:
        model = from_jax_params(dana.init_params(config, seed=0), config)
    model = model.to(resolve_device(args.device))

    query = blob.imread_bgr(args.query).astype(np.float32)
    support = blob.imread_bgr(args.support).astype(np.float32)
    rel, _ = attention_map(model, config, query, support, c)
    out = overlay(query, rel)
    if args.out.lower().endswith(('.ppm', '.pnm')):
        blob.write_ppm(args.out, out)
    else:
        import cv2
        cv2.imwrite(args.out, out)
    print(f'wrote {args.out}')
    return out


if __name__ == '__main__':
    main()
