#!/usr/bin/env python3
"""Why the serving RoIAlign kernel (K2) and the training one (K3) sit at
different distances from their plain versions, on one CUDA card.

    python3 tools/roi_taps_replay.py [--seed 0]

Both kernels run one row-pooling body (`dana_tpu_torch/ops/csrc/
roi_align.cu`); K2 builds the axis weights Wy / Wx from the rois inside the
kernel, K3 is given them.  On `chip_smoke.py`'s serving rois and unit-
variance features at the first query bucket's map (8 x 38 x 64 x 1024), this
compares, per roi:
  * K2 against K3 on `roi_weights` built on the card and on the CPU;
  * the weights `roi_weights` builds on the card and on the CPU, per bin;
  * the bin width extent / P that each device computes, against IEEE
    division and against a product with the float32 reciprocal of P.
The last line is one JSON object with the numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('roi_taps_replay: needs a CUDA card')
    import chip_smoke
    from dana_tpu_torch.ops import roi_align as ra
    from dana_tpu_torch.utils import config as cfg
    from dana_tpu_torch.utils.device import use_full_f32
    use_full_f32()
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)

    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    p, c = cfg.POOLING_SIZE, 1024
    fh, fw = (s // cfg.FEAT_STRIDE for s in chip_smoke.QUERY_HW)
    feat = torch.randn(chip_smoke.BATCH, fh, fw, c, device=dev, generator=gen)
    rois = chip_smoke.serving_rois(chip_smoke.BATCH,
                                   cfg.TEST_RPN_POST_NMS_TOP_N, gen, dev)
    scale = 1.0 / cfg.FEAT_STRIDE
    with torch.inference_mode():
        k2 = ra.roi_align(feat, rois, p, scale)
        w_dev = ra.roi_weights(rois, fh, fw, p, scale)
        w_cpu = [w.to(dev) for w in ra.roi_weights(rois.cpu(), fh, fw, p,
                                                   scale)]
        k3_dev = ra.roi_align_pw(feat, *w_dev)
        k3_cpu = ra.roi_align_pw(feat, *w_cpu)
        plain = ra.roi_align_plain(feat, rois, p, scale)
        torch.cuda.synchronize()

    def per_roi(a, b):
        return (a - b).abs().flatten(2).amax(-1)             # [B, R]

    d_dev, d_cpu = per_roi(k2, k3_dev), per_roi(k2, k3_cpu)
    wdiff = [(a - b).abs().amax(-1) for a, b in zip(w_dev, w_cpu)]
    bins_moved = sum(int((d > 0).sum()) for d in wdiff)
    rois_moved = int(((wdiff[0] > 0).any(-1) | (wdiff[1] > 0).any(-1))
                     .sum())
    worst = divmod(int(d_dev.argmax()), d_dev.shape[1])

    # the bin width on each device against the two roundings
    r = rois[..., 1:].float() * scale
    ext = torch.stack([r[..., 3] - r[..., 1], r[..., 2] - r[..., 0]],
                      -1).clamp(min=1.0)
    inv = torch.tensor(1.0 / p, dtype=torch.float32)
    ieee = (ext.double() / p).float()
    by_recip = ext * inv.to(dev)
    width = {'cuda': ext / p, 'cpu': (ext.cpu() / p).to(dev)}
    share = {f'{d}_equals_{k}': float((w == ref).float().mean())
             for d, w in width.items()
             for k, ref in (('ieee', ieee), ('reciprocal', by_recip))}
    out = {
        'k2_vs_k3_on_card_weights': float(d_dev.max()),
        'k2_vs_k3_on_cpu_weights': float(d_cpu.max()),
        'k2_vs_plain': float((k2 - plain).abs().max()),
        'k3_card_weights_vs_plain': float((k3_dev - plain).abs().max()),
        'weights_card_vs_cpu_max': max(float(d.max()) for d in wdiff),
        'weight_rows_differing': bins_moved,
        'rois_differing': rois_moved,
        'rois': int(d_dev.numel()),
        'worst_roi': {'image': worst[0], 'roi': worst[1],
                      'box': rois[worst].tolist(),
                      'k2_vs_k3_card': float(d_dev[worst]),
                      'k2_vs_k3_cpu': float(d_cpu[worst])},
        'bin_width_share': share,
    }
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
