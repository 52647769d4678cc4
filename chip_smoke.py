#!/usr/bin/env python3
"""Drive the PyTorch port (dana_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed 0]

Run from the repository root.  Phases, each of which fails the run:
  1. device: a CUDA card must be present; prints its name and power
     limit, the torch / CUDA versions and the float32 (TF32) flags;
  2. build: every kernel of the serving and training paths is compiled
     by nvcc from dana_tpu_torch/ops/csrc, one nvcc per source, all at
     once;
  3. kernels: each kernel's wrapper is held against its plain PyTorch
     version on the card (|kernel - plain| <= 1e-4 + 1e-4 |plain|: both
     sum float32 products in different orders) at the shapes the serving
     and training paths give it plus edge shapes, and timed with CUDA
     events beside its plain version, a library yardstick and its bound
     (the CISA kernels' at the 3xTF32 tensor-core rate, with their
     achieved TFLOP/s; the RoIAlign kernels' with their GB/s, the bytes
     they read through L2 by the taps they keep, and their time without
     the rois that span the whole map);
     the backward passes of the CISA and RoIAlign autograd Functions are
     held against autograd of the plain versions; K1 at its serving RPN
     site and K2 are also held (and timed) at the other four query
     buckets' shapes (K1's RoI site has one shape at every bucket), and
     K2 against K3 on the same rois' axis weights at
     K2_TOL (the two share one pooling body and, since the plain weights
     divide as the kernel does, their weights);
  4. serving: the DAnA ResNet-50 2-way 3-shot detector with random
     weights from --seed serves REQUESTS requests of BATCH uint8
     608x1024 queries against two classes whose 320px supports were
     encoded once.  The launch counters are zeroed just before and read
     just after; every kernel of the path must have launched, and the
     single-group CISA (no site on this path or the next) never.  The
     outputs must be finite and of the right shapes, and the first
     request, served again with the plain versions in place of the
     kernels (and the kernel path's proposals), must agree: the RPN's
     scores and deltas, the R-CNN head's outputs and the detections
     (tie-aware matching);
  5. training: a Trainer on the same detector takes STEPS SGD steps on
     seeded episodes of TRAIN_BATCH uint8 608x1024 queries, 1-5 gt boxes
     each and 2x3 supports of 320px.  The counters are zeroed just before
     and read just after: 3 CISA and 1 RoIAlign-from-weights launches a
     step, no single-group CISA launch.  Losses must be finite, no step
     skipped, fg rois sampled, every trainable parameter moved and every
     frozen one unchanged.  Step 0,
     run again on the plain versions from the same weights, draws and
     proposals, must give the same losses (1e-4 relative) and gradients
     (GRAD_RTOL of each parameter's gradient norm);
  6. the dataset CLI: `dana_tpu_torch.inference.main` evaluates the
     synth_test split (20 images, written with synth_train into a
     temporary DANA_SYNTH_ROOT by the port's generator) with --way 2 --shot
     3 --bs 8 at the full default config (cfgs/res50.yml values, --ascale
     4: 12 anchors, 600 px queries, 6000/300 proposals), random weights
     from --seed.  The counters are zeroed just before and read just
     after: 2 CISA and 1 RoIAlign launches a chunk, none of the training
     kernels.  Every image's target-class cell of all_boxes must hold
     finite detections and COCOeval must return 12 finite stats; img/s,
     the host-side timing and the stats are printed (AP on random
     weights is near 0 and not judged).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, published
FP32_FLOP_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
TF32_TC_FLOP_PER_S = 495e12   # H100 SXM TF32 tensor cores, dense
# K1 and K4 take each float32 product as three TF32 products (3xTF32)
CISA_FLOP_PER_S = TF32_TC_FLOP_PER_S / 3
TOL = 1e-4
# K2 against K3 on the same rois' weights: one pooling body, weights that
# differ only in the order each entry sums its samples
K2_TOL = 1e-6
ROI_ATOL = 2e-3               # px: a proposal counted as moved (ROADMAP)
BOX_ATOL = 1e-3               # px, detections of a unique score
QUERY_HW = (608, 1024)        # first query canvas bucket
# the other query canvases the loaders emit (TPU.SIZE_BUCKETS)
OTHER_BUCKETS = ((1024, 608), (704, 704), (608, 1216), (1216, 608))
SUPPORT_HW = 320
BATCH = 8                     # queries per request
REQUESTS = 3
TRAIN_BATCH = 4               # episodes per training step
STEPS = 3
MAX_GT = 20                   # gt slots per query (1-5 boxes filled)
# float32 sums in another order in the kernel and plain forwards move a
# step's gradients by about 1e-6 of their norm; the mined background rois
# of the R-CNN loss are picked by rank, so a near tie could flip a pick
GRAD_RTOL = 1e-3
LOSS_RTOL = 1e-4


def fail(msg):
    print(f'chip_smoke: FAIL: {msg}', file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, iters, warmup=2):
    """Mean ms per call over `iters` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, flops, flop_per_s=FP32_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                 else 'operations')


def cisa_site(fn, plain, library, nbytes, flops):
    """Times of a CISA kernel site beside its plain version and library
    yardstick; its bound at the 3xTF32 tensor-core rate, and at the
    float32 rate outside the tensor cores for comparison."""
    b_ms, b_by = bound_ms(nbytes, flops, CISA_FLOP_PER_S)
    ms = cuda_ms(fn, 10)
    return dict(ms=ms, plain_ms=cuda_ms(plain, 5),
                library_ms=cuda_ms(library, 5), bound_ms=b_ms,
                bound_by=b_by, bound_rate='3xTF32 tensor cores',
                simt_bound_ms=bound_ms(nbytes, flops)[0],
                tflop_per_s=flops / ms / 1e9, flops=flops, bytes=nbytes)


def check_close(name, got, want, tol=TOL):
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not torch.isfinite(got).all():
        fail(f'{name}: kernel output is not finite')
    if not torch.allclose(got, want, rtol=tol, atol=tol):
        fail(f'{name}: kernel disagrees with its plain version '
             f'(max |err| {err:.3e}, tolerance {tol:g})')
    return err


# ---------------------------------------------------------------- phase 3

def cisa_library(q, k, v, u, scale, gamma):
    """K1's yardstick: SDPA over the shots as heads, plus the
    query-independent unary term, then the shot mean (timed here; the
    port never calls it)."""
    import torch.nn.functional as F
    o = F.scaled_dot_product_attention(
        q[:, None].expand(-1, k.shape[1], -1, -1), k, v, scale=scale)
    return (o + gamma * (u[:, :, None, :] @ v)).mean(1)


def check_cisa(dev, gen):
    from dana_tpu_torch.ops.cisa_attention import (
        cisa_attention_shots, cisa_attention_shots_plain)
    from dana_tpu_torch.utils import config as cfg
    library = cisa_library

    fh, fw = (s // cfg.FEAT_STRIDE for s in QUERY_HW)
    ns_rpn = (SUPPORT_HW // cfg.FEAT_STRIDE) ** 2
    bins = cfg.POOLING_SIZE ** 2
    # (G, S, Nq, Ns, D, C): the two serving-path sites of a request, the
    # training step's (its RoI site runs twice), then edge shapes
    cases = {'rpn': (BATCH, 3, fh * fw, ns_rpn, 256, 1024),
             'roi': (BATCH, 3, cfg.TEST_RPN_POST_NMS_TOP_N * bins, bins, 256,
                     1024),
             'train_rpn': (TRAIN_BATCH, 3, fh * fw, ns_rpn, 256, 1024),
             'train_roi': (TRAIN_BATCH, 3, cfg.TRAIN_BATCH_SIZE * bins, bins,
                           256, 1024),
             'ns1': (2, 3, 1000, 1, 256, 1024),
             'ragged': (3, 2, 77, 57, 256, 1100)}
    err, sites = 0.0, {}
    for name, (g, s, nq, ns, d, c) in cases.items():
        q = torch.randn(g, nq, d, device=dev, generator=gen)
        k = torch.randn(g, s, ns, d, device=dev, generator=gen)
        v = torch.randn(g, s, ns, c, device=dev, generator=gen)
        u = torch.softmax(torch.randn(g, s, ns, device=dev, generator=gen),
                          -1)
        args = (q, k, v, u, 1.0 / 16.0, 0.1)
        want = cisa_attention_shots_plain(*args)
        case_err = check_close(f'cisa_shots[{name}]',
                               cisa_attention_shots(*args), want)
        err = max(err, case_err)
        lib_err = (library(*args) - want).abs().max().item()
        if name in ('rpn', 'roi', 'train_rpn', 'train_roi'):
            nbytes = 4 * (q.numel() + k.numel() + v.numel() + u.numel()
                          + g * nq * c)
            flops = 2 * g * s * nq * ns * (d + c)
            sites[name] = cisa_site(
                lambda: cisa_attention_shots(*args),
                lambda: cisa_attention_shots_plain(*args),
                lambda: library(*args), nbytes, flops)
        print(f'cisa_shots[{name}] G={g} S={s} Nq={nq} Ns={ns} D={d} C={c}:'
              f' max|kernel-plain| {case_err:.3e}, max|library-plain| '
              f'{lib_err:.3e}' + (f', {sites[name]}' if name in sites
                                  else ''), flush=True)
        del q, k, v, u, want, args
    return err, sites


def _sample_counts(rois, p):
    """Samples per bin axis that these rois need (the kernel's rule)."""
    r = rois[..., -4:] / 16.0
    ext = torch.stack([r[..., 3] - r[..., 1], r[..., 2] - r[..., 0]],
                      -1).clamp(min=1.0)
    q = torch.floor(ext / p)
    return (q + (q * p < ext).float()).clamp(1, 16)       # max_samples


def roi_taps(wy, wx, c):
    """The work of the RoIAlign kernels' shared body on these weights: one
    block per (b, r, ph) row of bins reads each kept feature row (h with
    Wy[ph, h] != 0, w with some Wx[pw, w] != 0) once.  -> (operations:
    stage 1 over the kept rows for every kept column, stage 2 over P x P
    bins; modelled bytes read through L2: kept rows x kept columns x 4 C
    summed over (b, r, ph))."""
    nh = (wy != 0).sum(-1)                                  # [B,R,P]
    nw = (wx != 0).any(-2).sum(-1)                          # [B,R]
    p = wy.shape[2]
    flops = 2 * c * (nw * (nh.sum(-1) + p * p)).sum().item()
    return flops, 4 * c * (nh * nw[..., None]).sum().item()


def roi_site(fn, plain, nbytes, flops, gather, fn_cut, library=None):
    """Times of a RoIAlign kernel beside its plain version (and library
    yardstick), its bound, and its rates: GB/s of the counted bytes and of
    the modelled L2 bytes; `fn_cut`: the kernel on the same rois without
    the whole-map ones (`without_whole_map`), whose rows are the longest."""
    b_ms, b_by = bound_ms(nbytes, flops)
    ms = cuda_ms(fn, 10)
    return dict(ms=ms, plain_ms=cuda_ms(plain, 3),
                library_ms=None if library is None else cuda_ms(library, 3),
                bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes,
                gb_per_s=nbytes / ms / 1e6, gather_bytes=gather,
                gather_gb_per_s=gather / ms / 1e6,
                ms_without_whole_map=cuda_ms(fn_cut, 10))


def without_whole_map(rois):
    """`serving_rois` with each image's two whole-map edge rois (5 and 6)
    replaced by copies of two random ones."""
    out = rois.clone()
    out[:, 5:7] = rois[:, 8:10]
    return out


def serving_rois(b, r, gen, dev, hw=None):
    """Proposal-like rois on an image of the query bucket `hw` (default
    QUERY_HW), edge cases first."""
    h, w = hw or QUERY_HW
    edge = torch.tensor([
        [-40, -30, 60, 50], [900, 500, 1100, 700], [-300, 20, -20, 60],
        [30, 30, 30.4, 30.2], [80, 80, 60, 50], [0, 0, 3000, 2500],
        [0, 0, w - 1, h - 1], [16, 16, 16 + 21 * 16, 48]], device=dev)
    n = r - edge.shape[0]
    ctr = torch.rand(b, n, 2, device=dev, generator=gen) * torch.tensor(
        [w, h], device=dev)
    size = 2 ** (torch.rand(b, n, 2, device=dev, generator=gen) * 4 + 5)
    rand = torch.cat([ctr - size / 2, ctr + size / 2], -1)
    boxes = torch.cat([edge.expand(b, -1, -1), rand], 1)
    batch = torch.arange(b, device=dev, dtype=torch.float32)
    return torch.cat([batch[:, None, None].expand(b, r, 1), boxes],
                     -1).contiguous()


def check_roi_align(dev, gen):
    from dana_tpu_torch.ops.roi_align import (roi_align, roi_align_plain,
                                              roi_align_pw, roi_weights)
    from dana_tpu_torch.utils import config as cfg
    b, r, c = BATCH, cfg.TEST_RPN_POST_NMS_TOP_N, 1024
    p = cfg.POOLING_SIZE
    fh, fw = (s // cfg.FEAT_STRIDE for s in QUERY_HW)
    feat = torch.randn(b, fh, fw, c, device=dev, generator=gen)
    rois = serving_rois(b, r, gen, dev)
    want = roi_align_plain(feat, rois, p, 1 / 16.0)
    got = roi_align(feat, rois, p, 1 / 16.0)
    err = check_close('roi_align_fwd', got, want, K2_TOL)
    weights = roi_weights(rois, fh, fw, p, 1 / 16.0)
    c3_err = check_close('roi_align_fwd against roi_align_pw on its rois\' '
                         'weights', got, roi_align_pw(feat, *weights),
                         K2_TOL)
    nbytes = 4 * (feat.numel() + rois.numel() + want.numel())
    flops, gather = roi_taps(*weights, c)
    cut = without_whole_map(rois)
    site = roi_site(lambda: roi_align(feat, rois, p, 1 / 16.0),
                    lambda: roi_align_plain(feat, rois, p, 1 / 16.0),
                    nbytes, flops, gather,
                    lambda: roi_align(feat, cut, p, 1 / 16.0))
    # K2's earlier form, a block per output bin: 4 corner rows of 4 C
    # bytes for every sample of every bin
    counts = _sample_counts(rois, p)
    site['bin_gather_bytes'] = 16 * c * p * p * (counts[..., 0]
                                                 * counts[..., 1]).sum().item()
    site['max_abs_err_vs_roi_align_pw'] = c3_err
    print(f'roi_align_fwd feat={tuple(feat.shape)} rois={tuple(rois.shape)}:'
          f' max|kernel-plain| {err:.3e}, max|K2-K3 on its weights| '
          f'{c3_err:.3e}, {site}', flush=True)
    return err, site


def check_buckets(dev, gen):
    """K1 at its serving RPN site and K2 at the shapes each of the other
    query buckets gives them (BATCH images, 300 rois), against their plain
    versions, timed; -> (max errors {name: err}, {bucket: sites}).  K1's
    RoI site (Nq = 300 * 49, Ns = 49) has one shape at every bucket: phase
    3 holds it once."""
    from dana_tpu_torch.ops.cisa_attention import (
        cisa_attention_shots, cisa_attention_shots_plain)
    from dana_tpu_torch.ops.roi_align import roi_align, roi_align_plain
    from dana_tpu_torch.utils import config as cfg
    ns_rpn = (SUPPORT_HW // cfg.FEAT_STRIDE) ** 2
    p = cfg.POOLING_SIZE
    errs, out = {'cisa_shots': 0.0, 'roi_align_fwd': 0.0}, {}
    for hw in OTHER_BUCKETS:
        fh, fw = (s // cfg.FEAT_STRIDE for s in hw)
        nq, ns = fh * fw, ns_rpn
        q = torch.randn(BATCH, nq, 256, device=dev, generator=gen)
        k = torch.randn(BATCH, 3, ns, 256, device=dev, generator=gen)
        v = torch.randn(BATCH, 3, ns, 1024, device=dev, generator=gen)
        u = torch.softmax(torch.randn(BATCH, 3, ns, device=dev,
                                      generator=gen), -1)
        args = (q, k, v, u, 1.0 / 16.0, 0.1)
        e = check_close(f'cisa_shots[rpn {hw}]', cisa_attention_shots(*args),
                        cisa_attention_shots_plain(*args))
        errs['cisa_shots'] = max(errs['cisa_shots'], e)
        flops = 2 * BATCH * 3 * nq * ns * (256 + 1024)
        row = {'rpn': dict(
            nq=nq, max_abs_err=e,
            ms=cuda_ms(lambda: cisa_attention_shots(*args), 10),
            plain_ms=cuda_ms(lambda: cisa_attention_shots_plain(*args), 3),
            bound_ms=bound_ms(4 * (q.numel() + k.numel() + v.numel()
                                   + u.numel() + BATCH * nq * 1024),
                              flops, CISA_FLOP_PER_S)[0])}
        del q, k, v, u, args
        feat = torch.randn(BATCH, fh, fw, 1024, device=dev, generator=gen)
        rois = serving_rois(BATCH, cfg.TEST_RPN_POST_NMS_TOP_N, gen, dev, hw)
        got = roi_align(feat, rois, p, 1 / 16.0)
        e = check_close(f'roi_align_fwd[{hw}]', got,
                        roi_align_plain(feat, rois, p, 1 / 16.0), K2_TOL)
        errs['roi_align_fwd'] = max(errs['roi_align_fwd'], e)
        row['roi_align'] = dict(
            map=(fh, fw), max_abs_err=e,
            ms=cuda_ms(lambda: roi_align(feat, rois, p, 1 / 16.0), 10),
            plain_ms=cuda_ms(lambda: roi_align_plain(feat, rois, p, 1 / 16.0),
                             3),
            bound_ms=bound_ms(4 * (feat.numel() + rois.numel()
                                   + got.numel()), 0)[0])
        del feat, rois, got
        out['x'.join(map(str, hw))] = row
        print(f'bucket {hw}: {row}', flush=True)
    return errs, out


def check_cisa_single(dev, gen):
    """K4: single-group CISA, the cisa_shots kernel entered at S = 1."""
    from dana_tpu_torch.ops.cisa_attention import (cisa_attention,
                                                   cisa_attention_plain)
    import torch.nn.functional as F

    def library(q, k, v, u, scale, gamma):
        return (F.scaled_dot_product_attention(q, k, v, scale=scale)
                + gamma * (u @ v))

    fh, fw = (s // 16 for s in QUERY_HW)
    cases = {'main': (BATCH, fh * fw, (SUPPORT_HW // 16) ** 2, 256, 1024),
             'ns1': (4, 1000, 1, 256, 1024),
             'ragged': (3, 77, 57, 256, 1100)}
    err, site = 0.0, None
    for name, (g, nq, ns, d, c) in cases.items():
        q = torch.randn(g, nq, d, device=dev, generator=gen)
        k = torch.randn(g, ns, d, device=dev, generator=gen)
        v = torch.randn(g, ns, c, device=dev, generator=gen)
        u = torch.softmax(torch.randn(g, 1, ns, device=dev, generator=gen),
                          -1)
        args = (q, k, v, u, 1.0 / 16.0, 0.1)
        want = cisa_attention_plain(*args)
        case_err = check_close(f'cisa_attention[{name}]',
                               cisa_attention(*args), want)
        err = max(err, case_err)
        lib_err = (library(*args) - want).abs().max().item()
        if name == 'main':
            nbytes = 4 * (q.numel() + k.numel() + v.numel() + u.numel()
                          + g * nq * c)
            flops = 2 * g * nq * ns * (d + c)
            site = cisa_site(lambda: cisa_attention(*args),
                             lambda: cisa_attention_plain(*args),
                             lambda: library(*args), nbytes, flops)
        print(f'cisa_attention[{name}] G={g} Nq={nq} Ns={ns} D={d} C={c}: '
              f'max|kernel-plain| {case_err:.3e}, max|library-plain| '
              f'{lib_err:.3e}' + (f', {site}' if name == 'main' else ''),
              flush=True)
        del q, k, v, u, want, args
    return err, site


def pw_library(wy, feat, wx):
    """K3's yardstick: its whole function as one batched three-operand
    einsum (timed here; the port never calls it)."""
    return torch.einsum('brph,bhwc,brqw->brpqc', wy, feat, wx)


def check_roi_align_pw(dev, gen):
    """K3: RoIAlign from precomputed axis weights, at the training step's
    shapes (TRAIN_BATCH images, 128 sampled rois, edge cases first)."""
    from dana_tpu_torch.ops.roi_align import (roi_align_pw,
                                              roi_align_pw_plain,
                                              roi_weights)
    from dana_tpu_torch.utils import config as cfg
    b, r, c, p = TRAIN_BATCH, cfg.TRAIN_BATCH_SIZE, 1024, cfg.POOLING_SIZE
    fh, fw = (s // cfg.FEAT_STRIDE for s in QUERY_HW)
    feat = torch.randn(b, fh, fw, c, device=dev, generator=gen)
    rois = serving_rois(b, r, gen, dev)
    wy, wx = roi_weights(rois, fh, fw, p, 1 / cfg.FEAT_STRIDE)
    wy_cut, wx_cut = roi_weights(without_whole_map(rois), fh, fw, p,
                                 1 / cfg.FEAT_STRIDE)
    want = roi_align_pw_plain(feat, wy, wx)
    err = check_close('roi_align_pw', roi_align_pw(feat, wy, wx), want)
    lib_err = (pw_library(wy, feat, wx) - want).abs().max().item()
    nbytes = 4 * (feat.numel() + wy.numel() + wx.numel() + want.numel())
    flops, gather = roi_taps(wy, wx, c)
    site = roi_site(lambda: roi_align_pw(feat, wy, wx),
                    lambda: roi_align_pw_plain(feat, wy, wx), nbytes, flops,
                    gather, lambda: roi_align_pw(feat, wy_cut, wx_cut),
                    library=lambda: pw_library(wy, feat, wx))
    site['dense_flops'] = 2 * c * b * r * p * (fh * fw + p * fw)
    print(f'roi_align_pw feat={tuple(feat.shape)} wy={tuple(wy.shape)} '
          f'wx={tuple(wx.shape)}: max|kernel-plain| {err:.3e}, '
          f'max|library-plain| {lib_err:.3e}, {site}', flush=True)
    return err, site


def check_backward(dev, gen):
    """The training step's autograd Functions (K1's forward with the plain
    recompute VJP; K3's forward with the plain contraction of the saved
    weights) against autograd of the plain versions, at the training
    shapes: gradients, and forward + backward times beside a library
    yardstick and the bound of forward + backward."""
    from dana_tpu_torch.ops import cisa_attention as ca
    from dana_tpu_torch.ops import roi_align as ra
    from dana_tpu_torch.utils import config as cfg
    fh, fw = (s // cfg.FEAT_STRIDE for s in QUERY_HW)
    g, s_, ns = TRAIN_BATCH, 3, (SUPPORT_HW // cfg.FEAT_STRIDE) ** 2
    d, c, p = 256, 1024, cfg.POOLING_SIZE
    xs = [torch.randn(*shape, device=dev, generator=gen) for shape in
          ((g, fh * fw, d), (g, s_, ns, d), (g, s_, ns, c))]
    xs.append(torch.softmax(torch.randn(g, s_, ns, device=dev,
                                        generator=gen), -1))
    cot = torch.randn(g, fh * fw, c, device=dev, generator=gen)
    feat = torch.randn(g, fh, fw, c, device=dev, generator=gen)
    rois = serving_rois(g, cfg.TRAIN_BATCH_SIZE, gen, dev)
    rcot = torch.randn(g, rois.shape[1], p, p, c, device=dev, generator=gen)
    wy, wx = ra.roi_weights(rois, fh, fw, p)
    # forward + backward: CISA recomputes its forward and takes two
    # products for each of the forward's two (3x the forward's operations);
    # RoIAlign's backward runs the forward's contractions transposed
    cisa_io = sum(t.numel() for t in xs) * 2 + cot.numel() * 2
    roi_io = (feat.numel() * 2 + wy.numel() + wx.numel() + rcot.numel() * 2)
    bounds = {
        'cisa_shots': bound_ms(4 * cisa_io,
                               3 * 2 * g * s_ * fh * fw * ns * (d + c)),
        'roi_align_pw': bound_ms(4 * roi_io, 2 * roi_taps(wy, wx, c)[0])}
    cases = {
        'cisa_shots': (xs, lambda *a: ca.cisa_attention_shots(*a, 1 / 16,
                                                              0.1),
                       lambda *a: ca.cisa_attention_shots_plain(*a, 1 / 16,
                                                                0.1),
                       lambda *a: cisa_library(*a, 1 / 16, 0.1), cot),
        'roi_align_pw': ([feat], lambda f: ra.roi_align_train(f, rois, p),
                         lambda f: ra.roi_align_plain(f, rois, p),
                         lambda f: pw_library(wy, f, wx), rcot)}
    out = {}
    for name, (inputs, fn, plain, library, ct) in cases.items():
        grads, row = {}, {}
        for path, f in (('ms', fn), ('plain_ms', plain),
                        ('library_ms', library)):
            leaves = [t.detach().requires_grad_() for t in inputs]

            def backward():
                return torch.autograd.grad(f(*leaves), leaves, ct)
            grads[path] = backward()
            row[path] = cuda_ms(backward, 3)
        row['max_abs_err'] = max(
            check_close(f'{name} backward', a, b)
            for a, b in zip(grads['ms'], grads['plain_ms']))
        row['bound_ms'], row['bound_by'] = bounds[name]
        out[name] = row
    print(f'backward passes (forward + backward): {out}', flush=True)
    return out


# ---------------------------------------------------------------- phase 4

@contextlib.contextmanager
def plain_ops():
    """Route the detector through the plain versions on the card (for the
    comparison only)."""
    from dana_tpu_torch.models import dana
    from dana_tpu_torch.ops import cisa_attention, roi_align
    saved = dana.cisa_attention_shots, dana.roi_align, dana.roi_align_train
    dana.cisa_attention_shots = cisa_attention.cisa_attention_shots_plain
    dana.roi_align = roi_align.roi_align_plain
    dana.roi_align_train = roi_align.roi_align_plain
    try:
        yield
    finally:
        (dana.cisa_attention_shots, dana.roi_align,
         dana.roi_align_train) = saved


def match_detections(da, db, coord_atol):
    """Same count, same score multiset, equal boxes for every score unique
    within the image (equal scores may keep different boxes)."""
    if da.shape != db.shape:
        fail(f'detection counts differ: {da.shape} vs {db.shape}')
    if not np.allclose(np.sort(da[:, 4]), np.sort(db[:, 4]), rtol=1e-4,
                       atol=1e-4):
        fail('detection scores differ between kernel and plain paths')
    qa, qb = np.round(da[:, 4], 3), np.round(db[:, 4], 3)
    uniq, cnt = np.unique(qa, return_counts=True)
    for s in uniq[cnt == 1]:
        rb = db[qb == s]
        if len(rb) == 1 and not np.allclose(da[qa == s][:, :4], rb[:, :4],
                                            rtol=1e-4, atol=coord_atol):
            fail(f'detection boxes differ at score {s}')


@contextlib.contextmanager
def pinned_proposals(record, pinned=None):
    """Append every proposal-layer call's (inputs, outputs) to `record`;
    with `pinned`, hand the detector those proposals instead of its own."""
    from dana_tpu_torch.models import rpn
    real = rpn.proposal_layer

    def layer(probs_fg, deltas, *args, **kwargs):
        out = real(probs_fg, deltas, *args, **kwargs)
        record.append(((probs_fg, deltas), out))
        return out if pinned is None else pinned
    rpn.proposal_layer = layer
    try:
        yield
    finally:
        rpn.proposal_layer = real


def compare_paths(pred, query, info, classes):
    """Request 0 through the kernels and through the plain versions.  The
    RPN's scores and deltas, the R-CNN head's outputs and the served
    detections must agree.  The plain path is given the kernel path's
    proposals: the proposal layer ranks 21888 anchors whose float32
    scores differ in the last bits between the paths, so near-equal
    neighbours swap places and NMS then keeps a few other boxes (the
    count is printed)."""
    from dana_tpu_torch.models import dana
    runs = {}
    for path in ('kernel', 'plain'):
        record = []
        pinned = runs['kernel'][0][0][1] if path == 'plain' else None
        with plain_ops() if path == 'plain' else contextlib.nullcontext(), \
                pinned_proposals(record, pinned), torch.inference_mode():
            fwd = dana.forward(
                pred.model, pred.config,
                torch.as_tensor(query, device=pred.device),
                torch.as_tensor(info, device=pred.device),
                support_feats=pred.batch_support_feats(classes))
            runs[path] = record, fwd, pred.predict(query, info, classes)
    (rec_k, fk, kdets), (rec_p, fp, pdets) = runs['kernel'], runs['plain']
    (scores_k, deltas_k), (rois_k, _, mask_k) = rec_k[0]
    (scores_p, deltas_p), (rois_p, _, mask_p) = rec_p[0]
    diffs = {'rpn_scores': check_close('main path rpn scores', scores_k,
                                       scores_p),
             'rpn_deltas': check_close('main path rpn deltas', deltas_k,
                                       deltas_p)}
    diffs.update({name: check_close(f'main path {name}', fk[name], fp[name])
                  for name in ('cls_prob', 'bbox_pred')})
    moved = ((mask_k != mask_p)
             | ((rois_k - rois_p).abs() > ROI_ATOL).any(-1)).sum().item()
    print(f'kernel vs plain path on request 0: max |diff| {diffs}; the '
          f'plain path\'s own proposals differ in {moved} of '
          f'{mask_k.numel()} slots', flush=True)
    (dk, vk), (dp, vp) = ([x.cpu().numpy() for x in d]
                          for d in (kdets, pdets))
    for i in range(len(dk)):
        match_detections(dk[i][vk[i]], dp[i][vp[i]], coord_atol=BOX_ATOL)
    print(f'detections (request 0): {vk.sum(1).tolist()} per image, '
          'kernel path == plain path (tie-aware)', flush=True)


def serving_predictor(seed):
    """The served detector: DAnA res50 2-way 3-shot with random weights
    from `seed`, on the card, the supports of classes 0 and 1 encoded."""
    from dana_tpu_torch.engine.predict import Predictor
    from dana_tpu_torch.utils import config as cfg
    config, params = cfg.get_model('res50', way=2, shot=3, seed=seed)
    rng = np.random.default_rng(seed)
    pred = Predictor(params, config)              # device='cuda'
    means = np.asarray(cfg.PIXEL_MEANS, np.float32)
    for cls in range(2):
        sup = rng.integers(0, 256, (config.n_shot, SUPPORT_HW, SUPPORT_HW,
                                    3)).astype(np.float32) - means
        pred.encode_supports(cls, sup)
    return pred


def serving_requests(seed, n):
    """n requests of BATCH uint8 queries -> [(query, im_info, classes)]."""
    rng = np.random.default_rng(seed + 1)
    info = np.tile(np.array([*QUERY_HW, 1.0], np.float32), (BATCH, 1))
    return [(rng.integers(0, 256, (BATCH, *QUERY_HW, 3), dtype=np.uint8),
             info, [(i + j) % 2 for j in range(BATCH)]) for i in range(n)]


def serving_path(seed):
    from dana_tpu_torch.ops import cisa_attention, nms, roi_align

    pred = serving_predictor(seed)
    requests = serving_requests(seed, REQUESTS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    cisa_attention.cisa_attention_shots.launches = 0
    cisa_attention.cisa_attention.launches = 0
    roi_align.roi_align.launches = 0
    nms.HOST_SYNCS = 0
    outs, req_ms = [], []
    for query, info, classes in requests:
        t0 = time.perf_counter()
        dets, valid = pred.predict(query, info, classes)
        torch.cuda.synchronize()
        req_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append((dets, valid))
    launches = {'cisa_shots': cisa_attention.cisa_attention_shots.launches,
                'roi_align_fwd': roi_align.roi_align.launches,
                'cisa_attention': cisa_attention.cisa_attention.launches}
    syncs = nms.HOST_SYNCS
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'main path: {REQUESTS} requests of {BATCH} x {QUERY_HW} uint8, '
          f'ms per request {req_ms}, peak memory {peak:.2f} GiB, '
          f'launches {launches}, NMS host syncs {syncs}', flush=True)
    for name in ('cisa_shots', 'roi_align_fwd'):
        if launches[name] == 0:
            fail(f'kernel {name} was not launched on the main path')
    if launches['cisa_attention']:
        fail('cisa_attention launched on the serving path, which has no '
             'single-group CISA site')

    for dets, valid in outs:
        if dets.shape != (BATCH, 100, 5) or valid.shape != (BATCH, 100):
            fail(f'bad output shapes {dets.shape}, {valid.shape}')
        if not torch.isfinite(dets).all():
            fail('non-finite detections')
    n_det = [int(v.sum()) for _, v in outs]

    compare_paths(pred, *requests[0])
    return launches, dict(req_ms=req_ms, peak_gib=peak, nms_syncs=syncs,
                          detections=n_det)


# ---------------------------------------------------------------- phase 5

def training_episodes(seed, n, dev):
    """n seeded episodes: TRAIN_BATCH uint8 608x1024 queries, 1-5 class-1
    gt boxes each (MAX_GT slots, zero rows pad) and n_way * n_shot = 6
    mean-subtracted 320px supports per query, made on the card."""
    from dana_tpu_torch.utils import config as cfg
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    h, w = QUERY_HW
    b = TRAIN_BATCH
    means = torch.tensor(cfg.PIXEL_MEANS, device=dev)
    out = []
    for _ in range(n):
        wh = torch.rand(b, MAX_GT, 2, device=dev, generator=gen) \
            * torch.tensor([400.0, 300.0], device=dev) + 32
        xy = torch.rand(b, MAX_GT, 2, device=dev, generator=gen) \
            * (torch.tensor([w, h], device=dev) - wh)
        n_gt = torch.randint(1, 6, (b, 1), device=dev, generator=gen)
        filled = torch.arange(MAX_GT, device=dev)[None] < n_gt
        gt = torch.cat([xy, xy + wh - 1, torch.ones(b, MAX_GT, 1,
                                                    device=dev)], -1)
        out.append(dict(
            im_data=torch.randint(0, 256, (b, h, w, 3), device=dev,
                                  generator=gen, dtype=torch.uint8),
            im_info=torch.tensor([[h, w, 1.0]] * b, device=dev),
            gt_boxes=torch.where(filled[..., None], gt, 0.0),
            support_ims=torch.randint(
                0, 256, (b, 6, SUPPORT_HW, SUPPORT_HW, 3), device=dev,
                generator=gen).float() - means))
    return out


@contextlib.contextmanager
def recorded_step(record, pinned=None):
    """Record the training forward's draws and proposals in `record`;
    with `pinned` (a record), replay its proposals instead."""
    from dana_tpu_torch.models import rpn
    real_draws, real_layer = rpn.uniform_draws, rpn.proposal_layer

    def draws(*args, **kwargs):
        record['draws'] = real_draws(*args, **kwargs)
        return record['draws']

    def layer(*args, **kwargs):
        out = real_layer(*args, **kwargs)
        record['proposals'] = out
        return out if pinned is None else pinned['proposals']
    rpn.uniform_draws, rpn.proposal_layer = draws, layer
    try:
        yield
    finally:
        rpn.uniform_draws, rpn.proposal_layer = real_draws, real_layer


# leaves whose gradient is zero by construction (centred q and k, a
# softmax over the unary and the BA block's channel scores): they move
# only by float32 rounding
NO_GRAD = {f'{site}_{layer}_layer.bias' for site in ('rpn', 'rcnn')
           for layer in ('adapt_q', 'adapt_k', 'unary', 'channel_k')}
COMPARED = ('rpn_', 'rcnn_', 'RCNN_rpn.', 'output_score_layer.',
            'RCNN_bbox_pred.')         # attention, RPN and head layers


def training_path(seed):
    """STEPS SGD steps of the Trainer, then step 0 again on the plain
    versions; -> (launches, summary)."""
    from dana_tpu_torch.engine.train import LOSSES, Trainer
    from dana_tpu_torch.ops import cisa_attention, roi_align
    from dana_tpu_torch.utils import config as cfg

    config, params = cfg.get_model('res50', way=2, shot=3, seed=seed)
    trainer = Trainer(params, config, seed=seed)        # device='cuda'
    episodes = training_episodes(seed, STEPS, trainer.device)
    start = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    cisa_attention.cisa_attention_shots.launches = 0
    cisa_attention.cisa_attention.launches = 0
    roi_align.roi_align_pw.launches = 0
    metrics, step_ms, record = [], [], {}
    for i, batch in enumerate(episodes):
        t0 = time.perf_counter()
        with recorded_step(record) if i == 0 else contextlib.nullcontext():
            m = trainer.step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            grads0 = {n: p.grad.clone() for n, p
                      in trainer.model.named_parameters()
                      if p.requires_grad and n.startswith(COMPARED)}
        metrics.append({k: float(v) for k, v in m.items()})
    launches = {'cisa_shots': cisa_attention.cisa_attention_shots.launches,
                'roi_align_pw': roi_align.roi_align_pw.launches,
                'cisa_attention': cisa_attention.cisa_attention.launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'training path: {STEPS} steps of {TRAIN_BATCH} x {QUERY_HW} '
          f'uint8 episodes, ms per step {step_ms}, peak memory {peak:.2f} '
          f'GiB, launches {launches}, metrics {metrics}', flush=True)
    want = {'cisa_shots': 3 * STEPS, 'roi_align_pw': STEPS,
            'cisa_attention': 0}       # no single-group CISA site
    if launches != want:
        fail(f'training path launches {launches}, expected {want}')
    for m in metrics:
        if not all(np.isfinite(m[k]) for k in (*LOSSES, 'loss')):
            fail(f'non-finite training loss: {m}')
        if m['skipped'] != 0.0 or m['fg_cnt'] <= 0:
            fail(f'a step was skipped or sampled no fg roi: {m}')
    end = trainer.model.state_dict()
    trainable = {n for n, p in trainer.model.named_parameters()
                 if p.requires_grad}
    still = {n for n in trainable if torch.equal(end[n], start[n])}
    if not still <= NO_GRAD:
        fail(f'trainable parameters did not move: {sorted(still - NO_GRAD)}')
    moved = [n for n in start
             if n not in trainable and not torch.equal(end[n], start[n])]
    if moved or len(start) == len(trainable):
        fail(f'frozen parameters and buffers moved: {moved}')
    del trainer, start, end
    torch.cuda.empty_cache()

    # step 0 on the plain versions: same weights, draws and proposals
    plain = Trainer(params, config, seed=seed)
    with plain_ops(), recorded_step({}, pinned=record):
        pm = plain.step(episodes[0], draws=record['draws'])
    diffs = {}
    for k in (*LOSSES, 'loss'):
        a, b = metrics[0][k], float(pm[k])
        diffs[k] = abs(a - b) / max(abs(b), 1e-12)
        if diffs[k] > LOSS_RTOL:
            fail(f'step 0 {k}: kernel path {a}, plain path {b}')
    worst = 0.0
    for n, p in plain.model.named_parameters():
        if n not in grads0 or n in NO_GRAD:
            continue
        rel = ((grads0[n] - p.grad).norm()
               / p.grad.norm().clamp(min=1e-30)).item()
        worst = max(worst, rel)
        if not rel <= GRAD_RTOL:
            fail(f'step 0 gradient of {n}: |kernel - plain| is {rel:.3e} '
                 'of its norm')
    print(f'step 0, kernel vs plain path: loss relative diffs {diffs}; '
          f'worst gradient relative diff {worst:.3e} over {len(grads0)} '
          'attention, RPN and head parameters', flush=True)
    return launches, dict(step_ms=step_ms,
                          steady_step_ms=float(np.mean(step_ms[1:])),
                          peak_gib=peak, metrics=metrics,
                          loss_rel_diff=diffs, grad_rel_diff=worst)


# ---------------------------------------------------------------- phase 6

def cli_path(seed):
    """The dataset CLI over synth_test (written with synth_train into a
    temporary DANA_SYNTH_ROOT) on the card; -> (launches, summary)."""
    from dana_tpu_torch import inference
    from dana_tpu_torch.data.imdb import combined_roidb
    from dana_tpu_torch.data.synth import synth_fsod
    from dana_tpu_torch.ops import cisa_attention, nms, roi_align
    saved = os.environ.get('DANA_SYNTH_ROOT')
    with tempfile.TemporaryDirectory() as tmp:
        os.environ['DANA_SYNTH_ROOT'] = os.path.join(tmp, 'synth')
        try:
            t0 = time.perf_counter()
            synth_fsod('test', num_images=20)
            synth_fsod('train')
            synth_s = time.perf_counter() - t0
            _, roidb, _, _ = combined_roidb('synth_test', training=False,
                                            use_flipped=False)
            out_dir = os.path.join(tmp, 'eval')
            argv = ['--dataset', 'synth', '--way', '2', '--shot', '3',
                    '--bs', str(BATCH), '--seed', str(seed),
                    '--eval_dir', out_dir]
            torch.cuda.synchronize()
            cisa_attention.cisa_attention_shots.launches = 0
            cisa_attention.cisa_attention.launches = 0
            roi_align.roi_align.launches = 0
            roi_align.roi_align_pw.launches = 0
            nms.HOST_SYNCS = 0
            t0 = time.perf_counter()
            result = inference.main(argv)
            torch.cuda.synchronize()
            main_s = time.perf_counter() - t0
            launches = {
                'cisa_shots': cisa_attention.cisa_attention_shots.launches,
                'roi_align_fwd': roi_align.roi_align.launches,
                'roi_align_pw': roi_align.roi_align_pw.launches,
                'cisa_attention': cisa_attention.cisa_attention.launches}
            syncs = nms.HOST_SYNCS
            with open(os.path.join(out_dir, 'detections.pkl'), 'rb') as f:
                all_boxes = pickle.load(f)
        finally:
            if saved is None:
                os.environ.pop('DANA_SYNTH_ROOT', None)
            else:
                os.environ['DANA_SYNTH_ROOT'] = saved
    timing = result['timing']
    chunks = timing['chunks']
    want = {'cisa_shots': 2 * chunks, 'roi_align_fwd': chunks,
            'roi_align_pw': 0, 'cisa_attention': 0}
    if launches != want:
        fail(f'CLI path launches {launches}, expected {want} for {chunks} '
             'chunks')
    n_det = []
    for i, entry in enumerate(roidb):
        d = all_boxes[int(entry['gt_classes'][0])][i]
        if not (isinstance(d, np.ndarray) and d.ndim == 2
                and d.shape[1] == 5 and np.isfinite(d).all()):
            fail(f'CLI path: image {i}\'s target-class cell holds {d!r}')
        n_det.append(len(d))
    stats = [float(x) for x in result['stats']]
    if len(stats) != 12 or not np.isfinite(stats).all():
        fail(f'CLI path: COCOeval stats {stats}')
    summary = dict(images=timing['images'], chunks=chunks,
                   img_per_s=timing['img_per_s'], timing=timing,
                   main_s=main_s, synth_s=synth_s, nms_syncs=syncs,
                   detections=n_det, stats=stats)
    print(f'CLI path: synth_test, {timing["images"]} images in {chunks} '
          f'chunks of {BATCH}, {timing["img_per_s"]:.2f} img/s over the set '
          f'(main {main_s:.1f} s), launches {launches}, timing {timing}, '
          f'COCOeval stats {stats}', flush=True)
    return launches, summary


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args()

    # phase 1: device
    if not torch.cuda.is_available():
        fail('no CUDA device: the port runs on the card')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)   # name, limit
    print(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
          f'device {torch.cuda.get_device_name(0)}, '
          f'count {torch.cuda.device_count()}', flush=True)
    from dana_tpu_torch.ops import build
    from dana_tpu_torch.utils.device import tf32_flags, use_full_f32
    use_full_f32()
    print(f'float32 math: {tf32_flags()}', flush=True)
    dev = torch.device('cuda', 0)

    # phase 2: build
    secs = build.build_all()
    print(f'{len(build.KERNELS)} kernel sources built in {secs:.1f} s',
          flush=True)
    for name, log in build.BUILD_LOG.items():
        for line in log.splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'  {name}: {line.strip()}', flush=True)

    # phase 3: kernels against their plain versions
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    with torch.inference_mode():
        k1_err, k1_sites = check_cisa(dev, gen)
        k2_err, k2 = check_roi_align(dev, gen)
        k3_err, k3 = check_roi_align_pw(dev, gen)
        k4_err, k4 = check_cisa_single(dev, gen)
        bucket_errs, buckets = check_buckets(dev, gen)
    k1_err = max(k1_err, bucket_errs['cisa_shots'])
    k2_err = max(k2_err, bucket_errs['roi_align_fwd'])
    backward = check_backward(dev, gen)
    torch.cuda.empty_cache()

    # phase 4: the serving path
    serving_launches, serving = serving_path(args.seed)
    torch.cuda.empty_cache()
    # phase 5: the training path
    training_launches, training = training_path(args.seed)
    torch.cuda.empty_cache()
    # phase 6: the dataset CLI
    cli_launches, cli = cli_path(args.seed)

    by_path = {'serving': serving_launches, 'training': training_launches,
               'cli': cli_launches}
    launches = {name: sum(p.get(name, 0) for p in by_path.values())
                for name in ('cisa_shots', 'roi_align_fwd', 'roi_align_pw',
                             'cisa_attention')}
    print(json.dumps({'serving_summary': serving,
                      'training_summary': training,
                      'cli_summary': cli,
                      'launches_by_path': by_path,
                      'backward': backward,
                      'kernel_sites': {'cisa_shots': k1_sites,
                                       'roi_align_fwd': {'roi': k2},
                                       'roi_align_pw': {'train_roi': k3},
                                       'cisa_attention': {'main': k4},
                                       'buckets': buckets}}),
          flush=True)

    def row(name, source, replaces, err, sites):
        vals = list(sites.values())
        lib = [v['library_ms'] for v in vals]
        return {'name': name, 'route': 'cuda', 'source': source,
                'replaces': replaces, 'launches': launches[name],
                'max_abs_err': err,
                'ms': sum(v['ms'] for v in vals),
                'plain_ms': sum(v['plain_ms'] for v in vals),
                'bound_ms': sum(v['bound_ms'] for v in vals),
                'bound_by': vals[0]['bound_by'],
                'library_ms': None if None in lib else sum(lib)}

    serving_k1 = {k: k1_sites[k] for k in ('rpn', 'roi')}
    kernels = [
        row('cisa_shots', 'dana_tpu_torch/ops/csrc/cisa_shots.cu',
            'dana_tpu/ops/cisa_attention.py:173', k1_err, serving_k1),
        row('roi_align_fwd', 'dana_tpu_torch/ops/csrc/roi_align.cu',
            'dana_tpu/ops/roi_align_pallas.py:221', k2_err, {'roi': k2}),
        row('roi_align_pw', 'dana_tpu_torch/ops/csrc/roi_align.cu',
            'dana_tpu/ops/roi_align_pallas.py:175', k3_err,
            {'train_roi': k3}),
        row('cisa_attention', 'dana_tpu_torch/ops/csrc/cisa_shots.cu',
            'dana_tpu/ops/cisa_attention.py:65', k4_err, {'main': k4}),
    ]
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
