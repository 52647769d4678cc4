#!/usr/bin/env python3
"""Drive the PyTorch port (dana_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed 0]

Run from the repository root.  Phases, each of which fails the run:
  1. device: a CUDA card must be present; prints its name and power
     limit, the torch / CUDA versions and the float32 (TF32) flags;
  2. build: every kernel of the serving path is compiled by nvcc from
     dana_tpu_torch/ops/csrc, all at once;
  3. kernels: each kernel's wrapper is held against its plain PyTorch
     version on the card (|kernel - plain| <= 1e-4 + 1e-4 |plain|: both
     sum float32 products in different orders) at the shapes the serving
     path gives it plus edge shapes, and timed with CUDA events beside
     its plain version, a library yardstick and its bound;
  4. main path: the DAnA ResNet-50 2-way 3-shot detector with random
     weights from --seed serves REQUESTS requests of BATCH uint8
     608x1024 queries against two classes whose 320px supports were
     encoded once.  The launch counters are zeroed just before and read
     just after; every kernel must have launched.  The outputs must be
     finite and of the right shapes, and the first request, served again
     with the plain versions in place of the kernels (and the kernel
     path's proposals), must agree: the RPN's scores and deltas, the
     R-CNN head's outputs and the detections (tie-aware matching).
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, published
FP32_FLOP_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
TOL = 1e-4
ROI_ATOL = 2e-3               # px: a proposal counted as moved (ROADMAP Queue C)
BOX_ATOL = 1e-3               # px, detections of a unique score
QUERY_HW = (608, 1024)        # first query canvas bucket
SUPPORT_HW = 320
BATCH = 8                     # queries per request
REQUESTS = 3


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


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                 else 'operations')


def check_close(name, got, want):
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not torch.isfinite(got).all():
        fail(f'{name}: kernel output is not finite')
    if not torch.allclose(got, want, rtol=TOL, atol=TOL):
        fail(f'{name}: kernel disagrees with its plain version '
             f'(max |err| {err:.3e})')
    return err


# ---------------------------------------------------------------- phase 3

def check_cisa(dev, gen):
    from dana_tpu_torch.ops.cisa_attention import (
        cisa_attention_shots, cisa_attention_shots_plain)
    import torch.nn.functional as F
    from dana_tpu_torch.utils import config as cfg

    def library(q, k, v, u, scale, gamma):
        # SDPA over the shots as heads, plus the query-independent unary
        # term, then the shot mean (a yardstick; the port never calls it)
        o = F.scaled_dot_product_attention(
            q[:, None].expand(-1, k.shape[1], -1, -1), k, v, scale=scale)
        return (o + gamma * (u[:, :, None, :] @ v)).mean(1)

    fh, fw = (s // cfg.FEAT_STRIDE for s in QUERY_HW)
    ns_rpn = (SUPPORT_HW // cfg.FEAT_STRIDE) ** 2
    bins = cfg.POOLING_SIZE ** 2
    # (G, S, Nq, Ns, D, C): the two serving-path sites of a request, then
    # edge shapes
    cases = {'rpn': (BATCH, 3, fh * fw, ns_rpn, 256, 1024),
             'roi': (BATCH, 3, cfg.TEST_RPN_POST_NMS_TOP_N * bins, bins, 256,
                     1024),
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
        if name in ('rpn', 'roi'):
            nbytes = 4 * (q.numel() + k.numel() + v.numel() + u.numel()
                          + g * nq * c)
            flops = 2 * g * s * nq * ns * (d + c)
            b_ms, b_by = bound_ms(nbytes, flops)
            sites[name] = dict(
                ms=cuda_ms(lambda: cisa_attention_shots(*args), 10),
                plain_ms=cuda_ms(lambda: cisa_attention_shots_plain(*args),
                                 5),
                library_ms=cuda_ms(lambda: library(*args), 5),
                bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes)
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


def serving_rois(b, r, gen, dev):
    """Proposal-like rois on a 608x1024 image, edge cases first."""
    h, w = QUERY_HW
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
    from dana_tpu_torch.ops.roi_align import roi_align, roi_align_plain
    from dana_tpu_torch.utils import config as cfg
    b, r, c = BATCH, cfg.TEST_RPN_POST_NMS_TOP_N, 1024
    p = cfg.POOLING_SIZE
    fh, fw = (s // cfg.FEAT_STRIDE for s in QUERY_HW)
    feat = torch.randn(b, fh, fw, c, device=dev, generator=gen)
    rois = serving_rois(b, r, gen, dev)
    want = roi_align_plain(feat, rois, p, 1 / 16.0)
    err = check_close('roi_align_fwd', roi_align(feat, rois, p, 1 / 16.0),
                      want)
    counts = _sample_counts(rois, p)
    nbytes = 4 * (feat.numel() + rois.numel() + want.numel())
    # 4 corner multiply-adds per sample, per bin, per channel
    flops = 8 * c * p * p * (counts[..., 0] * counts[..., 1]).sum().item()
    b_ms, b_by = bound_ms(nbytes, flops)
    site = dict(ms=cuda_ms(lambda: roi_align(feat, rois, p, 1 / 16.0), 10),
                plain_ms=cuda_ms(lambda: roi_align_plain(feat, rois, p,
                                                         1 / 16.0), 3),
                library_ms=None, bound_ms=b_ms, bound_by=b_by, flops=flops,
                bytes=nbytes)
    print(f'roi_align_fwd feat={tuple(feat.shape)} rois={tuple(rois.shape)}:'
          f' max|kernel-plain| {err:.3e}, {site}', flush=True)
    return err, site


# ---------------------------------------------------------------- phase 4

@contextlib.contextmanager
def plain_ops():
    """Route the detector through the plain versions on the card (for the
    comparison only)."""
    from dana_tpu_torch.models import dana
    from dana_tpu_torch.ops import cisa_attention, roi_align
    saved = dana.cisa_attention_shots, dana.roi_align
    dana.cisa_attention_shots = cisa_attention.cisa_attention_shots_plain
    dana.roi_align = roi_align.roi_align_plain
    try:
        yield
    finally:
        dana.cisa_attention_shots, dana.roi_align = saved


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


def main_path(seed):
    from dana_tpu_torch.ops import cisa_attention, nms, roi_align

    pred = serving_predictor(seed)
    requests = serving_requests(seed, REQUESTS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    cisa_attention.cisa_attention_shots.launches = 0
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
                'roi_align_fwd': roi_align.roi_align.launches}
    syncs = nms.HOST_SYNCS
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'main path: {REQUESTS} requests of {BATCH} x {QUERY_HW} uint8, '
          f'ms per request {req_ms}, peak memory {peak:.2f} GiB, '
          f'launches {launches}, NMS host syncs {syncs}', flush=True)
    for name, n in launches.items():
        if n == 0:
            fail(f'kernel {name} was not launched on the main path')

    for dets, valid in outs:
        if dets.shape != (BATCH, 100, 5) or valid.shape != (BATCH, 100):
            fail(f'bad output shapes {dets.shape}, {valid.shape}')
        if not torch.isfinite(dets).all():
            fail('non-finite detections')
    n_det = [int(v.sum()) for _, v in outs]

    compare_paths(pred, *requests[0])
    return launches, dict(req_ms=req_ms, peak_gib=peak, nms_syncs=syncs,
                          detections=n_det)


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
    print(f'kernels built in {secs:.1f} s', flush=True)
    for name, log in build.BUILD_LOG.items():
        for line in log.splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'  {name}: {line.strip()}', flush=True)

    # phase 3: kernels against their plain versions
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    with torch.inference_mode():
        k1_err, k1_sites = check_cisa(dev, gen)
        k2_err, k2 = check_roi_align(dev, gen)
    torch.cuda.empty_cache()

    # phase 4: the serving path
    launches, summary = main_path(args.seed)

    per_req = {'cisa_shots': k1_sites, 'roi_align_fwd': {'roi': k2}}
    print(json.dumps({'serving_summary': summary, 'kernel_sites': per_req}),
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

    kernels = [
        row('cisa_shots', 'dana_tpu_torch/ops/csrc/cisa_shots.cu',
            'dana_tpu/ops/cisa_attention.py:173', k1_err, k1_sites),
        row('roi_align_fwd', 'dana_tpu_torch/ops/csrc/roi_align_fwd.cu',
            'dana_tpu/ops/roi_align_pallas.py:221', k2_err, {'roi': k2}),
    ]
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
