"""The serving traffic: requests offered at a fixed rate to
`Predictor.predict`, and the comparison of sampled requests' stages with
the reference.

Traffic file keys (traffic/<mix>.json, kind "serve"):
  batch         queries a request (uint8 BGR, the configuration's canvas)
  classes       novel classes, each with n_shot supports of support_px
                encoded once at set-up (DAnA; FSOD sends each query's
                class supports with every request)
  rate_per_s    requests offered a second, on a fixed schedule (one every
                1 / rate seconds from the window's start); a request is
                served when it is due or, if the last one ran over, as
                soon as that one is done, and its latency runs from when it
                was due to when its detections are on the host
  pool          distinct requests made from the seed at set-up, offered
                in a seeded order (every seed the same sizes and arrivals)
  warmup        requests served before the window (set-up)
  checked       requests of the window whose stages are compared with the
                reference, drawn from the seed
  trace_start, trace_units    the traced stretch of a --trace 1 run
"""

from __future__ import annotations

import math
import time

import torch

from portbench import harness, judge
from portbench.loops import common
from portbench.recorder import Recorder


def make_inputs(cfg, traffic, seed, device):
    """Host requests from the seed: [(queries uint8 [B, H, W, 3], classes
    [B], supports float [B, S, P, P, 3] or None)], the class supports
    {cls: [S, P, P, 3]} and im_info [B, 3]."""
    m = cfg['model']
    b, (h, w), p = traffic['batch'], cfg['canvas'], cfg['support_px']
    gen = torch.Generator(device=device).manual_seed(int(seed))
    means = torch.tensor(m['pixel_means'], device=device)
    sup = {c: (torch.randint(0, 256, (m['n_shot'], p, p, 3), generator=gen,
                             device=device).float() - means).cpu()
           for c in range(traffic['classes'])}
    cached = m['framework'] in ('DAnA', 'cisa')
    pool = []
    for _ in range(traffic['pool']):
        q = torch.randint(0, 256, (b, h, w, 3), generator=gen, device=device,
                          dtype=torch.uint8).cpu().numpy()
        cls = torch.randint(0, traffic['classes'], (b,), generator=gen,
                            device=device).cpu().tolist()
        ims = None if cached else torch.stack([sup[c] for c in cls]).numpy()
        pool.append((q, cls, ims))
    info = torch.tensor([[h, w, 1.0]] * b).numpy()
    return pool, sup, info, gen


def run(ctx):
    """ctx: harness context (cell, cfg, traffic, seed, seconds, trace,
    device, t0, limits, fault) -> the result line's fields."""
    from dana_tpu_torch.engine.predict import Predictor
    cfg, traffic, dev = ctx.cfg, ctx.traffic, ctx.device
    common.build_kernels(dev)
    ctx.mark('kernels')
    model, config = common.build_program(cfg, ctx.seed, dev)
    pred = Predictor(model, config, device=dev, postprocess=cfg['postprocess'])
    ctx.mark('model')
    pool, sup, info, gen = make_inputs(cfg, traffic, ctx.seed, dev)
    ctx.mark('inputs')
    cached = pred.caches_supports
    if cached:
        for c, s in sup.items():
            pred.encode_supports(c, s.numpy())
        ctx.mark('supports')

    def call(q, cls, ims):
        if cached:
            return pred.predict(q, info, classes=cls)
        return pred.predict(q, info, support_ims=ims)

    rate = float(ctx.rate or traffic['rate_per_s'])
    due_n = math.ceil(rate * ctx.seconds)
    order = torch.randint(0, len(pool), (due_n,), generator=gen,
                          device=dev).cpu().tolist()
    checked = sorted(torch.randperm(due_n, generator=gen, device=dev)
                     [:traffic['checked']].cpu().tolist())
    slot_of = {k: i for i, k in enumerate(checked)}
    host_ms, service, latency = [], [], []
    kept = {}
    failed = 0
    with Recorder(dev) as rec:
        for i in range(traffic['warmup']):
            rec.arm('probe' if i == 0 else None)
            dets, valid = call(*pool[i % len(pool)])
            dets.cpu(), valid.cpu()
            rec.disarm()
        ctx.mark('warm-up')
        rec.allocate(len(checked))
        ctx.mark('buffers')
        with common.Profiled(ctx.trace, traffic['trace_start'],
                             traffic['trace_units'], dev) as prof:
            if dev.type == 'cuda':
                torch.cuda.reset_peak_memory_stats(dev)
            ctx.setup_s = time.perf_counter() - ctx.t0
            start = time.perf_counter()
            for i in range(due_n):
                due = start + i / rate
                now = time.perf_counter()
                if now < due:
                    time.sleep(due - now)
                q, cls, ims = pool[order[i]]
                if i in slot_of:
                    rec.arm(slot_of[i])
                try:
                    with torch.profiler.record_function('bench.request'):
                        t0 = time.perf_counter()
                        dets, valid = call(q, cls, ims)
                        t1 = time.perf_counter()
                        dets, valid = ctx.fault(dets.cpu(), valid.cpu())
                    done = time.perf_counter()
                    host_ms.append((t1 - t0) * 1e3)
                    service.append(done - t0)
                    latency.append(done - due)
                    if i in slot_of:
                        kept[i] = (dets, valid, q, cls, ims)
                except RuntimeError as err:
                    failed += 1
                    latency.append(math.inf)
                    print(f'request {i} failed: {err}', flush=True)
                rec.disarm()
                prof.step()
            end = time.perf_counter()
    common.sync(dev)
    peak = harness.device_info(torch, dev, 1)['memory_peak_bytes']
    window = end - start
    done_n = due_n - failed
    metrics = {
        'serve_img_per_s': {'value': traffic['batch'] * done_n / window,
                            'unit': 'img/s'},
        'serve_p95_ms': {'value': harness.percentile(latency, 95) * 1e3,
                         'unit': 'ms'},
    }
    run_view = common.Run('serve', cfg, traffic, dev, host_ms, service, peak,
                          prof.trace)
    program_support = {c: tuple(t.cpu() for t in pred.batch_support_feats(
        [c])) for c in sup} if cached else None
    del pred, model
    common.free(dev)
    numbers = compare(ctx, rec, kept, checked, sup, info, program_support)
    return dict(attempted=due_n, failed=failed, metrics=metrics,
                run=run_view, numbers=numbers)


def reference_record(ctx, sup, info, q, cls, ims, follow=None, tf32=False):
    """The reference's record of one request (its own proposals in
    own_rois, the later stages on `follow`'s rois when given), in float32
    with TF32 off, or with TF32 on (the control)."""
    ref = common.reference_module(ctx.cfg)
    w = common.weights(ctx.cfg, ctx.seed, ctx.device)
    dev = ctx.device
    qd, infod = torch.as_tensor(q, device=dev), torch.as_tensor(info,
                                                                device=dev)
    with torch.no_grad(), tf32_mode(tf32):
        if ctx.cfg['model']['framework'] == 'fsod':
            return ref.serve(w, ctx.cfg, qd, infod,
                             torch.as_tensor(ims, device=dev), follow=follow)
        return ref.serve(w, ctx.cfg, qd, infod,
                         {c: s.to(dev) for c, s in sup.items()}, cls,
                         follow=follow)


class tf32_mode:
    """TF32 on for the float32 products and convolutions inside, or
    nothing; the flags are restored on exit."""

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        if self.on:
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        else:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def judge_request(ctx, prog, sup, info, q, cls, ims, program_support):
    """The numbers of one request whose program record is `prog`."""
    dev = ctx.device
    follow = {'rois': prog['rois'].to(dev), 'mask': prog['mask'].to(dev)}
    ref = reference_record(ctx, sup, info, q, cls, ims, follow)
    if program_support is not None:
        pairs = []
        for c, (pf, pp) in program_support.items():
            rf, rp = ref['support'][c]
            pairs += [(pf, rf), (pp, rp)]
    else:
        pairs = [(prog['support'], ref['support'])]
    return judge.serve_numbers(prog, ref, pairs)


def compare(ctx, rec, kept, checked, sup, info, program_support):
    """Worst number over the checked requests (a checked request that never
    completed fails every number)."""
    worst = {k: 0.0 for k in judge.SERVE_NUMBERS}
    for slot, i in enumerate(checked):
        if i not in kept:
            return {k: math.inf for k in judge.SERVE_NUMBERS}
        dets, valid, q, cls, ims = kept[i]
        prog = dict(rec.buffers[slot], dets=dets, valid=valid)
        nums = judge_request(ctx, prog, sup, info, q, cls, ims,
                             program_support)
        worst = {k: max(worst[k], v) for k, v in nums.items()}
    return worst
