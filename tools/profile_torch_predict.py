#!/usr/bin/env python3
"""Where a serving request's time goes in the PyTorch port, on one CUDA card.

    python3 tools/profile_torch_predict.py [--seed 0] [--iters 10]
        [--net DAnA|cisa|frcnn|fsod|meta|fgn] [--backbone res50|res101|vgg16]
        [--set POOLING_MODE pool|crop ...]
        [--trace .scratch/profile_torch_predict.trace.json] [--export]

Builds the predictor that chip_smoke.py drives (DAnA ResNet-50 2-way
3-shot, random weights from --seed, two classes' 320px supports encoded
once; with --net, the detector that chip_smoke.py phase 8 serves: the
siblings with a request's 8 x 3 supports, frcnn through its eval
forward; with --backbone, on that trunk; --set overrides the built-in
config tree, e.g. its POOLING_MODE, or TPU.QUANT_INT8 True for int8
serving through the dataset CLI's quantization hook) and sends requests
of 8 uint8 608x1024 queries through `Predictor.predict`: --iters of them untraced for the wall time per
request, then --iters under torch.profiler, whose trace is written to
--trace (it opens in Perfetto).  The stages are the `dana.*`
record_function ranges of `models/dana.py` `forward` and
`engine/predict.py`.  Every kernel and copy on the card is charged to the
ranges that were open on the host when it was launched (the trace's
correlation ids), which also covers the hand-written kernels launched
through ctypes; a stage's host time includes any wait on the card.  Also
printed: the kernels with the most device time, the device's idle share
and the bytes of each kind of device copy.  The last line is one JSON
object with the per-request numbers.

With --export (DAnA and cisa), the same request is also served from an
artifact of dana_tpu_torch/serve.py, exported in this process at the
query's bucket with the weights as its argument, and profiled after the
live predictor (trace: --trace with `.artifact` before its extension).
Both sides take the query float32 and mean subtracted, as chip_smoke.py
phase 15 serves it, and the artifact the request's support rows
assembled beforehand (an exported program keeps no `dana.*` range of its
own: its request is the one range `dana.request`).  Also printed: the
kernels whose device time per request differs most between the two.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')


def copy_bytes(trace_path, iters):
    """-> {copy kind (e.g. 'Memcpy HtoD (Pageable -> Device)'): bytes per
    request} of the trace's device copies."""
    with open(trace_path) as f:
        events = json.load(f)['traceEvents']
    out = collections.Counter()
    for e in events:
        if e.get('cat') == 'gpu_memcpy':
            out[e['name']] += e.get('args', {}).get('bytes', 0) / iters
    return dict(out)


def stage_times(trace_path, iters):
    """-> ({stage: (device ms, host ms)} per request, device busy ms per
    request, {kernel name: (device ms per request, calls per request)})."""
    with open(trace_path) as f:
        events = json.load(f)['traceEvents']
    ranges, launch_ts, device = [], {}, []
    for e in events:
        cat, args = e.get('cat', ''), e.get('args', {})
        if cat == 'user_annotation' and e['name'].startswith('dana.'):
            ranges.append((e['name'], e['ts'], e['ts'] + e['dur']))
        elif cat in ('cuda_runtime', 'cuda_driver') and 'correlation' in args:
            launch_ts[args['correlation']] = e['ts']
        elif cat in DEVICE_CATS:
            device.append((e['name'], args.get('correlation'), e['dur']))
    dev_us = collections.Counter()
    host_us = collections.Counter()
    for name, t0, t1 in ranges:
        host_us[name] += t1 - t0
    kernels = collections.defaultdict(lambda: [0.0, 0])
    for name, corr, dur in device:
        kernels[name][0] += dur
        kernels[name][1] += 1
        ts = launch_ts.get(corr)
        if ts is None:
            continue
        for stage, t0, t1 in ranges:
            if t0 <= ts <= t1:
                dev_us[stage] += dur
    busy = sum(dur for _, _, dur in device) / 1e3 / iters
    stages = {k: (dev_us[k] / 1e3 / iters, host_us[k] / 1e3 / iters)
              for k in sorted(host_us)}
    kernels = {k: (v[0] / 1e3 / iters, v[1] / iters)
               for k, v in kernels.items()}
    return stages, busy, kernels


def card_name():
    """The `nvidia-smi` name and power limit line; exits without a card."""
    if not torch.cuda.is_available():
        sys.exit(f'{os.path.basename(sys.argv[0])}: no CUDA device')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return smi.stdout.strip()


def profile(run, iters, trace, card, unit='request'):
    """Time `run` (ending in a synchronize) --iters times untraced, then
    --iters times under torch.profiler; print the stage table, the top
    kernels and the idle share; -> the JSON summary (per `unit`)."""
    for _ in range(2):                                  # warm-up
        run()
    walls = []
    for _ in range(iters):
        t0 = time.perf_counter()
        run()
        walls.append((time.perf_counter() - t0) * 1e3)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        traced_wall = (time.perf_counter() - t0) * 1e3 / iters
    os.makedirs(os.path.dirname(os.path.abspath(trace)), exist_ok=True)
    prof.export_chrome_trace(trace)
    stages, busy, kernels = stage_times(trace, iters)
    if not busy or not any(d for d, _ in stages.values()):
        sys.exit('the trace holds no device time in the dana.* ranges')

    top = sum(d for k, (d, _) in stages.items() if k.count('.') == 1)
    print(f'{"stage (per " + unit + ")":26s} {"device ms":>10s} '
          f'{"share":>6s} {"host ms":>10s}', flush=True)
    for k, (d, h) in stages.items():
        print(f'{k:26s} {d:10.3f} {100 * d / busy:5.1f}% {h:10.3f}',
              flush=True)
    print(f'top-level stages hold {top:.3f} of {busy:.3f} device ms',
          flush=True)
    heavy = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (ms, calls) in heavy:
        print(f'  {ms:9.3f} ms  x{calls:<6g} {name[:90]}', flush=True)
    print(f'{unit} wall (median of {iters}, untraced) '
          f'{statistics.median(walls):.3f} ms; traced {traced_wall:.3f} ms '
          f'with {busy:.3f} ms of device time: idle share '
          f'{1 - busy / traced_wall:.3f}', flush=True)
    return {'card': card,
            'stage_device_ms': {k: d for k, (d, _) in stages.items()},
            'stage_host_ms': {k: h for k, (_, h) in stages.items()},
            'wall_ms': statistics.median(walls),
            'traced_wall_ms': traced_wall, 'device_busy_ms': busy,
            'idle_share': 1 - busy / traced_wall,
            'copy_bytes': copy_bytes(trace, iters), 'kernels': kernels}


def artifact_call(live, model, query, info, classes, out_dir, sup_size):
    """-> a function serving the request of `live.predict(query, info,
    classes)` from an artifact of `model`, a (config, params) pair,
    exported into `out_dir` at the query's bucket."""
    from dana_tpu_torch import serve
    from dana_tpu_torch.utils.weights import from_jax_params
    config, params = model
    net = from_jax_params(params, config).cuda()
    t0 = time.perf_counter()
    serve.export_predictor(net, config, out_dir, buckets=(query.shape[1:3],),
                           batch_size=len(query), sup_size=sup_size)
    print(f'exported in {time.perf_counter() - t0:.1f} s', flush=True)
    art = serve.load(out_dir)
    weights = art.weights(net.state_dict())
    # each query's row holds every class's supports, its own class first,
    # as chip_smoke.py phase 15 assembles them
    feats = {c: live.batch_support_feats([c])
             for c in range(config.n_way)}
    rows = [[torch.cat([feats[c][j], *(feats[o][j] for o in feats
                                       if o != c)], 1) for j in range(2)]
            for c in classes]
    feat, pooled = (torch.cat([r[j] for r in rows]) for j in range(2))

    def request():
        with torch.profiler.record_function('dana.request'):
            return art(weights, query, info, feat, pooled)
    return request


def kernel_diff(live, art, n=15):
    """Print the `n` kernels whose device ms per request differ most
    between the live predictor and the artifact."""
    print(f'{"live ms":>9s} {"calls":>6s} {"artifact ms":>11s} {"calls":>6s}'
          '  kernel', flush=True)
    none = (0.0, 0)
    for k in sorted(set(live) | set(art), key=lambda k: -abs(
            art.get(k, none)[0] - live.get(k, none)[0]))[:n]:
        (a, ca), (b, cb) = live.get(k, none), art.get(k, none)
        print(f'{a:9.3f} {ca:6g} {b:11.3f} {cb:6g}  {k[:80]}', flush=True)


def model_for(net, backbone, overrides, seed, serving=True):
    """-> (config, params): the 2-way 3-shot detector `net` on `backbone`
    from the built-in config tree with the KEY VALUE `overrides`, random
    weights from `seed` (get_model's, without overrides); for `serving`
    quantized by the dataset CLI's hook under TPU.QUANT_INT8 (training
    takes the float tree, as the training CLI does)."""
    from dana_tpu_torch import inference
    from dana_tpu_torch.models import frameworks
    from dana_tpu_torch.utils import config as cfg
    tree = cfg.default_cfg()
    cfg.cfg_from_list(tree, overrides or [])
    config = cfg.dana_config(tree, 2, 3, net, backbone)
    params = frameworks.init_params(config, seed=seed)
    if serving and tree.TPU.QUANT_INT8:
        params = inference.quantize(params, tree.TPU.QUANT_SCOPE)
    return config, params


def serving_call(chip_smoke, model, seed, query, info, classes):
    """-> a function serving one request with `model`, a (config, params)
    pair, as chip_smoke.py does (frcnn, which has no serving path: its eval
    forward)."""
    from dana_tpu_torch.engine.predict import Predictor
    from dana_tpu_torch.models import dana, frameworks
    config, params = model
    if config.framework in dana.CACHED_SUPPORTS:
        pred = chip_smoke.serving_predictor(seed, model)
        return lambda: pred.predict(query, info, classes)
    sup = chip_smoke.support_stacks(seed, 1)[0]
    if config.framework == 'frcnn':
        from dana_tpu_torch.utils.device import use_full_f32
        from dana_tpu_torch.utils.weights import from_jax_params
        use_full_f32()                  # as Predictor does on the card
        model = from_jax_params(params, config).cuda()
        q, i = (torch.as_tensor(x, device='cuda') for x in (query, info))

        @torch.inference_mode()
        def forward():
            return frameworks.forward(model, config, q, i)
        return forward
    pred = Predictor(params, config)
    return lambda: pred.predict(query, info, support_ims=sup)


def add_model_args(ap):
    ap.add_argument('--net', default='DAnA',
                    choices=('DAnA', 'cisa', 'frcnn', 'fsod', 'meta', 'fgn'))
    ap.add_argument('--backbone', default='res50',
                    choices=('res50', 'res101', 'vgg16'))
    ap.add_argument('--set', nargs='*', default=[],
                    help='config tree overrides: KEY VALUE ...')


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--iters', type=int, default=10)
    add_model_args(ap)
    ap.add_argument('--trace', default=os.path.join(
        REPO, '.scratch', 'profile_torch_predict.trace.json'))
    ap.add_argument('--export', action='store_true',
                    help='also profile the request served from an exported '
                         'artifact (DAnA and cisa)')
    args = ap.parse_args()
    card = card_name()

    import chip_smoke
    from dana_tpu_torch.ops import build
    build.build_all()
    query, info, classes = chip_smoke.serving_requests(args.seed, 1)[0]
    model = model_for(args.net, args.backbone, args.set, args.seed)
    if args.export:
        import tempfile
        import numpy as np
        from dana_tpu_torch.models import dana
        from dana_tpu_torch.utils import config as cfg
        if model[0].framework not in dana.CACHED_SUPPORTS:
            sys.exit(f'--export: {args.net} takes each request\'s supports')
        query = torch.from_numpy(query.astype(np.float32) - np.asarray(
            cfg.PIXEL_MEANS, np.float32))
        live = chip_smoke.serving_predictor(args.seed, model)
        serve = lambda: live.predict(query, info, classes)  # noqa: E731
    else:
        serve = serving_call(chip_smoke, model, args.seed, query, info,
                             classes)

    def synced(fn):
        def request():
            fn()
            torch.cuda.synchronize()
        return request

    out = profile(synced(serve), args.iters, args.trace, card)
    kernels = out.pop('kernels')
    if args.export:
        with tempfile.TemporaryDirectory() as tmp:
            art = artifact_call(live, model, query, info, classes, tmp,
                                chip_smoke.SUPPORT_HW)
            root, ext = os.path.splitext(args.trace)
            out = {'live': out, 'artifact': profile(
                synced(art), args.iters, f'{root}.artifact{ext}', card)}
        kernel_diff(kernels, out['artifact'].pop('kernels'))
    out.update(framework=model[0].framework, arch=model[0].arch,
               pooling_mode=model[0].pooling_mode)
    print(json.dumps(out))


if __name__ == '__main__':
    main()
