#!/usr/bin/env python3
"""Where a serving request's time goes in the PyTorch port, on one CUDA card.

    python3 tools/profile_torch_predict.py [--seed 0] [--iters 10]
        [--trace .scratch/profile_torch_predict.trace.json]

Builds the predictor that chip_smoke.py drives (DAnA ResNet-50 2-way
3-shot, random weights from --seed, two classes' 320px supports encoded
once) and sends requests of 8 uint8 608x1024 queries through
`Predictor.predict`: --iters of them untraced for the wall time per
request, then --iters under torch.profiler, whose trace is written to
--trace (it opens in Perfetto).  The stages are the `dana.*`
record_function ranges of `models/dana.py` `forward` and
`engine/predict.py`.  Every kernel and copy on the card is charged to the
ranges that were open on the host when it was launched (the trace's
correlation ids), which also covers the hand-written kernels launched
through ctypes; a stage's host time includes any wait on the card.  Also
printed: the kernels with the most device time and the device's idle
share.  The last line is one JSON object with the per-request numbers.
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--iters', type=int, default=10)
    ap.add_argument('--trace', default=os.path.join(
        REPO, '.scratch', 'profile_torch_predict.trace.json'))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('profile_torch_predict: no CUDA device')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)

    import chip_smoke
    from dana_tpu_torch.ops import build
    build.build_all()
    pred = chip_smoke.serving_predictor(args.seed)
    query, info, classes = chip_smoke.serving_requests(args.seed, 1)[0]

    def request():
        pred.predict(query, info, classes)
        torch.cuda.synchronize()

    for _ in range(2):                                  # warm-up
        request()
    walls = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        request()
        walls.append((time.perf_counter() - t0) * 1e3)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            request()
        traced_wall = (time.perf_counter() - t0) * 1e3 / args.iters
    os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
    prof.export_chrome_trace(args.trace)
    stages, busy, kernels = stage_times(args.trace, args.iters)
    if not busy or not any(d for d, _ in stages.values()):
        sys.exit('profile_torch_predict: the trace holds no device time in '
                 'the dana.* ranges')

    top = sum(d for k, (d, _) in stages.items() if k.count('.') == 1)
    print(f'{"stage (per request)":26s} {"device ms":>10s} {"share":>6s} '
          f'{"host ms":>10s}', flush=True)
    for k, (d, h) in stages.items():
        print(f'{k:26s} {d:10.3f} {100 * d / busy:5.1f}% {h:10.3f}',
              flush=True)
    print(f'top-level stages hold {top:.3f} of {busy:.3f} device ms',
          flush=True)
    heavy = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (ms, calls) in heavy:
        print(f'  {ms:9.3f} ms  x{calls:<6g} {name[:90]}', flush=True)
    print(f'request wall (median of {args.iters}, untraced) '
          f'{statistics.median(walls):.3f} ms; traced {traced_wall:.3f} ms '
          f'with {busy:.3f} ms of device time: idle share '
          f'{1 - busy / traced_wall:.3f}', flush=True)
    print(json.dumps({'card': smi.stdout.strip(),
                      'stage_device_ms': {k: d for k, (d, _) in
                                          stages.items()},
                      'stage_host_ms': {k: h for k, (_, h) in
                                        stages.items()},
                      'wall_ms': statistics.median(walls),
                      'traced_wall_ms': traced_wall, 'device_busy_ms': busy,
                      'idle_share': 1 - busy / traced_wall}))


if __name__ == '__main__':
    main()
