"""What every cell of the benchmark shares: finding a cell's files by name,
the caches inside the checkout, the device checks, the statistics of a
window and the result line.

Layout (every name is the one `BENCHMARK.json` gives):
  configs/<config>.json    a model configuration: the detector's settings
                           (`model`), its postprocess, its optimizer, the
                           canvas and support sizes, `source`, `reduced`
  traffic/<traffic>.json   a traffic mix: `kind` (serve or train) names the
                           general generator and loop in loops/<kind>.py;
                           the rest are its parameters
  limits/<workload>.json   the limit of each number the cell's comparison
                           computes (judge.py), with the readings it was
                           set from
  metrics/<metric>.py      one reader a per-layer metric: read(run) -> a
                           number, or None where the run has nothing to read
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# top-level module names that no run may load: the JAX stack and the JAX
# package (compared whole: the port's name begins with the JAX package's)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'dana_tpu')
CACHE = os.path.join(BENCH, '_cache')


def use_checkout_caches():
    """Point every build and kernel cache at a fixed directory inside the
    checkout, before the program is imported: the kernels' nvcc builds
    (`DANA_BUILD_DIR`, read by dana_tpu_torch/ops/build.py at import),
    Triton's, torch's extensions and inductor's, CUDA's JIT cache.  Only
    the first run of a checkout builds."""
    for var, sub in (('DANA_BUILD_DIR', 'build'), ('TRITON_CACHE_DIR',
                                                   'triton'),
                     ('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                     ('TORCHINDUCTOR_CACHE_DIR', 'inductor'),
                     ('CUDA_CACHE_PATH', 'cuda')):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ['USE_FLAX'] = '0'
    os.environ['USE_JAX'] = '0'


def read_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark():
    return read_json(os.path.join(ROOT, 'BENCHMARK.json'))


def workload(name, bench=None):
    """-> (cell, config, traffic) of the workload `name`."""
    bench = bench or benchmark()
    cells = {c['name']: c for c in bench['workloads']}
    if name not in cells:
        raise SystemExit(f'no workload {name!r} in BENCHMARK.json (have '
                         f'{sorted(cells)})')
    cell = cells[name]
    files = {c['name']: c['file'] for c in bench['configs']}
    config = read_json(os.path.join(ROOT, files[cell['config']]))
    traffic = read_json(os.path.join(BENCH, 'traffic',
                                     cell['traffic'] + '.json'))
    return cell, config, traffic


def limits(name):
    """The limit of each compared number of the workload `name`."""
    data = read_json(os.path.join(BENCH, 'limits', name + '.json'))
    return {k: v['limit'] for k, v in data['numbers'].items()}


def metric_readers(names):
    """{metric: its reader's read function} for the per-layer metrics
    `names`, each loaded from metrics/<metric>.py."""
    out = {}
    for name in names:
        path = os.path.join(BENCH, 'metrics', name + '.py')
        spec = importlib.util.spec_from_file_location(
            'portbench.metrics.' + name.replace('.', '_').replace('-', '_'),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod.read
    return out


def per_layer(cell_name, bench=None):
    """The per-layer metric entries that a traced run of the cell reports:
    those listing it, and those with no list whose `moves` the cell
    reports."""
    bench = bench or benchmark()
    e2e = {m['name'] for m in end_to_end(cell_name, bench)}
    return [m for m in bench['per_layer']
            if cell_name in m.get('workloads', ())
            or ('workloads' not in m and m['moves'] in e2e)]


def end_to_end(cell_name, bench=None):
    bench = bench or benchmark()
    return [m for m in bench['end_to_end']
            if 'workloads' not in m or cell_name in m['workloads']]


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted(m for m in list(sys.modules)
                  if m.split('.')[0] in FORBIDDEN)


# ------------------------------------------------------------- statistics

def percentile(values, q):
    """The nearest-rank q-th percentile of every value (inf for a failed
    request)."""
    vals = sorted(values)
    if not vals:
        return math.inf
    return vals[max(0, math.ceil(q / 100.0 * len(vals)) - 1)]


def median(values):
    return percentile(values, 50)


# ------------------------------------------------------------- the result

def device_info(torch, device, count):
    if device.type != 'cuda':
        return {'platform': 'cpu', 'kind': 'cpu', 'count': 1,
                'memory_peak_bytes': 0}
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(device),
            'count': count,
            'memory_peak_bytes': max(torch.cuda.max_memory_allocated(d)
                                     for d in range(count))}


def result_line(correct, attempted, failed, metrics, device, checks,
                breakdown=None):
    """The run's last line: the contract's keys, `breakdown` in a traced
    run, the compared numbers beside their limits last."""
    out = {'correct': bool(correct), 'attempted': int(attempted),
           'failed': int(failed), 'metrics': metrics, 'device': device}
    if breakdown is not None:
        out['breakdown'] = breakdown
    out['checks'] = checks
    return out


def judged(numbers, lims):
    """{name: {value, limit}} of the numbers the limits name, and whether
    every one is within its limit (a number that is not finite is not).
    The limits file decides which of the comparison's numbers decide
    `correct`."""
    checks = {k: {'value': float(numbers[k]), 'limit': float(v)}
              for k, v in lims.items()}
    ok = all(math.isfinite(c['value']) and c['value'] <= c['limit']
             for c in checks.values())
    return checks, ok
