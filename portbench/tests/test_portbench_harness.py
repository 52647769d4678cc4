"""CPU tests of the benchmark: the harness's arithmetic, its discovery of
a cell's files by name, the work counts, the trace reading, and that the
program's JAX-free run matches the reference at a small size.

    python -m pytest portbench/tests -q

(the card's test, test_portbench_control.py, skips here)."""

import ast
import json
import math
import os
import pathlib
import re
import subprocess
import sys

import pytest

from portbench import harness, judge, tracing
from portbench.work import cisa, conv, detector, nms, peaks, roi_align

BENCH = pathlib.Path(harness.BENCH)
CELLS = [c['name'] for c in harness.benchmark()['workloads']]
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')


# ------------------------------------------------------------ statistics

def test_percentile_is_nearest_rank_over_every_request():
    vals = list(range(1, 101))
    assert harness.percentile(vals, 95) == 95
    assert harness.percentile(vals, 50) == 50
    assert harness.percentile([3.0], 95) == 3.0
    # a failed request counts as missing: its latency is infinite
    assert harness.percentile([1.0] * 19 + [math.inf], 95) == 1.0
    assert harness.percentile([1.0] * 18 + [math.inf] * 2, 95) == math.inf
    assert harness.percentile([], 95) == math.inf


def test_judged_compares_the_numbers_the_limits_name():
    checks, ok = harness.judged({'a': 1e-6, 'b': 0.3, 'c': 9.0},
                                {'a': 1e-5, 'b': 0.25})
    assert list(checks) == ['a', 'b'] and not ok
    _, ok = harness.judged({'a': 1e-6}, {'a': 1e-5})
    assert ok
    _, ok = harness.judged({'a': math.nan}, {'a': 1e-5})
    assert not ok


# ----------------------------------------------------------------- trace

def _trace(tmp_path, events):
    path = tmp_path / 't.json'
    path.write_text(json.dumps({'traceEvents': events}))
    return tracing.Trace(str(path))


def _ev(cat, name, ts, dur, corr=None):
    e = {'cat': cat, 'name': name, 'ts': ts, 'dur': dur, 'args': {}}
    if corr is not None:
        e['args']['correlation'] = corr
    return e


def test_busy_time_is_the_union_of_device_intervals(tmp_path):
    # one request [0, 100] us; two kernels overlap on two streams
    # ([10, 40] and [30, 60]) and a copy [70, 80]: busy 60 us, not 70
    t = _trace(tmp_path, [
        _ev('user_annotation', 'bench.request', 0, 100),
        _ev('user_annotation', 'dana.trunk', 0, 50),
        _ev('kernel', 'k1', 10, 30, corr=1),
        _ev('kernel', 'k2', 30, 30, corr=2),
        _ev('gpu_memcpy', 'Memcpy DtoH', 70, 10, corr=3),
        # launches come after their kernels in the file
        _ev('cuda_runtime', 'cudaLaunchKernel', 5, 1, corr=1),
        _ev('cuda_runtime', 'cudaLaunchKernel', 20, 1, corr=2),
        _ev('cuda_runtime', 'cudaMemcpyAsync', 65, 1, corr=3),
        # device work outside any request is not counted
        _ev('kernel', 'k3', 200, 50, corr=4),
    ])
    assert t.units == 1
    assert t.busy_s() == pytest.approx(60e-6)
    assert t.window_s() == pytest.approx(100e-6)
    assert t.idle_gaps() == [(0, 10), (60, 70), (80, 100)]
    # k1 and k2 were launched inside dana.trunk, the copy after it
    assert t.charged_s(lambda n: n == 'dana.trunk') == pytest.approx(60e-6)
    assert t.kernel_s(r'\bk[12]\b') == pytest.approx(60e-6)
    assert t.longest_gaps(1)[0][1] == pytest.approx(20e-6)
    assert t.top_device_ops(1) == [['k1', pytest.approx(30e-6)]]


# ------------------------------------------------------------------ work

def test_work_counts_against_hand_counts():
    # a 3x3 conv, 2 images, 4 -> 8 channels, 5x6 output: 2*2*8*30*4*9
    assert conv.conv_flops(2, 4, 8, 3, 5, 6) == 34560
    assert conv.linear_flops(3, 4, 5) == 120
    # ResNet-50 C4: stride 16 with the ceil-mode pool
    assert conv.map_size(608, 1024) == (38, 64)
    assert conv.map_size(320, 320) == (20, 20)
    names = [c[0] for c in conv.resnet50_convs(64, 64)]
    assert names[0] == 'conv1' and len(names) == 1 + 3 * 13 + 3
    # layer4 on a 7x7 roi: stride 2 to 4x4
    assert conv.resnet50_convs(7, 7, stages=(4,))[0][4:] == (4, 4)
    # the backward skips the frozen stem and layer1 and takes only the
    # weight gradient of layer2's first block's input convs
    convs = {n: conv.conv_flops(1, ci, co, k, ho, wo)
             for n, ci, co, k, ho, wo in conv.resnet50_convs(64, 64)}
    full = sum(f for n, f in convs.items()
               if n.startswith(('layer2.', 'layer3.')))
    first = convs['layer2.0.conv1'] + convs['layer2.0.downsample.0']
    assert conv.trunk_backward_flops(1, 64, 64) == 2 * full - first
    # CISA: two products a shot; bytes of q, k, v, u and the output once
    assert cisa.flops(1, 2, 3, 4, 5, 6) == 2 * 3 * 2 * 4 * 11
    assert cisa.nbytes(1, 2, 3, 4, 5, 6) == 4 * (10 + 3 * 4 * 12 + 12)
    assert roi_align.serve_bytes(1, 2, 3, 4, 5, p=2) == 4 * (24 + 25 + 80)
    assert roi_align.train_bytes(1, 2, 3, 4, 5, p=2) == 4 * (24 + 50 + 80)
    assert nms.nbytes(2, 10, 3) == 2 * 10 * 17 + 2 * 3 * 9
    assert peaks.least_s(495e12, 0) == pytest.approx(1.0)
    assert peaks.least_s(0, 3.35e12) == pytest.approx(1.0)


def test_every_cell_counts_its_work():
    for name in CELLS:
        _, cfg, traffic = harness.workload(name)
        assert detector.model_flops(cfg, traffic) > 1e12
        sites = detector.kernel_sites(cfg, traffic)
        kinds = [k for k, _ in sites]
        assert all(s > 0 for _, s in sites)
        k1 = kinds.count('cisa_shots_kernel')
        if cfg['model']['framework'] == 'fsod':
            assert k1 == 0
        else:
            assert k1 == (3 if traffic['kind'] == 'train' else 2)


# ------------------------------------------------- discovery and contract

def test_the_harness_finds_each_cell_and_metric_by_name():
    bench = harness.benchmark()
    for cell in bench['workloads']:
        _, cfg, traffic = harness.workload(cell['name'])
        assert traffic['kind'] in ('serve', 'train')
        assert (BENCH / 'loops' / f'{traffic["kind"]}.py').exists()
        lims = harness.limits(cell['name'])
        numbers = (judge.SERVE_NUMBERS if traffic['kind'] == 'serve'
                   else judge.TRAIN_NUMBERS)
        assert lims and set(lims) <= set(numbers)
        metrics = harness.per_layer(cell['name'], bench)
        assert metrics
        readers = harness.metric_readers([m['name'] for m in metrics])
        assert all(callable(r) for r in readers.values())
        e2e = [m['name'] for m in harness.end_to_end(cell['name'], bench)]
        assert 'setup_s' in e2e and len(e2e) >= 2
        assert all(m['moves'] in e2e for m in metrics)


def test_benchmark_json_keeps_the_contract():
    bench = harness.benchmark()
    assert set(bench) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert bench['paths'] == ['portbench']
    assert 1 <= bench['run_seconds'] <= 51
    names = [c['name'] for c in bench['configs']]
    for c in bench['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert c['file'].startswith('portbench/')
        assert json.load(open(os.path.join(harness.ROOT, c['file'])))
    cells = bench['workloads']
    assert {c['config'] for c in cells} == set(names)
    assert len({(c['config'], c['traffic']) for c in cells}) == len(cells)
    for c in cells:
        assert set(c) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert c['chips'] in (1, 4) and len(c['why']) <= 200
    metrics = bench['end_to_end'] + bench['per_layer']
    for m in metrics:
        assert NAME.match(m['name']) and m['better'] in ('lower', 'higher')
        assert re.match(r'^[A-Za-z0-9_/%.-]{1,16}$', m['unit'])
    for m in bench['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    assert len({m['name'] for m in metrics}) == len(metrics)
    assert any(m['name'] == 'setup_s' for m in bench['end_to_end'])
    for m in bench['per_layer']:
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}
        if m['unit'] == '%' and ('roofline' in m['name']
                                 or 'mfu' in m['name']):
            assert m['better'] == 'higher'
    assert len(json.dumps(bench)) < 64 * 1024


# -------------------------------------------------------------- no JAX

def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_program_or_jax():
    files = list((BENCH / 'reference').glob('*.py'))
    assert len(files) >= 3
    for path in files:
        tops = {m.split('.')[0] for m in _imports(path)}
        assert not tops & {'dana_tpu_torch', 'dana_tpu', 'jax', 'jaxlib',
                           'flax'}, path


def test_a_dry_run_of_every_cell_loads_no_jax_module():
    code = (
        'import sys, torch\n'
        'torch.set_num_threads(2)\n'
        'from portbench import harness\n'
        'from portbench.run import run_cell\n'
        'from portbench.tests.tiny import tiny\n'
        'for name in sys.argv[1:]:\n'
        '    out = run_cell(tiny(name), lims=harness.limits(name))\n'
        '    assert out["correct"], out\n'
        'print(harness.forbidden_modules())\n')
    env = dict(os.environ, PYTHONPATH=harness.ROOT)
    env.pop('JAX_PLATFORMS', None)
    out = subprocess.run([sys.executable, '-c', code, *CELLS],
                         cwd=harness.ROOT, env=env, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == '[]'


def test_forbidden_names_are_compared_whole():
    sys.modules.setdefault('dana_tpu_torch_lookalike', sys)
    try:
        bad = harness.forbidden_modules()
        assert 'dana_tpu_torch_lookalike' not in bad
        assert not [m for m in bad if m.split('.')[0] == 'dana_tpu_torch']
    finally:
        del sys.modules['dana_tpu_torch_lookalike']
