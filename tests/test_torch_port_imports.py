"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on the card unless the caller asks for the CPU."""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / 'dana_tpu_torch'


def test_import_pulls_in_no_jax():
    code = (
        'import importlib, pkgutil, sys\n'
        'import dana_tpu_torch\n'
        'for m in pkgutil.walk_packages(dana_tpu_torch.__path__,\n'
        '                               "dana_tpu_torch."):\n'
        '    importlib.import_module(m.name)\n'
        'bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")\n'
        '       or m == "dana_tpu" or m.startswith("dana_tpu.")]\n'
        'print(len([m for m in sys.modules if m.startswith("dana_tpu_torch")]))\n'
        'assert not bad, bad\n')
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15     # every module was imported


def test_no_source_names_jax():
    pat = re.compile(r'\bjax\b|\bdana_tpu\.')
    files = [p for p in PKG.rglob('*') if p.suffix in ('.py', '.cu')]
    assert len(files) >= 15
    hits = [f'{p.relative_to(ROOT)}:{i}'
            for p in files
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if pat.search(line)]
    assert not hits, hits


def test_predictor_defaults_to_cuda():
    from dana_tpu_torch.engine.predict import Predictor
    from dana_tpu_torch.utils.device import resolve_device
    if torch.cuda.is_available():
        assert resolve_device().type == 'cuda'
        return
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        Predictor(None, None)
    assert resolve_device('cpu').type == 'cpu'


def test_kernel_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA device is refused,
    never routed to the plain version."""
    from dana_tpu_torch.ops.cisa_attention import cisa_attention_shots
    from dana_tpu_torch.ops.roi_align import roi_align
    meta = torch.empty(1, 4, 4, 8, device='meta')
    with pytest.raises(ValueError):
        roi_align(meta, torch.empty(1, 2, 4, device='meta'))
    q = torch.empty(1, 4, 8, device='meta')
    with pytest.raises(ValueError):
        cisa_attention_shots(q, torch.empty(1, 1, 2, 8, device='meta'),
                             torch.empty(1, 1, 2, 8, device='meta'),
                             torch.empty(1, 1, 2, device='meta'), 1.0, 0.1)
