"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by
`nvcc` for sm_90a into its own shared library, loaded with ctypes.  The
build runs at first use into `dana_tpu_torch/_build/` (listed in
.gitignore); the library's file name carries a hash of its source, so an
edited kernel is rebuilt.  `build_all` starts one nvcc per source, all at
once.  No `--use_fast_math`: the RoIAlign kernel's bin arithmetic needs
IEEE division.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time

KERNELS = ('cisa_shots', 'cisa_shots_bf16', 'roi_align', 'nms')
CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'csrc')
BUILD_DIR = os.environ.get('DANA_BUILD_DIR') or os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), '_build')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_LIBS: dict = {}
BUILD_LOG: dict = {}     # name -> nvcc's output (ptxas register report)
# the rows of an int8 grid run in threads of their own (engine/predict.py):
# one build per library (launches are counted in utils/trace.py)
_LOAD_LOCK = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError('no CUDA toolkit found (set CUDA_HOME): the '
                           'kernels are built with nvcc at first use')
    return os.path.join(CUDA_HOME, 'bin', 'nvcc')


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, name + '.cu'), 'rb') as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f'lib{name}-{digest}.so')


def _start(name: str):
    """Start nvcc for one kernel unless its library is built; -> the
    process or None."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{out}.{os.getpid()}.tmp'
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', tmp,
           os.path.join(CSRC, name + '.cu')]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp, out


def _finish(name, started):
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    BUILD_LOG[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed for {name}.cu:\n{log}')
    os.replace(tmp, out)     # atomic: a concurrent loader sees all or none


def build_all() -> float:
    """Build every kernel in parallel; -> wall seconds."""
    t0 = time.perf_counter()
    started = {n: _start(n) for n in KERNELS}
    for n, s in started.items():
        _finish(n, s)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                _finish(name, _start(name))
                lib = _LIBS[name] = ctypes.CDLL(_lib_path(name))
    return lib


def check(err: int, name: str):
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if err != 0:
        raise RuntimeError(f'{name} kernel launch failed: cudaError {err}')
