"""Device selection and float32 math settings for the port's entry points."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device='cuda') -> torch.device:
    """-> torch.device; raises when CUDA is asked for and absent.

    Entry points default to the card.  Only callers that pass
    device='cpu' (the CPU tests) run the plain PyTorch versions of the
    kernels."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'CUDA is not available; pass device="cpu" to run the plain '
            'PyTorch versions of the kernels on the CPU')
    return dev


_TABLES: dict = {}


def device_table(key, device, build) -> torch.Tensor:
    """The table `build()` makes on `device`, made once per (key, device)
    and kept, so a request reuses it; callers never write into it.  Under
    a trace (torch.export) it is built anew: the traced serving program
    (dana_tpu_torch/serve.py) then computes it on the device it runs on
    and holds no tensor constant, which could not be placed on the card
    from a host without one."""
    if torch.compiler.is_compiling():
        return build()
    k = (key, str(torch.device(device)))
    table = _TABLES.get(k)
    if table is None:
        with torch.inference_mode(False):      # usable under autograd too
            table = _TABLES[k] = build()
    return table


def host_table(values, device, dtype=torch.float32) -> torch.Tensor:
    """A small table of host numbers (a nested sequence or numpy array) as
    a tensor on `device` (`device_table`), built there from one
    `torch.full` per entry, each value rounded to `dtype` as
    `torch.tensor` rounds it."""
    arr = np.asarray(values, np.float64)

    def build():
        entries = [torch.full((), float(v), dtype=dtype, device=device)
                   for v in arr.ravel()]
        return torch.stack(entries).reshape(arr.shape)
    return device_table(('host', dtype, arr.shape, arr.tobytes()), device,
                        build)


def use_full_f32():
    """The one place that sets float32 math to full precision.

    On Hopper cuDNN runs float32 convolutions in TF32 by default (about
    three decimal digits), which would move the trunk's features away
    from the JAX reference's float32 numerics.  The slice computes in
    float32, so both TF32 switches go off.  cuBLAS's bf16 products keep
    the sums of a split reduction in float32 too, as the JAX package's bf16
    products sum in float32 (the bf16 RoIAlign's backward is one such
    product).  The flags are process-wide."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def tf32_flags() -> dict:
    m = torch.backends.cuda.matmul
    return {'cudnn.allow_tf32': torch.backends.cudnn.allow_tf32,
            'cuda.matmul.allow_tf32': m.allow_tf32,
            'cuda.matmul.allow_bf16_reduced_precision_reduction':
                m.allow_bf16_reduced_precision_reduction}
