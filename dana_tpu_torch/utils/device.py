"""Device selection and float32 math settings for the port's entry points."""

from __future__ import annotations

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


def use_full_f32():
    """The one place that sets float32 math to full precision.

    On Hopper cuDNN runs float32 convolutions in TF32 by default (about
    three decimal digits), which would move the trunk's features away
    from the JAX reference's float32 numerics.  The slice computes in
    float32, so both TF32 switches go off.  The flags are process-wide."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def tf32_flags() -> dict:
    return {'cudnn.allow_tf32': torch.backends.cudnn.allow_tf32,
            'cuda.matmul.allow_tf32': torch.backends.cuda.matmul.allow_tf32}
