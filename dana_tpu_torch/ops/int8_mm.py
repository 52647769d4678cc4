"""The int8 product of int8 serving as a registered op,
`dana_torch::int8_mm`: a [M, K] int8 times b [K, N] int8 -> [M, N] int32,
exact.  On CPU tensors it runs the plain version, an exact float64
product; on CUDA tensors `torch._int_mm` (cuBLASLt s8 x s8 -> s32) on the
operands `int_mm_operands` lays out, counting the launch.  The op has a
fake implementation, so a traced program (dana_tpu_torch/serve.py) holds
one call whose device is chosen when it runs, and a program traced on a
host without a card serves on the card.  The int8 convs
(models/layers.py `int8_conv_acc`) and the int8 RoIAlign
(ops/roi_align.py `roi_align_int8`) reach it through `int8_matmul`.
"""

from __future__ import annotations

import collections

import torch
import torch.nn.functional as F

from dana_tpu_torch.ops import build


def int_mm_operands(a, b):
    """The operands `torch._int_mm` takes for a @ b: K and N zero padded to
    multiples of 8 (cuBLASLt's int8 alignment; `_int_mm` refuses others),
    a row-major, b column-major (on the H100's build the row-major b ran
    7x slower: 1.54 against 0.22 ms at [38400, 4608] x [4608, 512])."""
    dk, dn = -a.shape[1] % 8, -b.shape[1] % 8
    if dk:
        a = F.pad(a, (0, dk))
    if dk or dn:
        b = F.pad(b, (0, dn, 0, dk))
    return a.contiguous(), b.t().contiguous().t()


def int8_matmul_plain(a, b):
    """a [M, K] int8 times b [K, N] int8 -> [M, N] int32 as a float64
    product: every partial sum is an integer below 2**53 (|a b| <= 127**2
    per term), so the product is exact in any order."""
    return (a.double() @ b.double()).to(torch.int32)


@torch.library.custom_op('dana_torch::int8_mm', mutates_args=())
def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The exact int8 product as one registered op.  CPU tensors: the plain
    version; CUDA tensors: `torch._int_mm`, one launch counted on
    `int8_matmul`."""
    return int8_matmul_plain(a, b)


@int8_mm.register_fake
def _(a, b):
    return a.new_empty(a.shape[0], b.shape[1], dtype=torch.int32)


@int8_mm.register_kernel('cuda')
def _(a, b):
    if a.device != b.device or a.dtype != torch.int8 \
            or b.dtype != torch.int8:
        raise TypeError('int8_mm: a and b must be int8 on one device (got '
                        f'{a.dtype} on {a.device}, {b.dtype} on {b.device})')
    if a.shape[0] <= 16:
        raise ValueError(f'int8_matmul: torch._int_mm needs more than 16 '
                         f'rows (got {a.shape[0]})')
    n = b.shape[1]
    out = torch._int_mm(*int_mm_operands(a, b))
    build.count(int8_matmul, 'launches', (str(a.device), 'int8'))
    return out if out.shape[1] == n else out[:, :n].contiguous()


def int8_matmul(a, b):
    """a [M, K] int8 times b [K, N] int8 -> [M, N] int32, exact, through
    `int8_mm`: `torch._int_mm` on CUDA tensors, the plain version on CPU
    tensors; tensors on another device are refused.  The card raises on
    M <= 16, which `_int_mm` refuses."""
    if a.device.type not in ('cpu', 'cuda'):
        raise ValueError('int8_matmul: a and b must be CPU or CUDA tensors '
                         f'(got {a.device}, {b.device})')
    return int8_mm(a, b)


int8_matmul.launches = 0
int8_matmul.launches_by_device = collections.Counter()
