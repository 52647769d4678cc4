"""CISA attention core (port of dana_tpu/ops/cisa_attention.py
`cisa_attention_shots` and `cisa_attention`).

    out[g] = mean_s ( softmax(q[g] @ k[g,s]^T * scale) + gamma * u[g,s] ) @ v[g,s]

`cisa_attention_shots` launches the hand-written kernel
`csrc/cisa_shots.cu` on CUDA tensors and runs `cisa_attention_shots_plain`
on CPU tensors.  The model consumes only the mean over shots, so the
kernel takes it in registers and never stores per-shot outputs.
`cisa_attention` is the single-group form (no shot axis, no mean): the
same kernel entered with S = 1 through views of k, v and u.

Both are differentiable.  As in the JAX package, whose custom VJPs
recompute the attention in plain XLA math, the backward recomputes the
plain version under autograd and returns its vector-Jacobian product for
q, k, v and u: the kernel serves the forward only.
"""

from __future__ import annotations

import ctypes

import torch

from dana_tpu_torch.ops import build


def cisa_attention_shots_plain(q, k, v, unary_sm, scale, gamma):
    """q [G,Nq,D], k [G,S,Ns,D], v [G,S,Ns,C], unary_sm [G,S,Ns]
    (softmax over Ns) -> [G,Nq,C], the mean over the S shots."""
    scores = torch.einsum('gqd,gsnd->gsqn', q, k) * scale
    probs = torch.softmax(scores, dim=-1) + gamma * unary_sm[:, :, None, :]
    return torch.einsum('gsqn,gsnc->gsqc', probs, v).mean(dim=1)


def cisa_attention_plain(q, k, v, unary_sm, scale, gamma):
    """q [G,Nq,D], k [G,Ns,D], v [G,Ns,C], unary_sm [G,1,Ns] -> [G,Nq,C]."""
    scores = torch.einsum('gqd,gnd->gqn', q, k) * scale
    probs = torch.softmax(scores, dim=-1) + gamma * unary_sm
    return torch.einsum('gqn,gnc->gqc', probs, v)


def _lib():
    lib = build.load('cisa_shots')
    if lib.cisa_shots_f32.argtypes is None:
        lib.cisa_shots_f32.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        lib.cisa_shots_f32.restype = ctypes.c_int
        lib.cisa_shots_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.cisa_shots_smem_bytes.restype = ctypes.c_size_t
        lib.cisa_shots_smem_limit.restype = ctypes.c_size_t
    return lib


def _launch(q, k, v, unary_sm, scale, gamma):
    """Check the inputs and launch the cisa_shots kernel (k [G,S,Ns,D])."""
    ts = (q, k, v, unary_sm)
    if q.device.type != 'cuda' or any(t.device != q.device for t in ts):
        raise ValueError('cisa_attention_shots: inputs must be on one CUDA '
                         f'device (got {[str(t.device) for t in ts]})')
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError('cisa_attention_shots kernel takes float32 inputs '
                        f'(got {[t.dtype for t in ts]})')
    if q.dim() != 3 or k.dim() != 4 or v.dim() != 4 or unary_sm.dim() != 3:
        raise ValueError('cisa_attention_shots: bad ranks')
    g, nq, d = q.shape
    s, ns, c = v.shape[1:]
    if k.shape != (g, s, ns, d) or v.shape[0] != g \
            or unary_sm.shape != (g, s, ns):
        raise ValueError(
            f'cisa_attention_shots: shapes q {tuple(q.shape)}, k '
            f'{tuple(k.shape)}, v {tuple(v.shape)}, u {tuple(unary_sm.shape)}'
            ' do not agree')
    if not all(t.is_contiguous() for t in ts):
        raise ValueError('cisa_attention_shots kernel takes contiguous '
                         'tensors')
    if d % 8 or c % 4 or any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError('cisa_attention_shots kernel stages q, k and v in '
                         f'16-byte copies and steps D by 8: needs D % 8 == 0 '
                         f'(D={d}), C % 4 == 0 (C={c}) and 16-byte aligned '
                         'q, k, v')
    lib = _lib()
    smem = lib.cisa_shots_smem_bytes(ns, d)
    if smem > lib.cisa_shots_smem_limit():
        raise ValueError(
            f'cisa_attention_shots kernel: Ns={ns}, D={d} needs {smem} B '
            f'of shared memory, above the {lib.cisa_shots_smem_limit()} B '
            'a block may use')
    out = torch.empty(g, nq, c, device=q.device, dtype=torch.float32)
    with torch.cuda.device(q.device):
        err = lib.cisa_shots_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), unary_sm.data_ptr(),
            out.data_ptr(), g, s, nq, ns, d, c, float(scale), float(gamma),
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, 'cisa_shots')
    return out


def _shots_forward(q, k, v, unary_sm, scale, gamma):
    if q.device.type == 'cpu':
        return cisa_attention_shots_plain(q, k, v, unary_sm, scale, gamma)
    out = _launch(q, k, v, unary_sm, scale, gamma)
    cisa_attention_shots.launches += 1
    return out


def _single_forward(q, k1, v1, unary_sm, scale, gamma):
    """cisa_attention's forward on the S = 1 views k1 [G,1,Ns,D], v1."""
    if q.device.type == 'cpu':
        return cisa_attention_plain(q, k1[:, 0], v1[:, 0], unary_sm, scale,
                                    gamma)
    out = _launch(q, k1, v1, unary_sm, scale, gamma)
    cisa_attention.launches += 1
    return out


class _CisaShots(torch.autograd.Function):
    """forward: `fwd` (a kernel launch or, on the CPU, a plain version);
    backward: the VJP of cisa_attention_shots_plain, recomputed."""

    @staticmethod
    def forward(ctx, q, k, v, unary_sm, scale, gamma, fwd):
        ctx.save_for_backward(q, k, v, unary_sm)
        ctx.scale, ctx.gamma = scale, gamma
        return fwd(q, k, v, unary_sm, scale, gamma)

    @staticmethod
    def backward(ctx, grad):
        need = ctx.needs_input_grad[:4]
        xs = [t.detach().requires_grad_(n)
              for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            out = cisa_attention_shots_plain(*xs, ctx.scale, ctx.gamma)
            wrt = [x for x, n in zip(xs, need) if n]
            grads = iter(torch.autograd.grad(out, wrt, grad))
        return (*(next(grads) if n else None for n in need), None, None,
                None)


def cisa_attention_shots(q, k, v, unary_sm, scale, gamma):
    """The shot-fused CISA core: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors; differentiable in q, k, v and unary_sm.  Same
    arguments as `cisa_attention_shots_plain`."""
    return _CisaShots.apply(q, k, v, unary_sm, scale, gamma, _shots_forward)


def cisa_attention(q, k, v, unary_sm, scale, gamma):
    """Single-group CISA: the cisa_shots kernel at S = 1 for CUDA tensors,
    `cisa_attention_plain` for CPU tensors; differentiable.  Same
    arguments as `cisa_attention_plain`."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3 or unary_sm.dim() != 3:
        raise ValueError('cisa_attention: q, k, v and unary_sm are '
                         '[G,Nq,D], [G,Ns,D], [G,Ns,C], [G,1,Ns]')
    return _CisaShots.apply(q, k[:, None], v[:, None], unary_sm, scale,
                            gamma, _single_forward)


cisa_attention_shots.launches = 0
cisa_attention.launches = 0
