"""CISA attention core (port of dana_tpu/ops/cisa_attention.py
`cisa_attention_shots` and `cisa_attention`).

    out[g] = mean_s ( softmax(q[g] @ k[g,s]^T * scale) + gamma * u[g,s] ) @ v[g,s]

`cisa_attention_shots` launches a hand-written kernel on CUDA tensors and
runs `cisa_attention_shots_plain` on CPU tensors: float32 inputs launch
`csrc/cisa_shots.cu` (3xTF32), bfloat16 inputs `csrc/cisa_shots_bf16.cu`
(bf16 products, float32 sums: the JAX kernel's arithmetic in bfloat16);
mixed dtypes raise.  The model consumes only the mean over shots, so the
kernels take it in registers and never store per-shot outputs.
`cisa_attention` is the single-group form (no shot axis, no mean): the
same kernels entered with S = 1 through views of k, v and u.  Each
wrapper counts its float32 launches in `launches` and its bfloat16 ones
in `launches_bf16`.

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
    (softmax over Ns) -> [G,Nq,C], the mean over the S shots, in v's
    dtype.  The JAX kernel's arithmetic in either dtype: the scores are
    float32 sums of the operands' exact products, the softmax and the
    unary term float32, the probabilities rounded to v's dtype before the
    PV product, which sums in float32, and the shot mean is rounded once.
    In float32 every cast is a no-op."""
    scores = torch.einsum('gqd,gsnd->gsqn', q.float(), k.float()) * scale
    probs = (torch.softmax(scores, dim=-1)
             + gamma * unary_sm.float()[:, :, None, :])
    out = torch.einsum('gsqn,gsnc->gsqc', probs.to(v.dtype).float(),
                       v.float())
    return out.mean(dim=1).to(v.dtype)


def cisa_attention_plain(q, k, v, unary_sm, scale, gamma):
    """q [G,Nq,D], k [G,Ns,D], v [G,Ns,C], unary_sm [G,1,Ns] -> [G,Nq,C]
    in v's dtype, with the arithmetic of `cisa_attention_shots_plain`."""
    scores = torch.einsum('gqd,gnd->gqn', q.float(), k.float()) * scale
    probs = torch.softmax(scores, dim=-1) + gamma * unary_sm.float()
    out = torch.einsum('gqn,gnc->gqc', probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


# dtype -> (library and entry name, the D and C steps it takes, the
# arguments of <name>_smem_bytes, the shared memory of its smallest tile
# plan, out of (Ns, D, C)); each library also exports <name>_smem_limit()
_KERNELS = {torch.float32: ('cisa_shots', 'cisa_shots_f32', 8, 4, 2),
            torch.bfloat16: ('cisa_shots_bf16', 'cisa_shots_bf16', 16, 8, 3)}


def _lib(dtype):
    """-> (the dtype's kernel entry, smem(Ns, D, C): the bytes of shared
    memory a launch needs, the bytes a block may use)."""
    name, entry, _, _, n_smem = _KERNELS[dtype]
    lib = build.load(name)
    fn = getattr(lib, entry)
    smem_fn = getattr(lib, f'{name}_smem_bytes')
    limit_fn = getattr(lib, f'{name}_smem_limit')
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        smem_fn.argtypes = [ctypes.c_int] * n_smem
        smem_fn.restype = limit_fn.restype = ctypes.c_size_t
    return fn, lambda *ndc: smem_fn(*ndc[:n_smem]), limit_fn()


def _launch(q, k, v, unary_sm, scale, gamma):
    """Check the inputs and launch the cisa_shots kernel of their dtype
    (k [G,S,Ns,D])."""
    ts = (q, k, v, unary_sm)
    if q.device.type != 'cuda' or any(t.device != q.device for t in ts):
        raise ValueError('cisa_attention_shots: inputs must be on one CUDA '
                         f'device (got {[str(t.device) for t in ts]})')
    if q.dtype not in _KERNELS or any(t.dtype != q.dtype for t in ts):
        raise TypeError('cisa_attention_shots kernels take float32 or '
                        'bfloat16 inputs, all of one dtype (got '
                        f'{[t.dtype for t in ts]})')
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
    name, _, d_step, c_step, _ = _KERNELS[q.dtype]
    if d % d_step or c % c_step or any(t.data_ptr() % 16
                                       for t in (q, k, v)):
        raise ValueError(f'{name} kernel stages q, k and v in 16-byte '
                         f'copies and steps D by {d_step}: needs D % '
                         f'{d_step} == 0 (D={d}), C % {c_step} == 0 (C={c}) '
                         'and 16-byte aligned q, k, v')
    fn, smem_fn, limit = _lib(q.dtype)
    smem = smem_fn(ns, d, c)
    if smem > limit:
        raise ValueError(
            f'{name} kernel: Ns={ns}, D={d}, C={c} needs {smem} B of '
            f'shared memory, above the {limit} B a block may use')
    out = torch.empty(g, nq, c, device=q.device, dtype=q.dtype)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 unary_sm.data_ptr(), out.data_ptr(), g, s, nq, ns, d, c,
                 float(scale), float(gamma),
                 torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, name)
    return out


def _count(wrapper, dtype):
    if dtype == torch.bfloat16:
        wrapper.launches_bf16 += 1
    else:
        wrapper.launches += 1


def _shots_forward(q, k, v, unary_sm, scale, gamma):
    if q.device.type == 'cpu':
        return cisa_attention_shots_plain(q, k, v, unary_sm, scale, gamma)
    out = _launch(q, k, v, unary_sm, scale, gamma)
    _count(cisa_attention_shots, q.dtype)
    return out


def _single_forward(q, k1, v1, unary_sm, scale, gamma):
    """cisa_attention's forward on the S = 1 views k1 [G,1,Ns,D], v1."""
    if q.device.type == 'cpu':
        return cisa_attention_plain(q, k1[:, 0], v1[:, 0], unary_sm, scale,
                                    gamma)
    out = _launch(q, k1, v1, unary_sm, scale, gamma)
    _count(cisa_attention, q.dtype)
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


cisa_attention_shots.launches = cisa_attention_shots.launches_bf16 = 0
cisa_attention.launches = cisa_attention.launches_bf16 = 0
