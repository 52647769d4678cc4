"""CISA attention core (port of dana_tpu/ops/cisa_attention.py
`cisa_attention_shots` and `cisa_attention`).

    out[g] = mean_s ( softmax(q[g] @ k[g,s]^T * scale) + gamma * u[g,s] ) @ v[g,s]

`cisa_attention_shots` launches a hand-written kernel on CUDA tensors and
runs `cisa_attention_shots_plain` on CPU tensors: float32 inputs launch
`csrc/cisa_shots.cu` (3xTF32), bfloat16 inputs `csrc/cisa_shots_bf16.cu`
(bf16 products, float32 sums: the JAX kernel's arithmetic in bfloat16);
mixed dtypes raise.  The model consumes only the mean over shots, so the
kernels never store per-shot outputs.  The bfloat16 kernel runs in two
phases that meet through a bf16 scratch of the probabilities, P
[G, Nq, S*Ns] (`cisa_probs_bf16`), then takes the shot mean as one product
over the shots' keys laid end to end (`cisa_pv_bf16`); each phase has its
plain version, and `bf16_plan` is the host's tile and shared-memory plan.
`cisa_attention` is the single-group form (no shot axis, no mean): the
same kernels entered with S = 1 through views of k, v and u.  Each
launch is counted in the counter table (`utils/trace.py` `launched`):
`cisa_shots.<dtype>` for `cisa_attention_shots`, `cisa_attention.<dtype>`
for `cisa_attention`, each also by device (`cisa_shots.float32@cuda:0`).

Both enter through one registered op, `dana_torch::cisa_shots`
(`cisa_shots_op`), with a fake implementation, so a traced or exported
program holds the kernel as one call; the op's CUDA implementation
launches and counts.  Both are differentiable.  As in the JAX package,
whose custom VJPs recompute the attention in plain XLA math, the backward
recomputes the plain version under autograd and returns its
vector-Jacobian product for q, k, v and u: the kernel serves the forward
only.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from dana_tpu_torch.ops import build
from dana_tpu_torch.utils import trace


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


def cisa_probs_bf16_plain(q, k, unary_sm, scale, gamma):
    """Phase A of the bf16 kernel: q [G,Nq,D], k [G,S,Ns,D], unary_sm
    [G,S,Ns] -> P [G,Nq,S,Ns] in q's dtype, each query's probabilities for
    the shots' keys, rounded as `cisa_attention_shots_plain` rounds them
    (the same operations, so the same bits)."""
    scores = torch.einsum('gqd,gsnd->gsqn', q.float(), k.float()) * scale
    probs = (torch.softmax(scores, dim=-1)
             + gamma * unary_sm.float()[:, :, None, :])
    return probs.to(q.dtype).permute(0, 2, 1, 3).contiguous()


def cisa_pv_bf16_plain(p, v):
    """Phase B of the bf16 kernel: P [G,Nq,S,Ns], v [G,S,Ns,C] -> (1/S)
    P[g] @ v[g] over the shots' keys laid end to end (K = S*Ns), one
    float32 product, divided by S and rounded once to v's dtype."""
    g, s, ns, c = v.shape
    out = p.reshape(g, -1, s * ns).float() @ v.reshape(g, s * ns, c).float()
    return (out / s).to(v.dtype)


# the float32 kernel: its library and its D and C steps
_F32 = ('cisa_shots', 8, 4)
# the bf16 kernel (csrc/cisa_shots_bf16.cu): its D and C steps; 128 query
# rows a block, 64 keys a tile, D in 64-column sub-tiles of 128 bytes; in
# phase A one or two q tiles and 2-4 k slots; in phase B 3 slots of a P
# tile [128 x 64] and a v tile [64 x 256] for 128 x 256 output tiles
_BF16 = ('cisa_shots_bf16', 16, 8)
BF16_SMEM_LIMIT = 232448          # bytes a block may use on sm_90
_BQ, _BK, _BN, _SUB = 128, 64, 256, 64
# phase A's (q slots, k slots), the first that fits; phase B's slots
_SLOTS_A = ((2, 4), (2, 3), (2, 2), (1, 4), (1, 3), (1, 2))
_STAGES_B = 3


def _round_up(x, m):
    return -(-x // m) * m


def bf16_smem_a(d, qslots, stages):
    """Phase A's shared memory (the kernel's `smem_a`): the mbarriers, four
    k slots' u values, `qslots` q tiles and `stages` k slots, + 1024 to
    align the base."""
    nsub = _round_up(d, _SUB) // _SUB
    return 3072 + nsub * (qslots * _BQ * 128 + stages * _BK * 128)


def bf16_smem_b(stages):
    """Phase B's shared memory (the kernel's `smem_b`): the mbarriers,
    `stages` slots of a P and a v tile and two warpgroups' output tiles."""
    return 2048 + stages * (_BQ * 128 + _BK * 2 * _BN) + 2 * 64 * 2 * _BN


@dataclasses.dataclass(frozen=True)
class Bf16Plan:
    nsp: int         # a shot's keys in P's rows: Ns rounded up to 8
    qslots: int      # q tiles of phase A (two: the next item's loads early)
    stages_a: int    # k slots of phase A


def bf16_plan(s, ns, d, c):
    """The bf16 kernel's plan at these shapes, or ValueError for what it
    does not take: S, Ns >= 1, D % 16 == 0 (the wgmma k-step), C % 8 == 0
    (TMA's 16-byte rows), and a q tile plus two k slots within a block's
    shared memory (D <= 448)."""
    if s < 1 or ns < 1:
        raise ValueError(f'cisa_shots_bf16 kernel needs S >= 1 and Ns >= 1 '
                         f'(S={s}, Ns={ns})')
    if d % _BF16[1] or c % _BF16[2]:
        raise ValueError(f'cisa_shots_bf16 kernel loads q, k and v by TMA in '
                         f'16-byte rows and steps D by 16: needs D % 16 == 0 '
                         f'(D={d}), C % 8 == 0 (C={c}) and 16-byte aligned '
                         'q, k, v')
    fits = [qs for qs in _SLOTS_A
            if bf16_smem_a(d, *qs) <= BF16_SMEM_LIMIT]
    if not fits:
        raise ValueError(
            f'cisa_shots_bf16 kernel: D={d} needs {bf16_smem_a(d, 1, 2)} B '
            f'of shared memory for its q tile and two k slots, above the '
            f'{BF16_SMEM_LIMIT} B a block may use')
    return Bf16Plan(nsp=_round_up(ns, 8), qslots=fits[0][0],
                    stages_a=fits[0][1])


def _f32_lib():
    """-> (the float32 kernel's entry, smem(Ns, D): the bytes of shared
    memory a launch needs, the bytes a block may use)."""
    name = _F32[0]
    lib = build.load(name)
    fn = lib.cisa_shots_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.cisa_shots_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.cisa_shots_smem_bytes.restype = ctypes.c_size_t
        lib.cisa_shots_smem_limit.restype = ctypes.c_size_t
    return fn, lib.cisa_shots_smem_bytes, lib.cisa_shots_smem_limit()


def _bf16_lib():
    """The bf16 kernel's library, its entries typed; its shared-memory
    formulas are held against `bf16_smem_a` / `bf16_smem_b` once."""
    lib = build.load(_BF16[0])
    if lib.cisa_shots_bf16.argtypes is None:
        ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.cisa_shots_bf16.argtypes = ([ptr] * 6 + [i] * 6
                                        + [f, f, i, i, i, ptr])
        lib.cisa_probs_bf16.argtypes = ([ptr] * 4 + [i] * 5
                                        + [f, f, i, i, ptr])
        lib.cisa_pv_bf16.argtypes = [ptr] * 3 + [i] * 6 + [ptr]
        for fn in (lib.cisa_shots_bf16, lib.cisa_probs_bf16,
                   lib.cisa_pv_bf16):
            fn.restype = ctypes.c_int
        lib.cisa_shots_bf16_smem_a.argtypes = [i, i, i]
        lib.cisa_shots_bf16_smem_b.argtypes = [i]
        for fn in (lib.cisa_shots_bf16_smem_a, lib.cisa_shots_bf16_smem_b,
                   lib.cisa_shots_bf16_smem_limit):
            fn.restype = ctypes.c_size_t
        host = ((lib.cisa_shots_bf16_smem_a(d, *qs), bf16_smem_a(d, *qs))
                for d in (16, 256, 448) for qs in _SLOTS_A)
        if any(a != b for a, b in host) \
                or lib.cisa_shots_bf16_smem_b(_STAGES_B) \
                != bf16_smem_b(_STAGES_B) \
                or lib.cisa_shots_bf16_smem_limit() != BF16_SMEM_LIMIT:
            raise RuntimeError('cisa_shots_bf16: the host plan and the '
                               'kernel disagree on shared memory')
    return lib


def _check(ts, name):
    """CUDA tensors on one device, contiguous, 16-byte aligned, bf16."""
    if any(t.dtype != torch.bfloat16 for t in ts):
        raise TypeError(f'{name} takes bfloat16 tensors (got '
                        f'{[t.dtype for t in ts]})')
    if ts[0].device.type != 'cuda' or any(t.device != ts[0].device
                                          for t in ts):
        raise ValueError(f'{name}: inputs must be on one CUDA device (got '
                         f'{[str(t.device) for t in ts]})')
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f'{name} kernel takes contiguous tensors')
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f'{name} kernel needs 16-byte aligned tensors')


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(q, k, v, unary_sm, scale, gamma):
    """Check the inputs and launch the cisa_shots kernel of their dtype
    (k [G,S,Ns,D])."""
    ts = (q, k, v, unary_sm)
    if q.device.type != 'cuda' or any(t.device != q.device for t in ts):
        raise ValueError('cisa_attention_shots: inputs must be on one CUDA '
                         f'device (got {[str(t.device) for t in ts]})')
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or any(t.dtype != q.dtype for t in ts):
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
    if q.dtype == torch.bfloat16:
        return _launch_bf16(q, k, v, unary_sm, scale, gamma)
    name, d_step, c_step = _F32
    if d % d_step or c % c_step or any(t.data_ptr() % 16
                                       for t in (q, k, v)):
        raise ValueError(f'{name} kernel stages q, k and v in 16-byte '
                         f'copies and steps D by {d_step}: needs D % '
                         f'{d_step} == 0 (D={d}), C % {c_step} == 0 (C={c}) '
                         'and 16-byte aligned q, k, v')
    fn, smem_fn, limit = _f32_lib()
    smem = smem_fn(ns, d)
    if smem > limit:
        raise ValueError(
            f'{name} kernel: Ns={ns}, D={d}, C={c} needs {smem} B of '
            f'shared memory, above the {limit} B a block may use')
    out = torch.empty(g, nq, c, device=q.device, dtype=q.dtype)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 unary_sm.data_ptr(), out.data_ptr(), g, s, nq, ns, d, c,
                 float(scale), float(gamma), _stream(q))
    build.check(err, name)
    return out


def _launch_bf16(q, k, v, unary_sm, scale, gamma):
    """Both phases of the bf16 kernel on checked inputs, through a bf16
    scratch P [G, Nq, S, Nsp]."""
    g, nq, d = q.shape
    s, ns, c = v.shape[1:]
    plan = bf16_plan(s, ns, d, c)
    if any(t.data_ptr() % 16 for t in (q, k, v, unary_sm)):
        raise ValueError('cisa_shots_bf16 kernel loads q, k, v and u by TMA: '
                         'needs D % 16 == 0, C % 8 == 0 and 16-byte '
                         'aligned q, k, v, u')
    lib = _bf16_lib()
    p = torch.empty(g, nq, s, plan.nsp, device=q.device, dtype=q.dtype)
    out = torch.empty(g, nq, c, device=q.device, dtype=q.dtype)
    with torch.cuda.device(q.device):
        err = lib.cisa_shots_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), unary_sm.data_ptr(),
            p.data_ptr(), out.data_ptr(), g, s, nq, ns, d, c, float(scale),
            float(gamma), plan.qslots, plan.stages_a, _STAGES_B, _stream(q))
    build.check(err, _BF16[0])
    return out


def cisa_probs_bf16(q, k, unary_sm, scale, gamma):
    """Phase A alone (timed apart by chip_smoke.py; the model calls
    `cisa_attention_shots`): P [G,Nq,S,Ns] in bf16, the kernel's scratch
    on CUDA tensors (a view of its [G,Nq,S,Nsp] rows),
    `cisa_probs_bf16_plain` on CPU tensors.  Counts no launch."""
    if q.device.type == 'cpu':
        return cisa_probs_bf16_plain(q, k, unary_sm, scale, gamma)
    _check((q, k, unary_sm), 'cisa_probs_bf16')
    g, nq, d = q.shape
    s, ns = unary_sm.shape[1:]
    plan = bf16_plan(s, ns, d, 8)                # phase A takes no C
    p = torch.empty(g, nq, s, plan.nsp, device=q.device, dtype=q.dtype)
    with torch.cuda.device(q.device):
        err = _bf16_lib().cisa_probs_bf16(
            q.data_ptr(), k.data_ptr(), unary_sm.data_ptr(), p.data_ptr(),
            g, s, nq, ns, d, float(scale), float(gamma), plan.qslots,
            plan.stages_a, _stream(q))
    build.check(err, 'cisa_probs_bf16')
    return p[..., :ns]


def cisa_pv_bf16(p, v):
    """Phase B alone: (1/S) P @ v over the shots' keys, bf16.  On CUDA, P is
    what `cisa_probs_bf16` returned (shots Nsp keys apart); on the CPU the
    plain version.  Counts no launch."""
    if p.device.type == 'cpu':
        return cisa_pv_bf16_plain(p, v)
    g, s, ns, c = v.shape
    nq = p.shape[1]
    nsp = bf16_plan(s, ns, 16, c).nsp           # phase B takes no D
    if p.shape != (g, nq, s, ns) \
            or p.stride() != (nq * s * nsp, s * nsp, nsp, 1):
        raise ValueError('cisa_pv_bf16 takes P as cisa_probs_bf16 returns '
                         f'it (got {tuple(p.shape)}, strides {p.stride()})')
    _check((v,), 'cisa_pv_bf16')
    if p.device != v.device or p.dtype != v.dtype:
        raise TypeError('cisa_pv_bf16: P and v must be bf16 on one device')
    out = torch.empty(g, nq, c, device=v.device, dtype=v.dtype)
    with torch.cuda.device(v.device):
        err = _bf16_lib().cisa_pv_bf16(
            p.data_ptr(), v.data_ptr(), out.data_ptr(), g, s, nq, ns, c,
            _STAGES_B, _stream(v))
    build.check(err, 'cisa_pv_bf16')
    return out


@torch.library.custom_op('dana_torch::cisa_shots', mutates_args=())
def cisa_shots_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  unary_sm: torch.Tensor, scale: float, gamma: float,
                  single: bool) -> torch.Tensor:
    """The kernels' forward as one registered op: q [G,Nq,D], k
    [G,S,Ns,D], v [G,S,Ns,C], unary_sm [G,S,Ns] -> [G,Nq,C] in q's dtype.
    CPU tensors: the plain version (`cisa_attention_plain` on the S = 1
    views when `single`, else `cisa_attention_shots_plain`); CUDA tensors:
    the kernel of q's dtype, one launch counted as `cisa_attention` when
    `single`, else as `cisa_shots`."""
    if single:
        return cisa_attention_plain(q, k[:, 0], v[:, 0], unary_sm, scale,
                                    gamma)
    return cisa_attention_shots_plain(q, k, v, unary_sm, scale, gamma)


@cisa_shots_op.register_fake
def _(q, k, v, unary_sm, scale, gamma, single):
    return q.new_empty(q.shape[0], q.shape[1], v.shape[-1])


@cisa_shots_op.register_kernel('cuda')
def _(q, k, v, unary_sm, scale, gamma, single):
    out = _launch(q, k, v, unary_sm, scale, gamma)
    trace.launched('cisa_attention' if single else 'cisa_shots', q.device,
                   q.dtype)
    return out


class _CisaShots(torch.autograd.Function):
    """forward: `cisa_shots_op` (a kernel launch or, on the CPU, a plain
    version); backward: the VJP of cisa_attention_shots_plain,
    recomputed."""

    @staticmethod
    def forward(ctx, q, k, v, unary_sm, scale, gamma, single):
        ctx.save_for_backward(q, k, v, unary_sm)
        ctx.scale, ctx.gamma = scale, gamma
        return cisa_shots_op(q, k, v, unary_sm, scale, gamma, single)

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


def _apply(q, k, v, unary_sm, scale, gamma, single):
    """The op, under `_CisaShots` where a gradient is wanted (a traced
    serving program holds the bare op).  Tensors on a device that is
    neither the CPU nor a CUDA card are refused, never faked."""
    ts = (q, k, v, unary_sm)
    if any(t.device.type not in ('cpu', 'cuda') for t in ts):
        raise ValueError('cisa_attention_shots: inputs must be CPU or CUDA '
                         f'tensors (got {[str(t.device) for t in ts]})')
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        return _CisaShots.apply(q, k, v, unary_sm, float(scale),
                                float(gamma), single)
    return cisa_shots_op(q, k, v, unary_sm, float(scale), float(gamma),
                         single)


def cisa_attention_shots(q, k, v, unary_sm, scale, gamma):
    """The shot-fused CISA core: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors; differentiable in q, k, v and unary_sm.  Same
    arguments as `cisa_attention_shots_plain`."""
    return _apply(q, k, v, unary_sm, scale, gamma, False)


def cisa_attention(q, k, v, unary_sm, scale, gamma):
    """Single-group CISA: the cisa_shots kernel at S = 1 for CUDA tensors,
    `cisa_attention_plain` for CPU tensors; differentiable.  Same
    arguments as `cisa_attention_plain`."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3 or unary_sm.dim() != 3:
        raise ValueError('cisa_attention: q, k, v and unary_sm are '
                         '[G,Nq,D], [G,Ns,D], [G,Ns,C], [G,1,Ns]')
    return _apply(q, k[:, None], v[:, None], unary_sm, scale, gamma, True)
