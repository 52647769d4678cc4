"""Shot-fused CISA attention core (port of dana_tpu/ops/cisa_attention.py
`cisa_attention_shots`).

    out[g] = mean_s ( softmax(q[g] @ k[g,s]^T * scale) + gamma * u[g,s] ) @ v[g,s]

`cisa_attention_shots` launches the hand-written kernel
`csrc/cisa_shots.cu` on CUDA tensors and runs `cisa_attention_shots_plain`
on CPU tensors.  The model consumes only the mean over shots, so the
kernel takes it in registers and never stores per-shot outputs.
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


def cisa_attention_shots(q, k, v, unary_sm, scale, gamma):
    """The CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    Same arguments as `cisa_attention_shots_plain`."""
    if q.device.type == 'cpu':
        return cisa_attention_shots_plain(q, k, v, unary_sm, scale, gamma)
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
    if d % 4 or q.data_ptr() % 16 or k.data_ptr() % 16:
        raise ValueError('cisa_attention_shots kernel reads q and k as '
                         f'float4: needs D % 4 == 0 (D={d}) and 16-byte '
                         'aligned q, k')
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
    cisa_attention_shots.launches += 1
    return out


cisa_attention_shots.launches = 0
