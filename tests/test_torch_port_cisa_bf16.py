"""The bf16 CISA kernel's two phases on the CPU (ops/cisa_attention.py).

The bf16 kernel (csrc/cisa_shots_bf16.cu) computes the shot-fused CISA core
in two phases that meet through a bf16 scratch: phase A writes the
probabilities P = bf16(softmax(scale q k^T) + gamma u) [G, Nq, S, Ns];
phase B takes the shot mean as one product (1/S) P @ v[g] over the shots'
keys laid end to end, K = S*Ns.  Each phase has a plain version, which
the CPU runs; the host plans the kernel's tiles and shared memory in
Python (`bf16_plan`).  Inputs are numpy draws from a seed, rounded once to bf16
by torch and handed to JAX as the same values.  Tolerances:
  * P of the phase-A plain version against the probabilities of
    `cisa_attention_shots_plain`: bit for bit (the same operations);
  * the phases composed against `cisa_attention_shots_plain`: one bf16
    ulp at the output's scale, 2**-7 * max|plain| (one float32 sum over
    all the shots' keys in place of a sum per shot);
  * against the JAX package's `cisa_attention_shots` (XLA, and its Pallas
    kernel in interpret mode) and `cisa_attention`: the same ulp; P against
    JAX's bf16 probabilities: one bf16 ulp of each value (XLA's and
    torch's float32 exp and softmax sums may round apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dana_tpu.ops import cisa_attention as jca
from dana_tpu_torch.ops import cisa_attention as tca
from dana_tpu_torch.utils import trace

BF16 = torch.bfloat16
ULP = 2.0 ** -7          # one bf16 ulp, relative to the output's scale

# (G, S, Nq, Ns, D, C): test_torch_port_precision.py's sizes, then Ns = 1,
# a lone query row and ragged shapes
SHAPES = [(2, 3, 40, 23, 32, 48), (2, 1, 40, 23, 32, 48),
          (1, 3, 17, 1, 16, 8), (3, 2, 77, 57, 64, 96), (1, 2, 1, 9, 48, 24)]


def _inputs(g, s, nq, ns, d, c, seed=0):
    """-> [(torch bf16, the same values as a JAX bf16 array)] for q, k, v,
    u (u a softmax over Ns)."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(g, s, ns))
    u = np.exp(u - u.max(-1, keepdims=True))
    u /= u.sum(-1, keepdims=True)
    out = []
    for x in (rng.normal(size=(g, nq, d)), rng.normal(size=(g, s, ns, d)),
              rng.normal(size=(g, s, ns, c)), u):
        t = torch.from_numpy(np.asarray(x, np.float32)).to(BF16)
        out.append((t, jnp.asarray(t.float().numpy(), jnp.bfloat16)))
    return out


def _within_ulp(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err, tol = np.abs(got - want).max(), ULP * np.abs(want).max()
    assert err <= tol, (err, tol)


def _plain_probs(q, k, u, scale, gamma):
    """The probabilities as `cisa_attention_shots_plain` forms them,
    [G, S, Nq, Ns] in bf16."""
    scores = torch.einsum('gqd,gsnd->gsqn', q.float(), k.float()) * scale
    return (torch.softmax(scores, dim=-1)
            + gamma * u.float()[:, :, None, :]).to(BF16)


@pytest.mark.parametrize('shape', SHAPES)
def test_probs_plain_is_the_plain_versions_probabilities(shape):
    g, s, nq, ns, d, c = shape
    (q, _), (k, _), _, (u, _) = _inputs(*shape)
    p = tca.cisa_probs_bf16_plain(q, k, u, d ** -0.5, 0.1)
    assert p.shape == (g, nq, s, ns) and p.dtype == BF16
    want = _plain_probs(q, k, u, d ** -0.5, 0.1)
    assert torch.equal(p.permute(0, 2, 1, 3), want)


@pytest.mark.parametrize('shape', SHAPES)
def test_phases_compose_to_the_plain_version(shape):
    g, s, nq, ns, d, c = shape
    (q, _), (k, _), (v, _), (u, _) = _inputs(*shape, seed=1)
    out = tca.cisa_pv_bf16_plain(
        tca.cisa_probs_bf16_plain(q, k, u, d ** -0.5, 0.1), v)
    assert out.shape == (g, nq, c) and out.dtype == BF16
    _within_ulp(out.float(), tca.cisa_attention_shots_plain(
        q, k, v, u, d ** -0.5, 0.1).float())


@pytest.mark.parametrize('jax_fn', ['xla', 'pallas_interpret'])
def test_phases_match_jax(jax_fn):
    """The two phases' plain versions, composed, against JAX's XLA path and
    its Pallas kernel (interpreted on the CPU) on the same bf16 inputs."""
    (q, jq), (k, jk), (v, jv), (u, ju) = _inputs(2, 3, 40, 23, 32, 48, 2)
    scale, gamma = 32 ** -0.5, 0.1
    if jax_fn == 'xla':
        want = jca.cisa_attention_shots_xla(jq, jk, jv, ju, scale, gamma)
    else:
        want = jca._fused_shots(jq, jk, jv, ju, scale, gamma, block_q=16)
    got = tca.cisa_pv_bf16(tca.cisa_probs_bf16(q, k, u, scale, gamma), v)
    assert want.dtype == jnp.bfloat16
    _within_ulp(got.float(), want)


def test_single_group_phases_match_jax():
    """K4 (S = 1) through the two phases against JAX's cisa_attention (its
    Pallas kernel, interpreted)."""
    (q, jq), (k, jk), (v, jv), (u, ju) = _inputs(2, 1, 40, 23, 32, 48, 3)
    want = jca.cisa_attention(jq, jk[:, 0], jv[:, 0], ju, 0.25, 0.1)
    _within_ulp(tca.cisa_pv_bf16(tca.cisa_probs_bf16(q, k, u, 0.25, 0.1),
                                 v).float(), want)


def test_probs_match_jax_probabilities():
    (q, jq), (k, jk), _, (u, ju) = _inputs(2, 3, 40, 23, 32, 48, 4)
    scale, gamma = 32 ** -0.5, 0.1
    scores = jnp.einsum('gqd,gsnd->gsqn', jq, jk,
                        preferred_element_type=jnp.float32) * scale
    want = np.asarray(
        (jax.nn.softmax(scores, axis=-1)
         + gamma * ju[:, :, None, :].astype(jnp.float32))
        .astype(jnp.bfloat16), np.float32)
    got = tca.cisa_probs_bf16(q, k, u, scale, gamma).float().numpy()
    got = got.transpose(0, 2, 1, 3)
    assert np.all(np.abs(got - want) <= ULP * np.abs(want))


def test_cpu_wrappers_run_the_plain_versions():
    (q, _), (k, _), (v, _), (u, _) = _inputs(3, 2, 77, 57, 64, 96, 5)
    p = tca.cisa_probs_bf16(q, k, u, 0.125, 0.1)
    assert torch.equal(p, tca.cisa_probs_bf16_plain(q, k, u, 0.125, 0.1))
    assert torch.equal(tca.cisa_pv_bf16(p, v), tca.cisa_pv_bf16_plain(p, v))
    before = trace.counts()['cisa_shots.bfloat16']
    tca.cisa_attention_shots(q, k, v, u, 0.125, 0.1)
    assert trace.counts()['cisa_shots.bfloat16'] == before


# the shapes the earlier mma.sync kernel took and the model gives: the
# serving sites on ResNet's 1024 and VGG16's 512 channels, K4, Ns = 1,
# ragged shapes, S = 1..3
ACCEPTED = {
    'rpn': (8, 3, 2432, 400, 256, 1024), 'roi': (8, 3, 14700, 49, 256, 1024),
    'rpn_c512': (8, 3, 2432, 400, 256, 512),
    'roi_c512': (8, 3, 14700, 49, 256, 512),
    'single': (8, 1, 2432, 400, 256, 1024), 'ns1': (2, 3, 1000, 1, 256, 1024),
    'ragged': (3, 2, 77, 57, 256, 1096),
    'c1096_s1': (1, 1, 200, 49, 256, 1096),
    'small_d': (1, 3, 40, 130, 16, 8), 'large_d': (1, 3, 640, 65, 448, 1032),
    'ls_roi': (8, 3, 49000, 49, 256, 1024),
    'many_keys': (1, 1, 16, 20000, 32, 8),
}


@pytest.mark.parametrize('name', sorted(ACCEPTED))
def test_bf16_plan_accepts(name):
    g, s, nq, ns, d, c = ACCEPTED[name]
    plan = tca.bf16_plan(s, ns, d, c)
    assert plan.nsp >= ns and plan.nsp % 8 == 0 and plan.nsp - ns < 8
    assert tca.bf16_smem_a(d, plan.qslots, plan.stages_a) \
        <= tca.BF16_SMEM_LIMIT
    assert tca.bf16_smem_b(3) <= tca.BF16_SMEM_LIMIT
    assert plan.stages_a >= 2


def test_bf16_plan_takes_the_deepest_ring_that_fits():
    """Two q slots (the next item's q loads while this one runs) before k
    slots; at the model's D = 256 two q tiles and three k slots."""
    plan = tca.bf16_plan(3, 400, 256, 1024)
    assert (plan.qslots, plan.stages_a) == (2, 3)
    assert tca.bf16_smem_a(256, 2, 4) > tca.BF16_SMEM_LIMIT
    assert tca.bf16_smem_b(4) > tca.BF16_SMEM_LIMIT
    assert tca.bf16_plan(3, 49, 256, 1024).nsp == 56
    small, large = tca.bf16_plan(1, 1, 64, 8), tca.bf16_plan(1, 1, 448, 8)
    assert (small.qslots, small.stages_a) == (2, 4)
    assert (large.qslots, large.stages_a) == (1, 2)


@pytest.mark.parametrize('shape, match', [
    ((3, 10, 8, 64), 'D % 16'),           # the wgmma k-step
    ((3, 10, 24, 64), 'D % 16'),
    ((3, 10, 64, 12), 'C % 8'),            # TMA's 16-byte rows
    ((3, 10, 464, 64), 'shared memory'),   # q tile + two k slots
    ((3, 0, 64, 64), 'Ns >= 1'),
    ((0, 10, 64, 64), 'S >= 1'),
])
def test_bf16_plan_refuses(shape, match):
    with pytest.raises(ValueError, match=match):
        tca.bf16_plan(*shape)
