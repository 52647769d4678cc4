"""Why the CISA kernel (dana_tpu_torch/ops/csrc/cisa_shots.cu) splits each
float32 operand into two TF32 parts.

The kernel runs both of its products on the tensor cores, whose .tf32
operands keep 10 mantissa bits.  This test emulates that in numpy: TF32
rounding to nearest with ties away on the bit pattern (as `cvt.rna.tf32.f32`
rounds), exact products, sums in float64 rounded to float32.  It runs the
CISA math at a small RPN-like shape with one TF32 pass and with the 3xTF32
split (big = tf32(x), small = tf32(x - big); a*b = a_small*b_big +
a_big*b_small + a_big*b_big), against float64: the split keeps float32
accuracy, one pass loses three orders of magnitude.  Test-only code: the
package does not use it.
"""

import numpy as np
import pytest


def tf32(x):
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def mm_one_pass(a, b):
    return (tf32(a).astype(np.float64) @ tf32(b).astype(np.float64)).astype(
        np.float32)


def mm_3xtf32(a, b):
    ab, bb = tf32(a), tf32(b)
    as_, bs = tf32(a - ab), tf32(b - bb)
    ab, bb, as_, bs = (x.astype(np.float64) for x in (ab, bb, as_, bs))
    return (as_ @ bb + ab @ bs + ab @ bb).astype(np.float32)


def cisa(q, k, v, u, scale, gamma, mm):
    """mean_s (softmax(scale q k_s^T) + gamma u_s) @ v_s, softmax in the
    working type; q [Nq,D], k [S,Ns,D], v [S,Ns,C], u [S,Ns]."""
    dt = np.float64 if mm is None else np.float32
    mm = mm or np.matmul
    out = 0
    for s in range(k.shape[0]):
        scores = mm(q, k[s].T).astype(dt) * dt(scale)
        e = np.exp(scores - scores.max(-1, keepdims=True))
        probs = (e / e.sum(-1, keepdims=True) + dt(gamma) * u[s]).astype(dt)
        out = out + mm(probs, v[s]).astype(dt)
    return out / k.shape[0]


@pytest.mark.parametrize('site', [
    (3, 400, 256, 64, 64),      # RPN-like: S, Ns, D, Nq, C
    (3, 49, 256, 64, 64),       # RoI-like
])
def test_3xtf32_keeps_float32_accuracy_one_pass_does_not(site):
    s, ns, d, nq, c = site
    rng = np.random.default_rng(0)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    k = rng.standard_normal((s, ns, d)).astype(np.float32)
    v = rng.standard_normal((s, ns, c)).astype(np.float32)
    logits = rng.standard_normal((s, ns))
    u = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(
        np.float32)
    args = (q, k, v, u, 1 / 16, 0.1)
    want = cisa(*(x.astype(np.float64) for x in args[:4]), *args[4:], None)
    err3 = np.abs(cisa(*args, mm_3xtf32) - want).max()
    err1 = np.abs(cisa(*args, mm_one_pass) - want).max()
    assert err3 <= 1e-6, err3
    assert err1 >= 100 * err3, (err1, err3)


def test_tf32_rounding_is_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)       # TF32's unit in the last place at 1
    x = np.array([one + ulp / 2, one + ulp * np.float32(0.49),
                  -(one + ulp / 2), one + ulp * np.float32(1.5)], np.float32)
    np.testing.assert_array_equal(
        tf32(x), np.array([one + ulp, one, -(one + ulp), one + 2 * ulp],
                          np.float32))
    # the split is exact: x = big + small, with small within half a TF32 ulp
    big = tf32(x)
    assert np.all(np.abs(x - big) <= np.abs(big) * 2.0 ** -11)
