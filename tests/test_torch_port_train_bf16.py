"""The precision recipe in training on the port, against the JAX package on
the CPU: the bf16 RoIAlign of the training step (forward and backward),
the CISA backward in bf16, FGN's batch-statistics BatchNorm in bf16, the
losses on bf16 predictions, RoIPool and the crop on a bf16 map, and the
training entry points under TPU.COMPUTE_DTYPE bfloat16.

Inputs come from numpy seeds; a bf16 input is rounded once, by torch, and
handed to JAX as the same bf16 values.  JAX runs op by op
(`jax.disable_jit`) where the port is held bit for bit: under jit XLA
turns a division by a constant into a product with its reciprocal (ROADMAP
Queue C, C3) and keeps bf16 intermediates of a fusion unrounded, and the
port rounds as the ops do.  Tolerances, each with its measured value
printed:
  * RoIAlign in bf16, forward and backward: bit for bit.  The backward is
    the VJP of JAX's combine path, bf16(sum bf16(Wy * Wx) * g) with float32
    sums, rounded once;
  * the CISA backward in bf16: one bf16 ulp of each gradient's scale,
    2**-7 * max|JAX| (the recompute's float32 sums run in another order);
  * BatchNorm with batch statistics in bf16: the output within one bf16
    ulp of its scale, the float32 running statistics within 1e-6
    relative;
  * the losses on bf16 predictions: equal to JAX's losses on the same
    values cast to float32 (every JAX call site casts), 1e-6 relative;
  * RoIPool: forward bit for bit, the gradient within one bf16 ulp of its
    scale; the crop: float32 output (JAX's promotion) within CROP_TOL of
    its scale, the bf16 gradient within BF16_GRAD_ULPS bf16 ulps of its
    scale (JAX and torch scatter the corners' shares in bf16, each in its
    own order).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dana_tpu.models import layers as jlayers
from dana_tpu.models import losses as jlosses
from dana_tpu.ops import cisa_attention as jca

from dana_tpu_torch.models import layers as tlayers
from dana_tpu_torch.models import losses as tlosses
from dana_tpu_torch.ops import cisa_attention as tca
from dana_tpu_torch.ops import grid_sample as tgs
from dana_tpu_torch.ops import roi_align as tra
from dana_tpu_torch.ops import roi_pool as trp

# dana_tpu.ops re-exports the functions under the modules' names
jra = importlib.import_module('dana_tpu.ops.roi_align')
jrp = importlib.import_module('dana_tpu.ops.roi_pool')
jgs = importlib.import_module('dana_tpu.ops.grid_sample')

BF16 = torch.bfloat16
ULP = 2.0 ** -7          # one bf16 ulp, relative to a tensor's scale
CROP_TOL = 1e-5          # tests/test_torch_port_pooling.py's
BF16_GRAD_ULPS = 2


def _bf16(x):
    """numpy -> (torch bf16, the same values as a JAX bf16 array)."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(BF16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _within(name, got, want, ulps=1.0):
    got, want = _np(got), _np(want)
    err, tol = np.abs(got - want).max(), ulps * ULP * np.abs(want).max()
    print(f'{name}: max |port - JAX| {err:.3e}, tolerance {tol:.3e}')
    assert err <= tol


def _equal(name, got, want):
    got, want = _np(got), _np(want)
    print(f'{name}: max |port - JAX| {np.abs(got - want).max():.3e} '
          '(bit for bit)')
    np.testing.assert_array_equal(got, want, err_msg=name)


# ------------------------------------------------------------- RoIAlign

def _roi_case(seed, h, w, c, r=13):
    """A bf16 map [2, h, w, c] and bf16-rounded rois [2, 4 + r, 5] on its
    (16 h) x (16 w) image: outside the map, across its corner, tiny, the
    whole map, then random ones."""
    rng = np.random.default_rng(seed)
    feat = _bf16(rng.normal(size=(2, h, w, c)))
    edge = np.array([[0, -300, -200, -40, -20], [0, -40, -30, 60, 50],
                     [0, 30, 30, 30.4, 30.2], [0, 0, 0, 16 * w - 1,
                                               16 * h - 1]])
    xy = rng.random((2, r, 2)) * 16 * np.array([w, h]) - 10
    wh = rng.random((2, r, 2)) * 16 * np.array([w, h]) / 2 + 2
    boxes = np.concatenate([np.zeros((2, r, 1)), xy, xy + wh], -1)
    rois = _bf16(np.concatenate([np.broadcast_to(edge, (2, 4, 5)), boxes],
                                1))
    cot = _bf16(rng.normal(size=(2, 4 + r, 7, 7, c)))
    return feat, rois, cot


@pytest.mark.parametrize('shape', [(10, 12, 24), (19, 32, 16)],
                         ids=['10x12', '19x32'])
def test_roi_align_train_bf16_matches_jax(shape):
    """`roi_align_train` on a bf16 map, the training step's RoIAlign in the
    recipe: its forward (K2-bf16's plain version here) and its backward
    (`roi_align_combine_backward`) equal JAX's roi_align and its VJP op by
    op, bit for bit, a roi outside the map (zero rows, zero gradient) and
    one over the whole map included."""
    (feat, jfeat), (rois, jrois), (cot, jcot) = _roi_case(0, *shape)
    with jax.disable_jit():
        want, vjp = jax.vjp(lambda f: jra.roi_align(f, jrois, 7, 1 / 16.0, 0),
                            jfeat)
        jgrad, = vjp(jcot)
    x = feat.clone().requires_grad_()
    got = tra.roi_align_train(x, rois, 7, 1 / 16.0)
    got.backward(cot)
    assert got.dtype == x.grad.dtype == BF16
    assert jgrad.dtype == jnp.bfloat16
    _equal('roi_align_train bf16 forward', got, want)
    _equal('roi_align_train bf16 backward', x.grad, jgrad)
    assert not got[:, 0].any() and x.grad.any()


def test_roi_align_combine_backward_is_the_plain_vjp():
    """`roi_align_combine_backward` is autograd's VJP of
    `roi_align_combine_plain` (float32 sums, one rounding), bit for bit,
    and the formula bf16(sum bf16(Wy * Wx) * g) summed in float64."""
    (feat, _), (rois, _), (cot, _) = _roi_case(1, 10, 12, 8)
    wy, wx = tra.roi_weights(rois, 10, 12)
    x = feat.clone().requires_grad_()
    tra.roi_align_combine_plain(x, wy, wx).backward(cot)
    got = tra.roi_align_combine_backward(cot, wy, wx)
    assert torch.equal(got, x.grad)
    comb = torch.einsum('brph,brqw->brpqhw', wy, wx).to(BF16).double()
    f64 = torch.einsum('brpqhw,brpqc->bhwc', comb, cot.double())
    _within('combine backward against float64 sums', got, f64.to(BF16),
            ulps=1.0)


# ----------------------------------------------------------------- CISA

@pytest.mark.parametrize('site', ['rpn', 'roi'])
def test_cisa_bf16_backward_matches_jax_vjp(site):
    """The CISA core's backward in bf16 (the plain recompute's VJP) against
    JAX's `_bwd_shots`, the VJP of `cisa_attention_shots_xla`, at small
    forms of the training step's two sites (RPN: a map's tokens against
    3 x 400 support tokens; RoI: rois x 49 bins against 3 x 49), for q, k,
    v and the unary weights; the Function saves bf16 tensors only."""
    g, nq, ns = {'rpn': (2, 80, 400), 'roi': (2, 8 * 49, 49)}[site]
    rng = np.random.default_rng(2)
    q, jq = _bf16(rng.normal(size=(g, nq, 64)))
    k, jk = _bf16(rng.normal(size=(g, 3, ns, 64)))
    v, jv = _bf16(rng.normal(size=(g, 3, ns, 96)))
    u0 = rng.normal(size=(g, 3, ns))
    u, ju = _bf16(np.exp(u0) / np.exp(u0).sum(-1, keepdims=True))
    cot, jcot = _bf16(rng.normal(size=(g, nq, 96)))
    want, vjp = jax.vjp(
        lambda *a: jca.cisa_attention_shots_xla(*a, 0.125, 0.1),
        jq, jk, jv, ju)
    jgrads = vjp(jcot)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, u)]
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t.dtype) or t, lambda t: t):
        out = tca.cisa_attention_shots(*leaves, 0.125, 0.1)
    assert saved and set(saved) == {BF16}
    out.backward(cot)
    _within(f'cisa bf16 [{site}] forward', out, want)
    for name, leaf, jg in zip('qkvu', leaves, jgrads):
        assert leaf.grad.dtype == BF16 and jg.dtype == jnp.bfloat16
        _within(f'cisa bf16 [{site}] d{name}', leaf.grad, jg)


# ----------------------------------------------------------- BatchNorm

def test_batchnorm_batch_stats_bf16_matches_jax():
    """FGN's head BatchNorm with batch statistics on a bf16 map: the
    statistics formed in float32 and the output cast back to bf16, as JAX's
    `batchnorm_train`; the float32 running statistics move as JAX's."""
    rng = np.random.default_rng(3)
    x, jx = _bf16(rng.normal(2.0, 3.0, (6, 5, 5, 8)))           # NHWC
    params = {'weight': rng.normal(1, 0.2, 8).astype(np.float32),
              'bias': rng.normal(0, 0.2, 8).astype(np.float32),
              'running_mean': rng.normal(0, 1, 8).astype(np.float32),
              'running_var': rng.uniform(0.5, 2, 8).astype(np.float32)}
    with jax.disable_jit():
        want, stats = jlayers.batchnorm_train(
            jx, {k: jnp.asarray(v) for k, v in params.items()})
    bn = tlayers.BatchNorm2d(8)
    with torch.no_grad():
        for k, v in params.items():
            getattr(bn, k).copy_(torch.from_numpy(v))
    got = bn(tlayers.nhwc_to_nchw(x), batch_stats=True)
    assert got.dtype == BF16 and bn.running_mean.dtype == torch.float32
    _within('batchnorm bf16', tlayers.nchw_to_nhwc(got), want)
    for k in ('running_mean', 'running_var'):
        np.testing.assert_allclose(getattr(bn, k).numpy(),
                                   np.asarray(stats[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


# --------------------------------------------------------------- losses

def _loss_inputs():
    rng = np.random.default_rng(4)
    return dict(
        deltas=_bf16(rng.normal(0, 1, (2, 50, 4))),
        targets=rng.normal(0, 1, (2, 50, 4)).astype(np.float32),
        in_w=(rng.random((2, 50, 1)) > 0.5).astype(np.float32),
        out_w=rng.random((2, 50, 1)).astype(np.float32),
        logits=_bf16(rng.normal(0, 3, (2, 40, 2))),
        labels=rng.integers(-1, 2, (2, 40)).astype(np.int32),
        neg=_bf16(rng.normal(0, 3, (2, 40, 2))))


@pytest.mark.parametrize('loss', ['smooth_l1', 'masked_ce', 'pair_ce'])
def test_losses_on_bf16_match_jax(loss):
    """The port's losses on bf16 predictions: float32 losses equal to JAX's
    on the same values cast to float32, as every JAX call site casts
    (dana_tpu/models/dana.py, frameworks.py), with bf16 gradients."""
    a = _loss_inputs()
    f32 = {k: jnp.asarray(v[1], jnp.float32) for k, v in a.items()
           if isinstance(v, tuple)}
    t = {k: v[0].clone().requires_grad_() for k, v in a.items()
         if isinstance(v, tuple)}
    np_ = {k: torch.from_numpy(v) for k, v in a.items()
           if not isinstance(v, tuple)}
    if loss == 'smooth_l1':
        want = jlosses.smooth_l1_loss(f32['deltas'], a['targets'], a['in_w'],
                                      a['out_w'], sigma=3.0)
        got = tlosses.smooth_l1_loss(t['deltas'], np_['targets'],
                                     np_['in_w'], np_['out_w'], sigma=3.0)
        leaf = t['deltas']
    elif loss == 'masked_ce':
        mask = a['labels'] != -1
        want = jlosses.masked_cross_entropy(f32['logits'], a['labels'], mask)
        got = tlosses.masked_cross_entropy(t['logits'], np_['labels'],
                                           torch.from_numpy(mask))
        leaf = t['logits']
    else:
        labels = np.maximum(a['labels'], 0)
        want = jlosses.hard_mined_pair_ce(f32['logits'], labels, f32['neg'])
        got = tlosses.hard_mined_pair_ce(t['logits'],
                                         torch.from_numpy(labels), t['neg'])
        leaf = t['logits']
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    got.backward()
    assert leaf.grad.dtype == BF16 and leaf.grad.any()


# ----------------------------------------------------- RoIPool and crop

def _pool_case(seed):
    """A bf16 ReLU'd map with a block of zeros (ties) and bf16 rois, as the
    model hands them (tests/test_torch_port_pooling.py's edge cases)."""
    from test_torch_port_pooling import _map, _rois
    feat, rois = _map(seed), _rois(seed)
    cot = np.random.default_rng(seed).normal(0, 1, (2, 32, 7, 7, 8))
    return _bf16(feat), _bf16(rois), cot


@pytest.mark.parametrize('seed', [0, 1])
def test_roi_pool_bf16_matches_jax(seed):
    """RoIPool on a bf16 map: the maxes in float32, a bf16 result equal to
    JAX's bit for bit; the bf16 gradient (ties split in float32, rounded
    once) within one bf16 ulp of its scale."""
    (feat, jfeat), (rois, jrois), cot = _pool_case(seed)
    (tcot, jcot) = _bf16(cot)
    with jax.disable_jit():
        want, vjp = jax.vjp(lambda f: jrp.roi_pool(f, jrois), jfeat)
        jgrad, = vjp(jcot)
    x = feat.clone().requires_grad_()
    got = trp.roi_pool(x, rois)
    got.backward(tcot)
    assert got.dtype == x.grad.dtype == BF16 and want.dtype == jnp.bfloat16
    _equal('roi_pool bf16 forward', got, want)
    _within('roi_pool bf16 gradient', x.grad, jgrad)


@pytest.mark.parametrize('seed', [0, 1])
def test_roi_crop_pool_bf16_matches_jax(seed):
    """The crop on a bf16 map with bf16 rois: theta in bf16, the affine
    grid and the lerp in float32, so the result is float32 as JAX's
    promotion makes it, within CROP_TOL of JAX's; the bf16 gradient within
    BF16_GRAD_ULPS bf16 ulps of its scale."""
    (feat, jfeat), (rois, jrois), cot = _pool_case(seed)
    feat[:, 6:9, 9:13] = 0.0        # exact ties only (the pooling tests)
    jfeat = jnp.asarray(feat.float().numpy(), jnp.bfloat16)
    tcot = torch.from_numpy(cot.astype(np.float32))
    with jax.disable_jit():
        want, vjp = jax.vjp(lambda f: jgs.roi_crop_pool(f, jrois), jfeat)
        jgrad, = vjp(jnp.asarray(tcot.numpy()))
    x = feat.clone().requires_grad_()
    got = tgs.roi_crop_pool(x, rois)
    got.backward(tcot)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert x.grad.dtype == BF16 and jgrad.dtype == jnp.bfloat16
    err = np.abs(_np(got) - _np(want)).max()
    print(f'roi_crop_pool bf16 forward: max |port - JAX| {err:.3e}')
    assert err <= CROP_TOL * np.abs(_np(want)).max()
    _within('roi_crop_pool bf16 gradient', x.grad, jgrad,
            ulps=BF16_GRAD_ULPS)


# ------------------------------------------------------------- Trainer

def test_recipe_nonfinite_step_is_skipped():
    """In the default recipe as in float32 (tests/test_torch_port_train.py):
    a NaN query changes no parameter and no momentum and reports skipped =
    1; a clean batch then trains, the parameters and momentum float32."""
    from dana_tpu_torch.engine.train import Trainer
    from dana_tpu_torch.models import dana as tdana
    from test_torch_port_train import SMALL, _batch
    conf = tdana.DanaConfig(**SMALL, compute_dtype=BF16,
                            head_dtype=torch.float32)
    trainer = Trainer(tdana.init_params(conf, seed=0), conf, device='cpu')
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    m = trainer.step(_batch(nan=True))
    assert m['skipped'].item() == 1.0 and not trainer.optimizer.state
    assert all(torch.equal(v, before[k])
               for k, v in trainer.model.state_dict().items())
    m = trainer.step(_batch())
    assert m['skipped'].item() == 0.0 and torch.isfinite(m['loss'])
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    assert all(s['momentum_buffer'].dtype == torch.float32
               for s in trainer.optimizer.state.values())
