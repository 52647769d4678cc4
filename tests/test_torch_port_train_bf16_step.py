"""Whole training steps of the precision recipe on the port against the JAX
package's `make_train_step` on the CPU: DAnA in the default recipe (bf16
trunk and attention, float32 heads) and in pure bf16, and FGN in pure bf16
with its head BatchNorms on batch statistics.

The bf16 trunks of the two packages are not bit-equal (XLA keeps a fusion's
bf16 intermediates unrounded, torch rounds after each op; JAX on the CPU
also sums the support AvgPool in bf16), so their RPN scores differ in the
last bits and the proposals would reorder.  Every step here, JAX's and the
port's, bf16 and float32, takes the proposals of JAX's float32 step
(patched into both packages' proposal layers) and JAX's draws
(tests/test_torch_port_train.py `jax_step_draws`): the target layers must
then sample the same rois.  The port's bf16 step is held to JAX's float32
step as JAX's own bf16 step is: for each loss and each trainable leaf's
momentum buffer (the update before the lr),

    |port bf16 - JAX f32| <= 2 |JAX bf16 - JAX f32| + floor,

with LOSS_FLOOR absolute plus LOSS_FLOOR of the float32 loss for a loss
and UPDATE_FLOOR of the leaf's float32 norm for an update (one bf16 ulp is
2**-7 = 7.8e-3: where JAX's deviation happens to be near 0, the port's may
still be an ulp).  Leaves whose
gradient is zero by construction (the centred q and k projections' and the
unary layers' biases) are bf16 rounding noise in both packages and are
held only to be small.  Frozen leaves stay bit-equal; FGN's running
statistics move as JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dana_tpu.engine import optim as joptim
from dana_tpu.engine import train as jtrain
from dana_tpu.models import dana as jdana
from dana_tpu.models import rpn as jrpn
from dana_tpu.models.layers import to_jnp

from dana_tpu_torch.engine.train import Trainer
from dana_tpu_torch.models import frameworks as tfw
from dana_tpu_torch.models import resnet as tresnet
from dana_tpu_torch.models import rpn as trpn
from dana_tpu_torch.utils.weights import to_jax_params
from test_torch_port_frameworks import _pinned, jax_model, port_config
from test_torch_port_frameworks_train import _batch as fw_batch
from test_torch_port_frameworks_train import _unit_stats
from test_torch_port_model import _caffe_like, _leaves
from test_torch_port_train import SMALL, _batch, jax_step_draws

LOSSES = ('rpn_loss_cls', 'rpn_loss_box', 'rcnn_loss_cls', 'rcnn_loss_bbox')
LOSS_FLOOR = 1e-2
UPDATE_FLOOR = 2e-2
NO_GRAD_RTOL = 5e-2       # of the largest float32 buffer norm of the step
# case -> (framework, the recipe's JAX DanaConfig dtypes)
CASES = {
    'default_recipe': ('DAnA', dict(compute_dtype=jnp.bfloat16,
                                    head_dtype=jnp.float32)),
    'pure_bf16': ('DAnA', dict(compute_dtype=jnp.bfloat16,
                               head_dtype=None)),
    'fgn_pure_bf16': ('fgn', dict(compute_dtype=jnp.bfloat16,
                                  head_dtype=None)),
}


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    """Two intra-op threads (the suite runs six test processes at once)."""
    was = torch.get_num_threads()
    torch.set_num_threads(min(2, was))
    yield
    torch.set_num_threads(was)


def _torch_dtype(dt):
    return None if dt is None else getattr(torch, jnp.dtype(dt).name)


def _model(name):
    """-> (JAX float32 config, numpy param tree, batch) of `name`: DAnA at
    tests/test_torch_port_train.py's SMALL sizes, FGN at the sibling
    tests' with its head BatchNorms on batch statistics (unit-scale trunk
    statistics, test_torch_port_frameworks_train.py `_unit_stats`)."""
    if name == 'DAnA':
        jconf = jdana.DanaConfig(use_pallas_attention=False, **SMALL)
        return (jconf, _caffe_like(jdana.init_params(jconf, seed=8), seed=9),
                _batch())
    jconf, params = jax_model('fgn', seed=8)
    params = _caffe_like(params, seed=9)
    _unit_stats(params)
    jconf = dataclasses.replace(jconf, bn_train=True)
    return jconf, params, fw_batch(jconf.n_way * jconf.n_shot)


def _jax_step(name, jconf, params, batch, pinned=None):
    """One JAX make_train_step; the proposal layer's rois and mask, and the
    sampled labels, are recorded from inside the jitted step, and with
    `pinned` (a record) its proposals replace the layer's own.  -> (new
    params, new velocity, metrics, record)."""
    rec = {}
    real_layer, real_target = jrpn.proposal_layer, jrpn.proposal_target

    def layer(*args, **kwargs):
        out = real_layer(*args, **kwargs)
        if pinned is not None:
            out = (jnp.asarray(pinned['rois']), out[1],
                   jnp.asarray(pinned['mask']))
        jax.debug.callback(lambda r, m: rec.update(rois=np.asarray(r),
                                                   mask=np.asarray(m)),
                           out[0], out[2])
        return out

    def target(*args, **kwargs):
        out = real_target(*args, **kwargs)
        jax.debug.callback(lambda lab: rec.update(labels=np.asarray(lab)),
                           out[1])
        return out

    pj = to_jnp(params)
    mask = joptim.trainable_mask(pj)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jrpn.proposal_layer, jrpn.proposal_target = layer, target
    try:
        state, metrics = jtrain.make_train_step(jconf, mask, model=name)(
            jtrain.create_train_state(pj, 1e-3), jb, jax.random.PRNGKey(10))
        jax.effects_barrier()
    finally:
        jrpn.proposal_layer, jrpn.proposal_target = real_layer, real_target
    return (dict(_leaves(jax.tree.map(np.asarray, state.params))),
            dict(_leaves(jax.tree.map(np.asarray, state.opt.velocity))),
            {k: float(v) for k, v in metrics.items()}, rec, mask)


@pytest.fixture(scope='module')
def float32_steps():
    """JAX's float32 step of each framework, whose proposals every other
    step of that framework takes."""
    out = {}
    for name in {n for n, _ in CASES.values()}:
        jconf, params, batch = _model(name)
        out[name] = (jconf, params, batch,
                     _jax_step(name, jconf, params, batch))
    return out


@pytest.fixture(scope='module', params=list(CASES))
def bf16_step(request, float32_steps):
    """JAX's bf16 step and the port's Trainer.step in the case's recipe,
    both on the float32 step's proposals and JAX's draws."""
    name, dtypes = CASES[request.param]
    jconf, params, batch, f32 = float32_steps[name]
    pinned = f32[3]
    jrec = dataclasses.replace(jconf, **dtypes)
    j16 = _jax_step(name, jrec, params, batch, pinned)

    tconf = (port_config('fgn', bn_train=True) if name == 'fgn'
             else tfw.dana.DanaConfig(**SMALL))
    tconf = dataclasses.replace(
        tconf, **{k: _torch_dtype(v) for k, v in dtypes.items()})
    trainer = Trainer(params, tconf, device='cpu', lr=1e-3)
    with torch.no_grad():
        feat = tresnet.base_forward(torch.from_numpy(batch['im_data']),
                                    trainer.model.backbone)
    key = jax.random.fold_in(jax.random.PRNGKey(10), 0)
    draws = jax_step_draws(key, 2, feat.shape[1] * feat.shape[2]
                           * tconf.num_anchors,
                           tconf.train_post_nms + batch['gt_boxes'].shape[1],
                           tconf.rois_per_image)
    labels = {}
    real = trpn.proposal_target

    def target(*args, **kwargs):
        out = real(*args, **kwargs)
        labels['labels'] = out[1].numpy()
        return out
    trpn.proposal_target = target
    try:
        with _pinned(torch.from_numpy(pinned['rois']),
                     torch.from_numpy(pinned['mask'])):
            tm = trainer.step(batch, draws=draws)
    finally:
        trpn.proposal_target = real
    tvel = {}
    for n, p in trainer.model.named_parameters():
        if p.requires_grad:
            v = trainer.optimizer.state[p]['momentum_buffer'].numpy()
            tvel[n] = v.transpose(2, 3, 1, 0) if v.ndim == 4 else \
                (v.T if v.ndim == 2 else v)
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    return dict(case=request.param, params=dict(_leaves(params)), f32=f32,
                j16=j16, tm={k: float(v) for k, v in tm.items()},
                tlabels=labels['labels'], tvel=tvel,
                tparams=dict(_leaves(to_jax_params(trainer.model))))


def test_bf16_step_samples_the_same_rois(bf16_step):
    """On the float32 step's proposals and JAX's draws, the port's bf16 step
    samples the labels of both JAX steps, fg rois among them."""
    f32, j16 = bf16_step['f32'][3], bf16_step['j16'][3]
    np.testing.assert_array_equal(bf16_step['tlabels'], j16['labels'])
    np.testing.assert_array_equal(j16['labels'], f32['labels'])
    np.testing.assert_array_equal(j16['rois'], f32['rois'])
    assert (f32['labels'] > 0).any()


def test_bf16_step_losses_within_twice_jax_deviation(bf16_step):
    f32, j16, tm = bf16_step['f32'][2], bf16_step['j16'][2], bf16_step['tm']
    assert tm['skipped'] == j16['skipped'] == 0.0
    for k in LOSSES:
        dev_j, dev_t = abs(j16[k] - f32[k]), abs(tm[k] - f32[k])
        print(f'{bf16_step["case"]} {k}: float32 {f32[k]:.6f}, JAX bf16 '
              f'{dev_j:.3e} from it, port bf16 {dev_t:.3e}')
        floor = LOSS_FLOOR * (1 + abs(f32[k]))
        assert np.isfinite(tm[k]) and dev_t <= 2 * dev_j + floor, k


def test_bf16_step_updates_within_twice_jax_deviation(bf16_step):
    """Each trainable leaf's momentum buffer after the step (float32 in
    both packages) within twice JAX's own bf16 deviation from its float32
    step plus UPDATE_FLOOR of its norm; the parameters stay float32 and
    frozen ones bit-equal; FGN's running statistics within the same bound
    as an update."""
    p0, case = bf16_step['params'], bf16_step['case']
    pj32, vj32, _, _, mask = bf16_step['f32']
    pj16, vj16 = bf16_step['j16'][:2]
    pt, vt = bf16_step['tparams'], bf16_step['tvel']
    trainable = dict(_leaves(mask))
    scale = max(np.linalg.norm(v) for v in vj32.values())
    worst, n_held, bad = (-np.inf, ''), 0, []
    for k, t in trainable.items():
        if k.endswith(('running_mean', 'running_var')):
            if k.startswith('backbone.'):
                np.testing.assert_array_equal(pt[k], p0[k], err_msg=k)
                continue
            a, b, c = pt[k], pj16[k], pj32[k]        # FGN's head BN stats
        elif not t:
            np.testing.assert_array_equal(pt[k], p0[k], err_msg=k)
            assert k not in vt, k
            continue
        else:
            a, b, c = vt[k], vj16[k], vj32[k]
        assert a.dtype == np.float32 and np.isfinite(a).all(), k
        norm = np.linalg.norm(c)
        dev_j, dev_t = np.linalg.norm(b - c), np.linalg.norm(a - c)
        if norm < 1e-6:          # no gradient by construction: noise
            assert dev_t <= NO_GRAD_RTOL * scale, k
            continue
        n_held += 1
        worst = max(worst, ((dev_t - 2 * dev_j) / norm, k))
        if not dev_t <= 2 * dev_j + UPDATE_FLOOR * norm:
            bad.append(f'{k}: port {dev_t / norm:.3e}, JAX '
                       f'{dev_j / norm:.3e} of the float32 norm')
    print(f'{case}: {n_held} leaves held; worst (port - 2 JAX) deviation '
          f'{worst[0]:.3e} of the float32 norm, at {worst[1]}')
    assert not bad, bad
    assert n_held > 50
