"""The port's DanaConfig options beyond the main path against the JAX
package on the CPU: product attention and `pos_encoding=False` in the eval
and training forward, `remat_backbone` (TPU.REMAT_BACKBONE) in the
training step, and the public functions no framework calls,
`losses.triplet_loss` and `rpn.iou_anchor_target`.

Weights cross with `from_jax_params`; the trunk has Caffe-magnitude BN
statistics (tests/test_torch_port_model.py).  Tolerances are those of the
main path's tests: heads 1e-4, rois 2e-3 px (float32 sums in another
order through the whole trunk, ROADMAP "Carried findings"), losses 1e-4
relative, updates 1e-3 of each leaf's update norm.
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
from dana_tpu.models import losses as jlosses
from dana_tpu.models import rpn as jrpn
from dana_tpu.models.layers import to_jnp

from dana_tpu_torch.engine.train import Trainer
from dana_tpu_torch.models import dana as tdana
from dana_tpu_torch.models import losses as tlosses
from dana_tpu_torch.models import rpn as trpn
from dana_tpu_torch.utils import config as tcfg
from dana_tpu_torch.utils.weights import from_jax_params, to_jax_params
from test_torch_port_model import SMALL as EVAL_SMALL
from test_torch_port_model import _caffe_like, _leaves
from test_torch_port_train import SMALL as TRAIN_SMALL
from test_torch_port_train import _anchor_draws, _anchors, _batch, _t, \
    jax_step_draws

OPTIONS = {'product': dict(attention_type='product'),
           'no_pe': dict(pos_encoding=False),
           'product_no_pe': dict(attention_type='product',
                                 pos_encoding=False)}


def _configs(small, **fields):
    return (jdana.DanaConfig(use_pallas_attention=False, **small, **fields),
            tdana.DanaConfig(**small, **fields))


@pytest.mark.parametrize('option', list(OPTIONS))
def test_eval_forward_matches_jax(option):
    jconf, tconf = _configs(EVAL_SMALL, **OPTIONS[option])
    params = _caffe_like(jdana.init_params(jconf, seed=3), seed=4)
    model = from_jax_params(params, tconf)
    if tconf.attention_type == 'product':
        assert model.RCNN_rpn.RPN_Conv.weight.shape[1] == tconf.feat_dim
        assert model.rcnn_transform_layer.weight.shape[1] == tconf.feat_dim
    rng = np.random.default_rng(0)
    q = rng.integers(0, 256, (2, 128, 160, 3)).astype(np.uint8)
    sup = rng.normal(0, 50, (2, 2, 224, 224, 3)).astype(np.float32)
    info = np.array([[128, 160, 1.0], [120, 150, 0.9]], np.float32)
    fwd = jax.jit(lambda p, q, i, s: jdana.forward(
        p, jconf, q, i, s, training=False))
    jo = fwd(to_jnp(params), jnp.asarray(q), jnp.asarray(info),
             jnp.asarray(sup))
    with torch.inference_mode():
        to = tdana.forward(model, tconf, torch.from_numpy(q),
                           torch.from_numpy(info),
                           support_ims=torch.from_numpy(sup))
    np.testing.assert_array_equal(to['roi_mask'].numpy(),
                                  np.asarray(jo['roi_mask']))
    np.testing.assert_allclose(to['rois'].numpy(), np.asarray(jo['rois']),
                               rtol=0, atol=2e-3)
    for key in ('cls_prob', 'bbox_pred'):
        np.testing.assert_allclose(to[key].numpy(), np.asarray(jo[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


@pytest.mark.parametrize('option', ['product', 'product_no_pe'])
def test_training_forward_matches_jax(option):
    """The training forward on JAX's draws: the same sampled rois and
    labels, the four losses within 1e-4 relative."""
    jconf, tconf = _configs(TRAIN_SMALL, **OPTIONS[option])
    params = _caffe_like(jdana.init_params(jconf, seed=8), seed=9)
    batch = _batch()
    key = jax.random.PRNGKey(11)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jout = jax.jit(lambda p, b, k: jdana.forward(
        p, jconf, b['im_data'], b['im_info'], b['support_ims'],
        training=True, gt_boxes=b['gt_boxes'], rng=k))(to_jnp(params), jb,
                                                       key)
    n = (128 // 16) * (160 // 16) * tconf.num_anchors
    t = tconf.train_post_nms + batch['gt_boxes'].shape[1]
    draws = jax_step_draws(key, 2, n, t, tconf.rois_per_image)
    model = from_jax_params(params, tconf)
    with torch.no_grad():
        tout = tdana.forward(model, tconf, *(torch.from_numpy(batch[k]) for k
                                             in ('im_data', 'im_info')),
                             support_ims=torch.from_numpy(
                                 batch['support_ims']),
                             training=True,
                             gt_boxes=torch.from_numpy(batch['gt_boxes']),
                             draws=draws)
    np.testing.assert_array_equal(tout['rois_label'].numpy(),
                                  np.asarray(jout['rois_label']))
    np.testing.assert_allclose(tout['rois'].numpy(), np.asarray(jout['rois']),
                               rtol=0, atol=2e-3)
    for name in ('rpn_loss_cls', 'rpn_loss_box', 'rcnn_loss_cls',
                 'rcnn_loss_bbox'):
        np.testing.assert_allclose(tout[name].item(), float(jout[name]),
                                   rtol=1e-4, atol=1e-7, err_msg=name)


@pytest.fixture(scope='module')
def remat_steps():
    """One Trainer step on TRAIN_SMALL's detector with and without
    remat_backbone, on the same weights, batch and JAX's draws; and JAX's
    make_train_step with remat_backbone."""
    jconf, tconf = _configs(TRAIN_SMALL, remat_backbone=True)
    params = _caffe_like(jdana.init_params(jconf, seed=8), seed=9)
    batch = _batch()
    rng = jax.random.PRNGKey(10)
    pj = to_jnp(params)
    mask = joptim.trainable_mask(pj)
    new_state, jm = jtrain.make_train_step(jconf, mask)(
        jtrain.create_train_state(pj, 1e-3),
        {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    key = jax.random.fold_in(rng, 0)
    n = (128 // 16) * (160 // 16) * tconf.num_anchors
    t = tconf.train_post_nms + batch['gt_boxes'].shape[1]
    draws = jax_step_draws(key, 2, n, t, tconf.rois_per_image)
    runs = {}
    for remat in (False, True):
        conf = dataclasses.replace(tconf, remat_backbone=remat)
        trainer = Trainer(params, conf, device='cpu', lr=1e-3)
        calls = []
        real = tdana.checkpoint

        def counted(*a, **kw):
            calls.append(1)
            return real(*a, **kw)
        tdana.checkpoint = counted
        try:
            metrics = trainer.step(batch, draws=draws)
        finally:
            tdana.checkpoint = real
        runs[remat] = dict(
            metrics=metrics, calls=len(calls),
            grads={n: None if p.grad is None else p.grad.clone()
                   for n, p in trainer.model.named_parameters()},
            params=to_jax_params(trainer.model))
    return dict(params=params, mask=mask, jm=jm, runs=runs,
                jparams=jax.tree.map(np.asarray, new_state.params))


def test_remat_step_equals_the_plain_step_bit_for_bit(remat_steps):
    """Recomputing the trunk in the backward changes nothing: losses,
    every gradient and every updated parameter bit for bit; the frozen
    stem and layer1 get no gradient either way; the query and support
    trunks each ran under the checkpoint once."""
    plain, remat = remat_steps['runs'][False], remat_steps['runs'][True]
    assert (plain['calls'], remat['calls']) == (0, 2)
    for k, v in plain['metrics'].items():
        assert torch.equal(v, remat['metrics'][k]), k
    assert plain['grads'].keys() == remat['grads'].keys()
    n_frozen = 0
    for name, g in plain['grads'].items():
        if g is None:
            assert remat['grads'][name] is None, name
            n_frozen += name.startswith(('backbone.conv1', 'backbone.layer1'))
            continue
        assert torch.equal(g, remat['grads'][name]), name
    assert n_frozen > 0
    for k, v in _leaves(plain['params']):
        np.testing.assert_array_equal(v, dict(_leaves(remat['params']))[k],
                                      err_msg=k)


def test_remat_step_matches_jax_remat_step(remat_steps):
    """The port's remat step against JAX's remat step: losses within 1e-4
    relative, each trainable leaf's update within 1e-3 of its norm."""
    jm, tm = remat_steps['jm'], remat_steps['runs'][True]['metrics']
    for name in ('rpn_loss_cls', 'rpn_loss_box', 'rcnn_loss_cls',
                 'rcnn_loss_bbox'):
        np.testing.assert_allclose(tm[name].item(), float(jm[name]),
                                   rtol=1e-4, atol=1e-7, err_msg=name)
    p0 = dict(_leaves(remat_steps['params']))
    pj = dict(_leaves(remat_steps['jparams']))
    pt = dict(_leaves(remat_steps['runs'][True]['params']))
    n_moved = 0
    for k, trainable in _leaves(remat_steps['mask']):
        dj, dt = pj[k] - p0[k], pt[k] - p0[k]
        if not trainable:
            np.testing.assert_array_equal(pt[k], p0[k], err_msg=k)
            continue
        scale = np.linalg.norm(dj)
        if scale < 1e-9:
            continue
        n_moved += 1
        assert np.linalg.norm(dt - dj) <= 1e-3 * scale + 1e-7, k
    assert n_moved > 10


def test_remat_config_key():
    """TPU.REMAT_BACKBONE, False by default, reaches DanaConfig through
    dana_config and the CLIs' --set."""
    from dana_tpu_torch.utils import args as targs
    c = tcfg.default_cfg()
    assert c.TPU.REMAT_BACKBONE is False
    assert not tcfg.dana_config(c, 2, 3).remat_backbone
    c = targs.load_cfg(targs.parse_args(
        ['--dataset', 'synth', '--set', 'TPU.REMAT_BACKBONE', 'True']))
    assert tcfg.dana_config(c, 2, 3).remat_backbone
    with pytest.raises(ValueError, match='attention_type'):
        tdana.DanaConfig(attention_type='sum')


@pytest.mark.parametrize('p,margin', [(2, 1.0), (1, 0.5), (3, 0.2)])
def test_triplet_loss_matches_jax(p, margin):
    rng = np.random.default_rng(p)
    a, pos, neg = (rng.normal(0, 1, (6, 5, 16)).astype(np.float32)
                   for _ in range(3))
    want, jgrads = jax.value_and_grad(
        lambda *x: jlosses.triplet_loss(*x, margin=margin, p=p),
        argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (a, pos, neg)))
    ts = [torch.tensor(x, requires_grad=True) for x in (a, pos, neg)]
    got = tlosses.triplet_loss(*ts, margin=margin, p=p)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    assert 0 < got.item()
    for t, g in zip(ts, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-5,
                                   atol=1e-7)


def test_iou_anchor_target_matches_jax():
    """anchor_target's outputs plus every anchor's best IoU, anchors
    outside the image included."""
    anchors = _anchors(8, 10, scales=(2, 4, 8))
    n = anchors.shape[0]
    gt = np.zeros((2, 4, 5), np.float32)
    gt[0, :2] = [[10, 10, 60, 50, 1], [70, 40, 150, 120, 1]]
    gt[1, :1] = [[0, 0, 30, 20, 1]]
    info = np.array([[128, 160, 1], [60, 70, 1]], np.float32)
    key = jax.random.PRNGKey(5)
    kw = dict(batch_rois=16, fg_fraction=0.5)
    want = jrpn.iou_anchor_target(jnp.asarray(anchors), jnp.asarray(gt),
                                  jnp.asarray(info), key, **kw)
    u_fg, u_bg = _anchor_draws(key, 2, n)
    got = trpn.iou_anchor_target(_t(anchors), _t(gt), _t(info), _t(u_fg),
                                 _t(u_bg), **kw)
    assert len(got) == len(want) == 5
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for a, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    outside = (anchors[:, 2] >= 70) | (anchors[:, 3] >= 60)
    assert (got[4][1].numpy()[outside] > 0).any()
