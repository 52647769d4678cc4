"""One training step of DAnA on VGG16, and on ResNet-50 with POOLING_MODE
pool and crop, on the port against the JAX package's `make_train_step` on
the CPU, with JAX's draws and proposals handed to the port (as
tests/test_torch_port_frameworks_train.py does for the siblings).

Sizes are tests/test_models_smoke.py's COMMON (full width, 128x160
queries, 2-way 2-shot 320 px supports, 16 rois an image), with the weights
of tests/test_torch_port_backbones_slice.py.  The gradients reach the trunk
through RoIPool's two-stage max (ties split evenly at each stage, as in
JAX), the crop's bilinear samples and 2 x 2 max, or VGG16's fc6 / fc7 and
its convolutions, all of which train (the JAX package's trainable_mask
freezes nothing of a VGG trunk).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dana_tpu.engine import optim as joptim
from dana_tpu.engine import train as jtrain
from dana_tpu.models.layers import to_jnp

from dana_tpu_torch.engine.train import Trainer
from dana_tpu_torch.models import frameworks as tfw
from dana_tpu_torch.utils.weights import to_jax_params
from test_torch_port_backbones_slice import (  # noqa: F401 (a fixture)
    configs, cpu_convs, jax_params)
from test_torch_port_frameworks import _pinned
from test_torch_port_frameworks_train import (FLIP_RTOL, LOSSES, NOISE,
                                              UPDATE_RTOL, _batch,
                                              _jax_forward)
from test_torch_port_model import _leaves
from test_torch_port_train import jax_step_draws

CASES = ['vgg16', 'pool', 'crop']


@pytest.fixture(scope='module', params=CASES)
def one_step(request):
    case = request.param
    jconf, tconf = configs(case)
    params = jax_params(case, jconf, seed=8)
    batch = _batch(jconf.n_way * jconf.n_shot)
    pj = to_jnp(params)
    mask = joptim.trainable_mask(pj)
    rng = jax.random.PRNGKey(10)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    new_state, jm = jtrain.make_train_step(jconf, mask, model='DAnA')(
        jtrain.create_train_state(pj, 1e-3), jb, rng)
    key = jax.random.fold_in(rng, 0)
    jout = _jax_forward('DAnA', jconf)(pj, jb, key)

    trainer = Trainer(params, tconf, device='cpu', lr=1e-3)
    with torch.no_grad():
        feat = trainer.model.backbone.base(
            torch.from_numpy(batch['im_data']))
    fh, fw = feat.shape[1:3]
    draws = jax_step_draws(key, 2, fh * fw * tconf.num_anchors,
                           tconf.train_post_nms + batch['gt_boxes'].shape[1],
                           tconf.rois_per_image)
    captured = {}
    real = tfw.forward

    def capture(*a, **kw):
        captured.update(real(*a, **kw))
        return captured
    tfw.forward = capture
    proposals = (torch.from_numpy(np.array(jout[k]))
                 for k in ('proposals', 'proposal_mask'))
    try:
        with _pinned(*proposals):
            tm = trainer.step(batch, draws=draws)
    finally:
        tfw.forward = real
    tvel = {}
    for n, p in trainer.model.named_parameters():
        if p.requires_grad:
            v = trainer.optimizer.state[p]['momentum_buffer'].numpy()
            tvel[n] = v.transpose(2, 3, 1, 0) if v.ndim == 4 else \
                (v.T if v.ndim == 2 else v)
    return dict(case=case, params=params, mask=mask, jm=jm,
                jout=jax.tree.map(np.asarray, jout),
                jparams=jax.tree.map(np.asarray, new_state.params),
                jvel=jax.tree.map(np.asarray, new_state.opt.velocity),
                tm=tm, tout=captured, tvel=tvel,
                tparams=to_jax_params(trainer.model))


def test_step_samples_the_same_rois(one_step):
    jout, tout = one_step['jout'], one_step['tout']
    np.testing.assert_array_equal(tout['rois_label'].numpy(),
                                  jout['rois_label'])
    np.testing.assert_allclose(tout['rois'].detach().numpy(), jout['rois'],
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize('loss', LOSSES)
def test_step_losses_match_jax(one_step, loss):
    got, want = one_step['tm'][loss].item(), float(one_step['jm'][loss])
    assert one_step['tm']['skipped'].item() == 0.0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)


def test_step_updates_match_jax(one_step):
    """As tests/test_torch_port_frameworks_train.py's: per trainable leaf
    |dport - djax| <= UPDATE_RTOL |djax| for the momentum buffers
    (FLIP_RTOL for the trunk's, behind ReLUs whose inputs can sit at the
    packages' float32 distance from 0) and that plus one ulp of the new
    value for the parameters; frozen leaves bit-equal to the start; on
    VGG16 the whole trunk moves."""
    p0 = dict(_leaves(one_step['params']))
    pj = dict(_leaves(one_step['jparams']))
    pt = dict(_leaves(one_step['tparams']))
    vj = dict(_leaves(one_step['jvel']))
    vt = one_step['tvel']
    trainable = dict(_leaves(one_step['mask']))
    assert pt.keys() == pj.keys()
    n_moved = 0
    for k, t in trainable.items():
        if not t:
            np.testing.assert_array_equal(pt[k], p0[k], err_msg=k)
            np.testing.assert_array_equal(pj[k], p0[k], err_msg=k)
            assert k not in vt, k
            continue
        if np.linalg.norm(vj[k]) < NOISE:
            assert np.linalg.norm(vt[k]) < NOISE, k
            continue
        n_moved += 1
        rtol = FLIP_RTOL if k.startswith('backbone.') else UPDATE_RTOL
        assert np.linalg.norm(vt[k] - vj[k]) <= \
            rtol * np.linalg.norm(vj[k]), k
        step = 2e-3 * np.abs(vj[k]).max()              # lr 1e-3, biases 2x
        ulp = np.spacing(np.maximum(np.abs(p0[k]), np.abs(pj[k])))
        assert (np.abs(pt[k] - pj[k]) <= rtol * step + ulp).all(), k
    assert n_moved > 20
    if one_step['case'] == 'vgg16':
        assert all(trainable[k] for k in trainable
                   if k.startswith('backbone.'))
        assert np.linalg.norm(vt['backbone.features.0.weight']) > NOISE
