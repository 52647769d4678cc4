"""The port's training slice against the JAX package on the CPU: the
losses, both target layers (fed the uniform draws JAX derives from the
same keys), the SGD groups with frozen leaves, the non-finite step skip
and one whole training step.

torch cannot replay `jax.random`, so each test derives JAX's own draws
from its key, in the split order of dana_tpu/models/rpn.py, and hands
them to the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dana_tpu.core.anchors import generate_anchors, shifted_anchors
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
from dana_tpu_torch.utils.weights import to_jax_params
from test_torch_port_model import _caffe_like, _leaves

# tests/test_nonfinite_guard.py's training config
SMALL = dict(n_way=2, n_shot=1, train_pre_nms=100, train_post_nms=16,
             test_pre_nms=100, test_post_nms=8, nms_cap=100,
             rois_per_image=8, rpn_batchsize=16)
# leaves whose gradient is zero by construction: q and k are centred over
# their tokens and the unary scores enter a softmax, so a shift of their
# bias changes nothing; the updates are float32 rounding noise
NO_GRAD = {f'{site}_{layer}_layer.bias' for site in ('rpn', 'rcnn')
           for layer in ('adapt_q', 'adapt_k', 'unary')}
NOISE = 1e-6      # the smallest real momentum norm is above 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _anchor_draws(key, b, n):
    kf, kb = jax.random.split(key)
    return [np.asarray(jax.random.uniform(k, (b, n))) for k in (kf, kb)]


def _roi_draws(key, b, t, s):
    kf, _, kff, kbb = jax.random.split(key, 4)
    return [np.asarray(jax.random.uniform(kf, (b, t))),
            np.asarray(jax.random.uniform(kff, (b, s))),
            np.asarray(jax.random.uniform(kbb, (b, s)))]


def jax_step_draws(key, b, n, t, s):
    """The draws of one JAX training step whose key is `key` (after its
    fold_in), keyed as the port's forward takes them."""
    k_anchor, k_roi = jax.random.split(key)
    vals = _anchor_draws(k_anchor, b, n) + _roi_draws(k_roi, b, t, s)
    return {k: _t(v) for k, v in zip(trpn.DRAW_KEYS, vals)}


# ----------------------------------------------------------------- losses

def test_smooth_l1_matches_jax():
    rng = np.random.default_rng(0)
    pred = rng.normal(0, 1, (3, 50, 4)).astype(np.float32)
    tgt = rng.normal(0, 1, (3, 50, 4)).astype(np.float32)
    in_w = (rng.random((3, 50, 1)) > 0.5).astype(np.float32)
    out_w = rng.random((3, 50, 1)).astype(np.float32)
    for sigma, dims in ((3.0, None), (1.0, (1,))):
        p, t_ = (pred.reshape(-1, 4), tgt.reshape(-1, 4)) if dims else \
            (pred, tgt)
        iw = np.broadcast_to(in_w, pred.shape).reshape(p.shape)
        ow = np.broadcast_to(out_w, pred.shape).reshape(p.shape)
        want = jlosses.smooth_l1_loss(p, t_, iw, ow, sigma=sigma,
                                      reduce_dims=dims)
        got = tlosses.smooth_l1_loss(_t(p), _t(t_), _t(iw), _t(ow),
                                     sigma=sigma, reduce_dims=dims)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize('case', ['mixed', 'all_ignored'])
def test_masked_cross_entropy_matches_jax(case):
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 3, (2, 40, 2)).astype(np.float32)
    labels = rng.integers(-1, 2, (2, 40)).astype(np.int32)
    if case == 'all_ignored':
        labels[:] = -1
    want = jlosses.masked_cross_entropy(logits, labels, labels != -1)
    got = tlosses.masked_cross_entropy(_t(logits), _t(labels),
                                       _t(labels != -1))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize('case', ['ties', 'no_fg', 'many_fg'])
def test_hard_mined_pair_ce_matches_jax(case):
    """Saturated logits give exactly tied fg probabilities; the mined
    background set depends on the stable order among them."""
    rng = np.random.default_rng(2)
    b, s = 2, 32
    logits = rng.normal(0, 2, (b, s, 2)).astype(np.float32)
    neg = rng.normal(0, 2, (b, s, 2)).astype(np.float32)
    labels = (rng.random((b, s)) < 0.2).astype(np.int32)
    if case == 'ties':
        logits[:, ::3] = [-30.0, 30.0]        # fg prob exactly 1.0
        logits[:, 1::5] = [2.0, 2.0]          # exactly 0.5
        neg[:, ::2] = [-40.0, 40.0]
    elif case == 'no_fg':
        labels[:] = 0
    else:
        labels = (rng.random((b, s)) < 0.8).astype(np.int32)
    want = jlosses.hard_mined_pair_ce(logits, labels, neg)
    got = tlosses.hard_mined_pair_ce(_t(logits), _t(labels), _t(neg))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_get_model_training_fields_match_jax():
    """The port's get_model fills the training fields as the root
    utils.get_model does from the JAX config defaults, and its optimizer
    constants are the JAX config's."""
    import utils
    from dana_tpu.utils.config import cfg
    from dana_tpu_torch.utils import config as tcfg
    conf, _ = tcfg.get_model('res50', way=2, shot=3, seed=0)
    want = jdana.DanaConfig(**utils.model_config_kwargs(2, 3))
    for f in ('train_pre_nms', 'train_post_nms', 'test_pre_nms',
              'test_post_nms', 'rpn_nms_thresh', 'nms_cap', 'rpn_batchsize',
              'rpn_fg_fraction', 'rpn_pos_overlap', 'rpn_neg_overlap',
              'rois_per_image', 'fg_fraction', 'fg_thresh', 'bg_thresh_hi',
              'bg_thresh_lo', 'bbox_normalize_means', 'bbox_normalize_stds'):
        assert getattr(conf, f) == getattr(want, f), f
    assert cfg.TRAIN.RPN_NMS_THRESH == conf.rpn_nms_thresh
    assert (tcfg.TRAIN_LEARNING_RATE, tcfg.TRAIN_MOMENTUM,
            tcfg.TRAIN_WEIGHT_DECAY, tcfg.TRAIN_DOUBLE_BIAS,
            tcfg.TRAIN_BIAS_DECAY, tcfg.FIXED_BLOCKS) == (
        cfg.TRAIN.LEARNING_RATE, cfg.TRAIN.MOMENTUM, cfg.TRAIN.WEIGHT_DECAY,
        cfg.TRAIN.DOUBLE_BIAS, cfg.TRAIN.BIAS_DECAY,
        cfg.RESNET.FIXED_BLOCKS)


# ---------------------------------------------------------- target layers

def _anchors(h, w, scales=(8, 16, 32)):
    return np.asarray(shifted_anchors(
        h, w, 16, generate_anchors(scales=np.array(scales))))


def test_anchor_target_matches_jax():
    """Four images: gt boxes on a 128x160 image (fg and bg), every inside
    anchor its own gt (only fg), no gt (only bg), and an image too small
    for any anchor to lie inside (neither)."""
    anchors = _anchors(8, 10, scales=(2, 4, 8))
    n = anchors.shape[0]
    g = 4
    gt = np.zeros((4, g, 5), np.float32)
    gt[0, :2] = [[10, 10, 60, 50, 1], [70, 40, 150, 120, 1]]
    info = np.array([[128, 160, 1], [40, 40, 1], [128, 160, 1], [8, 8, 1]],
                    np.float32)
    inside = ((anchors[:, 0] >= 0) & (anchors[:, 1] >= 0)
              & (anchors[:, 2] < 40) & (anchors[:, 3] < 40))
    assert 0 < inside.sum() <= g
    gt[1, :inside.sum(), :4] = anchors[inside]
    gt[1, :inside.sum(), 4] = 1
    key = jax.random.PRNGKey(3)
    kw = dict(batch_rois=16, fg_fraction=0.5)
    want = jrpn.anchor_target(jnp.asarray(anchors), jnp.asarray(gt),
                              jnp.asarray(info), key, **kw)
    u_fg, u_bg = _anchor_draws(key, 4, n)
    got = trpn.anchor_target(_t(anchors), _t(gt), _t(info), _t(u_fg),
                             _t(u_bg), **kw)
    labels = got[0].numpy()
    np.testing.assert_array_equal(labels, np.asarray(want[0]))
    assert (labels[0] == 1).any() and (labels[0] == 0).any()
    assert (labels[1] == 1).any() and not (labels[1] == 0).any()
    assert (labels[2] == 0).any() and not (labels[2] == 1).any()
    assert (labels[3] == -1).all()
    for a, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_proposal_target_matches_jax():
    """Four images: proposals around two gt boxes (fg and bg), proposals
    that all overlap the gt (only fg), no gt (neither), and, with fg_thresh
    above any IoU, only bg."""
    rng = np.random.default_rng(4)
    b, r, g, s = 4, 40, 3, 16
    gt = np.zeros((b, g, 5), np.float32)
    gt[:2, :2] = [[20, 20, 80, 90, 1], [90, 30, 150, 110, 1]]
    gt[3, :1] = [[30, 30, 100, 100, 1]]
    ctr = rng.random((b, r, 2)) * 140 + 10
    size = rng.random((b, r, 2)) * 60 + 20
    rois = np.concatenate([np.zeros((b, r, 1)), ctr - size / 2,
                           ctr + size / 2], -1).astype(np.float32)
    rois[1, :, 1:] = gt[1, rng.integers(0, 2, r), :4] \
        + rng.normal(0, 2, (r, 4))               # all IoU >= 0.5
    cases = []
    for fg_thresh in (0.5, 1.5):                 # 1.5: only bg where gt
        key = jax.random.PRNGKey(5)
        kw = dict(rois_per_image=s, fg_thresh=fg_thresh)
        want = jrpn.proposal_target(jnp.asarray(rois), jnp.asarray(gt), key,
                                    **kw)
        u = _roi_draws(key, b, r + g, s)
        got = trpn.proposal_target(_t(rois), _t(gt), *map(_t, u), **kw)
        cases.append((got, want))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        for a, w in zip(got[:1] + got[2:], want[:1] + want[2:]):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)
    labels = cases[0][0][1].numpy()
    assert (labels[0] > 0).any() and (labels[0] == 0).any()
    assert (labels[1] > 0).all()                 # only fg
    assert not cases[0][0][0][2].any()           # neither: zero rois
    only_bg = cases[1][0]
    assert (only_bg[1][3] == 0).all() and only_bg[0][3, :, 1:].any()


def test_random_rank_is_stable_on_masked_ties():
    u = torch.tensor([[0.5, 0.1, 0.9, 0.3]])
    mask = torch.tensor([[True, False, True, False]])
    assert trpn._random_rank(u, mask).tolist() == [[0, 2, 1, 3]]


# -------------------------------------------------------------- optimizer

def _grad_tree(tree, rng):
    return {k: _grad_tree(v, rng) if isinstance(v, dict)
            else rng.normal(0, 1, v.shape).astype(np.float32)
            for k, v in tree.items()}


@pytest.mark.parametrize('clip_norm', [0.0, 10.0, 1e9],
                         ids=['no_clip', 'clipped', 'below_clip'])
def test_sgd_groups_match_jax_sgd_update(clip_norm):
    """Two Trainer updates with given gradients: biases at 2x lr without
    decay, weights at lr with decay 5e-4, frozen leaves bit-equal; with
    clip_norm, first JAX's clip_gradients over the trainable leaves only
    (10 scales these N(0, 1) gradients down, 1e9 leaves them as they
    are)."""
    tconf = tdana.DanaConfig(**SMALL)
    params = jdana.init_params(jdana.DanaConfig(**SMALL), seed=1)
    trainer = Trainer(params, tconf, device='cpu', lr=0.01,
                      clip_norm=clip_norm)
    pj = to_jnp(params)
    mask = joptim.trainable_mask(pj)
    state = joptim.sgd_init(pj)._replace(lr=jnp.asarray(0.01, jnp.float32))
    rng = np.random.default_rng(6)
    named = dict(trainer.model.named_parameters())
    for _ in range(2):
        grads = _grad_tree(params, rng)
        flat = dict(_leaves(grads))
        for name, p in named.items():
            g = flat[name]
            g = g.transpose(3, 2, 0, 1) if g.ndim == 4 else \
                (g.T if g.ndim == 2 else g)
            p.grad = _t(g) if p.requires_grad else None
        assert trainer.update(torch.zeros(())).item() == 0.0
        gj = to_jnp(grads)
        if clip_norm:
            gj = joptim.clip_gradients(gj, clip_norm, trainable=mask)
        pj, state = joptim.sgd_update(pj, gj, state, trainable=mask)
    got = dict(_leaves(to_jax_params(trainer.model)))
    want = dict(_leaves(jax.tree.map(np.asarray, pj)))
    trainable = dict(_leaves(mask))
    assert got.keys() == want.keys()
    n_frozen = 0
    for k in want:
        if trainable[k]:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       atol=1e-6, err_msg=k)
        else:
            n_frozen += 1
            np.testing.assert_array_equal(got[k], dict(_leaves(params))[k],
                                          err_msg=k)
    assert n_frozen > 0
    assert trainer.model.backbone.conv1.weight.grad is None
    assert not trainer.model.backbone.layer1[0].conv1.weight.requires_grad


# ----------------------------------------------------------- training step

def _batch(b=2, hw=(128, 160), nan=False):
    rng = np.random.default_rng(7)
    im = rng.integers(0, 256, (b, *hw, 3)).astype(np.float32) \
        - np.array([102.9801, 115.9465, 122.7717], np.float32)
    if nan:
        im[0, 0, 0, 0] = np.nan
    gt = np.zeros((b, 3, 5), np.float32)
    gt[0, :2] = [[10, 10, 70, 60, 1], [60, 40, 150, 120, 1]]
    gt[1, :1] = [[20, 30, 100, 110, 1]]
    return dict(im_data=im,
                im_info=np.array([[*hw, 1.0]] * b, np.float32),
                gt_boxes=gt,
                support_ims=rng.normal(0, 50, (b, 2, 224, 224, 3))
                .astype(np.float32))


def test_nonfinite_step_is_skipped():
    """A NaN query changes no parameter and no momentum and reports
    skipped=1; a clean batch then moves every trainable parameter with a
    gradient (the biases of the RoI site's q, k and unary projections
    have none: centering and the softmax cancel them)."""
    conf = tdana.DanaConfig(**SMALL)
    trainer = Trainer(tdana.init_params(conf, seed=0), conf, device='cpu')
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    m = trainer.step(_batch(nan=True))
    assert m['skipped'].item() == 1.0
    assert not trainer.optimizer.state
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    m = trainer.step(_batch())
    assert m['skipped'].item() == 0.0 and torch.isfinite(m['loss'])
    still = [p for n, p in trainer.model.named_parameters()
             if p.requires_grad and torch.equal(p, before[n])]
    assert len(still) <= 3 and not any(p.grad.any() for p in still)
    frozen = [p for p in trainer.model.parameters() if not p.requires_grad]
    assert frozen and all(p.grad is None for p in frozen)
    assert all(torch.equal(p, before[n])
               for n, p in trainer.model.named_parameters()
               if not p.requires_grad)


@pytest.fixture(scope='module')
def one_step():
    """One JAX make_train_step and one Trainer.step from the same
    Caffe-magnitude weights, batch and draws."""
    jconf = jdana.DanaConfig(use_pallas_attention=False, **SMALL)
    tconf = tdana.DanaConfig(**SMALL)
    params = _caffe_like(jdana.init_params(jconf, seed=8), seed=9)
    batch = _batch()
    pj = to_jnp(params)
    mask = joptim.trainable_mask(pj)
    rng = jax.random.PRNGKey(10)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    new_state, jm = jtrain.make_train_step(jconf, mask)(
        jtrain.create_train_state(pj, 1e-3), jb, rng)
    key = jax.random.fold_in(rng, 0)
    jout = jax.jit(lambda p, b, k: jdana.forward(
        p, jconf, b['im_data'], b['im_info'], b['support_ims'],
        training=True, gt_boxes=b['gt_boxes'], rng=k))(pj, jb, key)

    trainer = Trainer(params, tconf, device='cpu', lr=1e-3)
    with torch.no_grad():
        feat = tdana.resnet.base_forward(
            torch.from_numpy(batch['im_data']), trainer.model.backbone)
    n = feat.shape[1] * feat.shape[2] * tconf.num_anchors
    t = tconf.train_post_nms + batch['gt_boxes'].shape[1]
    draws = jax_step_draws(key, 2, n, t, tconf.rois_per_image)
    captured = {}
    real = tdana.forward

    def capture(*a, **kw):
        captured.update(real(*a, **kw))
        return captured
    tdana.forward = capture
    try:
        tm = trainer.step(batch, draws=draws)
    finally:
        tdana.forward = real
    tvel = {}
    for name, p in trainer.model.named_parameters():
        if p.requires_grad:
            v = trainer.optimizer.state[p]['momentum_buffer'].numpy()
            tvel[name] = v.transpose(2, 3, 1, 0) if v.ndim == 4 else \
                (v.T if v.ndim == 2 else v)
    return dict(params=params, mask=mask, jm=jm, jout=jout,
                jparams=jax.tree.map(np.asarray, new_state.params),
                jvel=jax.tree.map(np.asarray, new_state.opt.velocity),
                tm=tm, tout=captured, tvel=tvel,
                tparams=to_jax_params(trainer.model))


def test_step_samples_the_same_rois(one_step):
    jout, tout = one_step['jout'], one_step['tout']
    np.testing.assert_array_equal(
        tout['rois_label'].numpy(), np.asarray(jout['rois_label']),
        err_msg='the sampled roi labels differ, so the losses below cannot '
                'agree (float32 order through the trunk, ROADMAP Queue C 1)')
    np.testing.assert_allclose(
        tout['rois'].detach().numpy(), np.asarray(jout['rois']), rtol=0,
        atol=2e-3, err_msg='the sampled rois differ by more than 2e-3 px')


@pytest.mark.parametrize('name', ['rpn_loss_cls', 'rpn_loss_box',
                                  'rcnn_loss_cls', 'rcnn_loss_bbox',
                                  'fg_cnt', 'bg_cnt'])
def test_step_losses_match_jax(one_step, name):
    got, want = one_step['tm'][name].item(), float(one_step['jm'][name])
    assert one_step['tm']['skipped'].item() == 0.0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)


def test_step_updates_match_jax(one_step):
    """Per trainable leaf |dport - djax| <= 1e-3 |djax|, the update d =
    lr * momentum buffer read before it is rounded into the float32
    parameter (where an update near the parameter's ulp would lose
    digits); the new parameters then agree to that plus one ulp.  Frozen
    leaves are bit-equal to the start.  The biases of the RoI site's q, k
    and unary projections have no gradient (centering and the softmax
    cancel it): their buffers are float32 rounding noise in JAX and must
    stay below NOISE in the port too."""
    p0 = dict(_leaves(one_step['params']))
    pj = dict(_leaves(one_step['jparams']))
    pt = dict(_leaves(one_step['tparams']))
    vj = dict(_leaves(one_step['jvel']))
    vt = one_step['tvel']
    trainable = dict(_leaves(one_step['mask']))
    assert pt.keys() == pj.keys()
    n_train = n_moved = 0
    for k, t in trainable.items():
        if not t:
            np.testing.assert_array_equal(pt[k], p0[k], err_msg=k)
            assert k not in vt, k
            continue
        n_train += 1
        if k in NO_GRAD:
            assert max(np.linalg.norm(vt[k]), np.linalg.norm(vj[k])) \
                < NOISE, k
            continue
        n_moved += 1
        assert np.linalg.norm(vt[k] - vj[k]) <= \
            1e-3 * np.linalg.norm(vj[k]), k
        step = 2e-3 * np.abs(vj[k]).max()              # lr 1e-3, biases 2x
        assert (np.abs(pt[k] - pj[k])
                <= 1e-3 * step + np.spacing(np.abs(p0[k]))).all(), k
    assert n_moved == n_train - len(NO_GRAD) > 50
