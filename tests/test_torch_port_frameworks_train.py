"""One training step of each sibling detector and of `cisa` on the port
against the JAX package's `make_train_step` on the CPU, with JAX's own
draws handed to the port (tests/test_torch_port_train.py
`jax_step_draws`), and the trainable and finetune sets against JAX's
masks.

Sizes are tests/test_models_smoke.py's COMMON (ResNet-50 at full width,
128x160 queries, 2-way 2-shot 320 px supports, 16 rois an image), with
Caffe-magnitude BN statistics.  Meta R-CNN's RPN trains on an all-class gt
that holds boxes the episode's gt does not; FGN runs with its head
BatchNorms on stored statistics and, as `fgn_bn_train` (on unit-scale
trunk statistics: `_unit_stats` says why), on batch statistics
(cfg.TRAIN.BN_TRAIN), whose running statistics then move twice a step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dana_tpu.engine import optim as joptim
from dana_tpu.engine import train as jtrain
from dana_tpu.models import dana as jdana
from dana_tpu.models import frameworks as jfw
from dana_tpu.models import rpn as jrpn
from dana_tpu.models.layers import to_jnp

from dana_tpu_torch.engine.train import Trainer
from dana_tpu_torch.models import frameworks as tfw
from dana_tpu_torch.models import resnet as tresnet
from dana_tpu_torch.utils.weights import to_jax_params
from test_torch_port_frameworks import NAMES, _pinned, jax_model, port_config
from test_torch_port_model import _caffe_like, _leaves
from test_torch_port_train import jax_step_draws

CASES = ['frcnn', 'fsod', 'meta', 'fgn', 'fgn_bn_train', 'cisa']
NOISE = 1e-6     # a momentum norm below it is float32 rounding of a zero
UPDATE_RTOL = 1e-3
# Leaves behind a ReLU whose input can sit at the two packages' float32
# distance from 0, which flips that unit's share of the gradient:
# - the trunk's layer2 and layer3, whose gradients sum over an 8x10 map:
#   the port's own step, its query scaled by 1 + 1e-5 noise, moves
#   layer3.0.conv3's momentum by 2.06e-3 of its norm (frcnn; 1e-6 noise
#   moves no leaf by more than 1.2e-6);
# - with batch statistics, FGN's head BNs, followed by ReLUs: one element
#   of bn1.bias (of 512) sits 1.8e-3 of the leaf's largest from JAX's,
#   every other element of the head within 1.1e-4.
FLIP_RTOL = 5e-3
LOSSES = ['rpn_loss_cls', 'rpn_loss_box', 'rcnn_loss_cls', 'rcnn_loss_bbox',
          'fg_cnt', 'bg_cnt']



@pytest.fixture(scope='module', autouse=True)
def few_threads():
    """Two intra-op threads for this file's full-width CPU forwards: the
    suite runs several test processes at once, and each one's default of a
    thread per core oversubscribes the cores."""
    was = torch.get_num_threads()
    torch.set_num_threads(min(2, was))
    yield
    torch.set_num_threads(was)

def _batch(n_sup):
    rng = np.random.default_rng(12)
    b, hw = 2, (128, 160)
    im = rng.integers(0, 256, (b, *hw, 3)).astype(np.float32) \
        - np.array([102.9801, 115.9465, 122.7717], np.float32)
    gt = np.zeros((b, 3, 5), np.float32)
    gt[0, :2] = [[10, 10, 70, 60, 1], [60, 40, 150, 120, 1]]
    gt[1, :1] = [[20, 30, 100, 110, 1]]
    # every class's gt: the episode's boxes and two of other classes
    all_gt = np.zeros((b, 5, 5), np.float32)
    all_gt[:, :3] = gt
    all_gt[0, 2:4] = [[0, 60, 60, 127, 3], [90, 0, 159, 50, 2]]
    all_gt[1, 1:3] = [[70, 10, 150, 90, 4], [5, 70, 60, 125, 2]]
    return dict(im_data=im, im_info=np.array([[*hw, 1.0]] * b, np.float32),
                gt_boxes=gt, all_gt_boxes=all_gt,
                support_ims=rng.normal(0, 50, (b, n_sup, 320, 320, 3))
                .astype(np.float32))


def _unit_stats(tree):
    """Shrink `_caffe_like`'s trunk statistics toward unit scale (means /
    100, variances 1 + (var - 1) / 400: sd 0.3, 1 to 2), in place.  On the
    Caffe-magnitude ones the RoI features carry per-channel offsets that
    FGN's head batch statistics cancel: cls_conv1's outputs have |mean| /
    std up to 1.3e4 (37 on these), and the port's own float32 head sits
    1.05e-3 (of the scores' scale) from float64 on identical inputs (6.1e-6
    on these).  A SkipInit trunk (zero conv3) has exact ReLU ties
    instead."""
    for k, v in tree.items():
        if isinstance(v, dict) and 'running_var' in v:
            v['running_mean'] = v['running_mean'] / np.float32(100)
            v['running_var'] = 1 + (v['running_var'] - 1) / np.float32(400)
        elif isinstance(v, dict):
            _unit_stats(v)


def _jax_forward(name, jconf):
    """The JAX training forward of `name` (jitted), as loss_fn calls it:
    its sampled rois and their labels, and its proposals."""
    def run(p, b, k):
        rec = {}
        real = jrpn.proposal_layer

        def layer(*args, **kwargs):
            rec['proposals'] = real(*args, **kwargs)
            return rec['proposals']
        jrpn.proposal_layer = layer
        try:
            out = forward(p, b, k)
        finally:
            jrpn.proposal_layer = real
        return dict(rois=out['rois'], rois_label=out['rois_label'],
                    proposals=rec['proposals'][0],
                    proposal_mask=rec['proposals'][2])

    def forward(p, b, k):
        kw = dict(training=True, gt_boxes=b['gt_boxes'], rng=k)
        if name == 'frcnn':
            out = jfw.frcnn_forward(p, jconf, b['im_data'], b['im_info'],
                                    **kw)
        elif name == 'meta':
            out = jfw.meta_forward(p, jconf, b['im_data'], b['im_info'],
                                   b['support_ims'],
                                   all_cls_gt_boxes=b['all_gt_boxes'], **kw)
        elif name in ('fsod', 'fgn'):
            out = jfw.forward_fn(name)(p, jconf, b['im_data'], b['im_info'],
                                       b['support_ims'], **kw)
        else:
            out = jdana.forward(p, jconf, b['im_data'], b['im_info'],
                                b['support_ims'], **kw)
        return out
    return jax.jit(run)


@pytest.fixture(scope='module', params=CASES)
def one_step(request):
    """One JAX make_train_step and one Trainer.step from the same
    Caffe-magnitude weights, batch and draws, the port given the JAX
    proposals: the trunk's gradients pass RoIAlign's backward, whose
    weights would follow the free forwards' 2e-3 px proposal difference
    (ROADMAP "Carried findings"; test_torch_port_frameworks.py holds
    the free proposals)."""
    case = request.param
    name, bn_train = case.split('_')[0], case.endswith('bn_train')
    jconf, params = jax_model(name, seed=8)
    params = _caffe_like(params, seed=9)
    if bn_train:
        jconf = jconf.__class__(**dict(jconf.__dict__, bn_train=True))
        _unit_stats(params)
    batch = _batch(jconf.n_way * jconf.n_shot)
    pj = to_jnp(params)
    mask = joptim.trainable_mask(pj)
    rng = jax.random.PRNGKey(10)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    new_state, jm = jtrain.make_train_step(jconf, mask, model=name)(
        jtrain.create_train_state(pj, 1e-3), jb, rng)
    key = jax.random.fold_in(rng, 0)
    jout = _jax_forward(name, jconf)(pj, jb, key)

    tconf = port_config(name, bn_train=bn_train)
    trainer = Trainer(params, tconf, device='cpu', lr=1e-3)
    with torch.no_grad():
        feat = tresnet.base_forward(torch.from_numpy(batch['im_data']),
                                    trainer.model.backbone)
    fh, fw = feat.shape[1:3]
    if name == 'fsod':          # the correlation's VALID 7x7 grid
        fh, fw = fh - 6, fw - 6
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
    """On the same proposals and draws, the target layer samples the same
    rois (Meta R-CNN from the episode's gt, not the all-class one)."""
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
    """As tests/test_torch_port_train.py's: per trainable leaf |dport -
    djax| <= 1e-3 |djax| for the momentum buffers (FLIP_RTOL where a
    ReLU tie can flip a unit) and that plus one ulp of the new value for
    the parameters; a leaf whose JAX momentum is rounding noise (no
    gradient by construction) stays noise in the port; frozen leaves
    bit-equal to the start."""
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
            if k.endswith(('running_mean', 'running_var')):
                continue            # test_step_buffers_match_jax
            np.testing.assert_array_equal(pt[k], p0[k], err_msg=k)
            assert k not in vt, k
            continue
        if np.linalg.norm(vj[k]) < NOISE:
            assert np.linalg.norm(vt[k]) < NOISE, k
            continue
        n_moved += 1
        flips = k.startswith('backbone.') or (
            one_step['case'] == 'fgn_bn_train'
            and k.startswith(('cls_conv', 'bn1.', 'bn2.')))
        rtol = FLIP_RTOL if flips else UPDATE_RTOL
        assert np.linalg.norm(vt[k] - vj[k]) <= \
            rtol * np.linalg.norm(vj[k]), k
        step = 2e-3 * np.abs(vj[k]).max()              # lr 1e-3, biases 2x
        ulp = np.spacing(np.maximum(np.abs(p0[k]), np.abs(pj[k])))
        assert (np.abs(pt[k] - pj[k]) <= rtol * step + ulp).all(), k
    assert n_moved > 50


def test_step_buffers_match_jax(one_step):
    """Running statistics: the trunk's stay as they were; FGN's head BNs
    with batch statistics move (twice, positive then negative call) to
    within 1e-5 of JAX's, and stay as they were otherwise."""
    p0 = dict(_leaves(one_step['params']))
    pj = dict(_leaves(one_step['jparams']))
    pt = dict(_leaves(one_step['tparams']))
    stats = [k for k in p0 if k.endswith(('running_mean', 'running_var'))]
    head = [k for k in stats if not k.startswith('backbone.')]
    assert len(head) == (4 if one_step['case'].startswith('fgn') else 0)
    for k in stats:
        if k in head and one_step['case'] == 'fgn_bn_train':
            assert not np.array_equal(pj[k], p0[k]), k
            np.testing.assert_allclose(pt[k], pj[k], rtol=1e-5,
                                       atol=1e-5 * np.abs(pj[k]).max(),
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(pt[k], p0[k], err_msg=k)
            np.testing.assert_array_equal(pj[k], p0[k], err_msg=k)


@pytest.mark.parametrize('finetune', [False, True],
                         ids=['trainable', 'finetune'])
@pytest.mark.parametrize('name', NAMES)
def test_trainable_sets_match_jax(name, finetune):
    """The parameters that train equal JAX's trainable_mask (and with --fs
    its finetune_mask too), leaf for leaf; FGN's head BN affine trains
    outside --fs, FSOD finetunes only RCNN_bbox_pred."""
    conf = port_config(name)
    params = tfw.init_params(conf, seed=0)
    trainer = Trainer(params, conf, device='cpu', finetune=finetune)
    jp = jax.tree.map(np.asarray, params)
    mask = joptim.trainable_mask(jp, fixed_blocks=1)
    if finetune:
        mask = jax.tree.map(lambda a, b: a and b, mask,
                            joptim.finetune_mask(jp))
    want = {k for k, t in _leaves(mask) if t}
    got = {n for n, p in trainer.model.named_parameters() if p.requires_grad}
    assert got == want
    if name == 'fgn' and not finetune:
        assert {'bn1.weight', 'bn1.bias', 'bn2.weight', 'bn2.bias'} <= got
    if finetune and name == 'fsod':
        assert got == {'RCNN_bbox_pred.weight', 'RCNN_bbox_pred.bias'}
