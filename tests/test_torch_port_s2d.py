"""The space-to-depth stem on the port (models/resnet.py `stem_w4`,
`conv1_s2d`, `conv7x7s2_s2d`; TPU.STEM_S2D) against the JAX package's
(dana_tpu/models/resnet.py) on the CPU, at the sizes of
tests/test_stem_s2d.py: the stem at 1e-5, the DAnA eval forward on packed
float and uint8 queries and packed supports (64x96 queries, 224 px
supports) at tests/test_torch_port_model.py's tolerances, one training
step on packed inputs at tests/test_torch_port_train.py's, and int8 'all'
(the int8 conv1 rewritten the same way) at tests/test_torch_port_quant.py's.
The packing itself is tests/test_torch_port_native.py's.
"""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from test_torch_port_model import SMALL, _caffe_like, _leaves  # noqa: E402
from test_torch_port_train import SMALL as TRAIN_SMALL  # noqa: E402
from test_torch_port_train import jax_step_draws  # noqa: E402

from dana_tpu import quant as jq  # noqa: E402
from dana_tpu.data import blob as jblob  # noqa: E402
from dana_tpu.engine import optim as joptim  # noqa: E402
from dana_tpu.engine import train as jtrain  # noqa: E402
from dana_tpu.models import dana as jdana  # noqa: E402
from dana_tpu.models import layers as JL  # noqa: E402
from dana_tpu.models import resnet as jresnet  # noqa: E402
from dana_tpu.models.layers import to_jnp  # noqa: E402

from dana_tpu_torch import parallel  # noqa: E402
from dana_tpu_torch.data import blob  # noqa: E402
from dana_tpu_torch.engine.predict import Predictor  # noqa: E402
from dana_tpu_torch.engine.train import Trainer  # noqa: E402
from dana_tpu_torch.models import dana as tdana  # noqa: E402
from dana_tpu_torch.models import frameworks  # noqa: E402
from dana_tpu_torch.models import layers as TL  # noqa: E402
from dana_tpu_torch.models import resnet as tresnet  # noqa: E402
from dana_tpu_torch.models import vgg as tvgg  # noqa: E402
from dana_tpu_torch.utils import trace  # noqa: E402
from dana_tpu_torch.utils.weights import from_jax_params  # noqa: E402

STEM_TOL = 1e-5          # tests/test_stem_s2d.py
HEAD_TOL = 1e-4          # tests/test_torch_port_model.py
ROI_ATOL = 2e-3          # px, the float32 RPN (ROADMAP "Carried findings")
MEANS = np.array([102.9801, 115.9465, 122.7717], np.float32)


def _int8_conv_runs():
    return trace.counts()['dynamic_int8_conv.runs']


def _nchw(x):
    return TL.nhwc_to_nchw(torch.from_numpy(x))


def _conv1(w_hwio):
    conv = TL.Conv2d(3, 64, 7, 2, 3, bias=False)
    conv.weight.data = torch.from_numpy(w_hwio).permute(3, 2, 0, 1).clone()
    return conv.requires_grad_(False)


def test_stem_w4_is_jax_stem_w4_transposed():
    rng = np.random.default_rng(0)
    w = JL.init_conv(rng, 7, 7, 3, 64)['weight']
    want = np.asarray(jresnet._stem_w4(w)).transpose(3, 2, 0, 1)
    got = tresnet.stem_w4(torch.from_numpy(w).permute(3, 2, 0, 1))
    np.testing.assert_array_equal(got.numpy(), want)
    q = jq.quantize_conv({'weight': w})['w_int8']
    got = tresnet.stem_w4(torch.from_numpy(q).permute(3, 2, 0, 1))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jresnet._stem_w4(q)).transpose(3, 2, 0, 1))


@pytest.mark.parametrize('case', ['conv1_s2d', 'conv7x7s2_s2d', 'stem'])
def test_stem_matches_jax(case):
    """conv1 on the host packing, conv1 through the device-side rewrite,
    and the whole stem (conv1, bn1, relu, ceil-mode pool) on the packing,
    each against JAX's and against the port's direct 7x7/2 path."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 64, 96, 3)).astype(np.float32)
    p = {'conv1': JL.init_conv(rng, 7, 7, 3, 64), 'bn1': JL.init_bn(64)}
    p['bn1']['running_mean'] = rng.normal(0, 1, 64).astype(np.float32)
    xd = blob.s2d_pack(x)
    conv = _conv1(p['conv1']['weight'])
    direct = TL.nchw_to_nhwc(conv(_nchw(x)))
    with torch.no_grad():
        if case == 'conv1_s2d':
            want = jax.jit(jresnet.conv1_s2d)(xd, p['conv1'])
            got = TL.nchw_to_nhwc(tresnet.conv1_s2d(_nchw(xd), conv))
        elif case == 'conv7x7s2_s2d':
            want = jax.jit(jresnet._conv7x7s2_s2d)(x, p['conv1'])
            got = tresnet.conv7x7s2_s2d(torch.from_numpy(x), conv)
        else:
            want = jax.jit(jresnet.stem)(xd, p)
            trunk = tresnet.ResNet('resnet50')
            trunk.conv1 = conv
            trunk.bn1.running_mean.copy_(torch.from_numpy(
                p['bn1']['running_mean']))
            bn = trunk.bn1
            got = TL.nchw_to_nhwc(TL.max_pool(torch.relu(bn(
                tresnet.stem_conv(_nchw(xd), trunk)))))
            direct = TL.nchw_to_nhwc(TL.max_pool(torch.relu(bn(
                tresnet.stem_conv(_nchw(x), trunk)))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=STEM_TOL,
                               atol=STEM_TOL)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), rtol=STEM_TOL,
                               atol=STEM_TOL)


def test_vgg16_and_spatial_blocks_refuse_packed_queries():
    xd = torch.zeros(1, 35, 51, 12)
    with pytest.raises(ValueError, match='space-to-depth stem'):
        tvgg.base_forward(xd, None)
    with pytest.raises(ValueError, match='space-to-depth'):
        parallel.shard_query_spatial(torch.zeros(1, 36, 51, 12),
                                     ['cpu', 'cpu'])


# ------------------------------------------------------------ eval forward

@pytest.fixture(scope='module')
def small():
    jconf = jdana.DanaConfig(use_pallas_attention=False, **SMALL)
    tconf = tdana.DanaConfig(**SMALL)
    params = _caffe_like(jdana.init_params(jconf, seed=3), seed=4)
    return jconf, tconf, params


def _eval_inputs(ship_uint8):
    """Two 64x96 queries and one class's two 224 px supports, packed:
    uint8 queries with the rounded-means border, else mean-subtracted."""
    rng = np.random.default_rng(11)
    q = rng.integers(0, 256, (2, 64, 96, 3)).astype(np.uint8)
    if ship_uint8:
        qd = blob.s2d_pack(q, u8_pad=blob.u8_pad_of(MEANS))
    else:
        qd = blob.s2d_pack(q.astype(np.float32) - MEANS)
    sup = rng.normal(0, 50, (2, 224, 224, 3)).astype(np.float32)
    info = np.array([[64, 96, 1.0], [60, 90, 0.9]], np.float32)
    return qd, blob.s2d_pack(sup), info


def _jax_eval(jconf, pj, qd, supd, info):
    jsup = jax.jit(jdana.extract_support_feats, static_argnums=1)(
        pj, jconf, jnp.asarray(supd)[None])
    jsup = tuple(jnp.concatenate([f, f]) for f in jsup)
    jo = jax.jit(jdana.forward, static_argnums=1,
                 static_argnames='training')(
        pj, jconf, jnp.asarray(qd), jnp.asarray(info), training=False,
        support_feats=jsup)
    return {k: np.asarray(v) for k, v in jo.items() if v is not None}


def _port_eval(model, tconf, qd, supd, info):
    pred = Predictor(model, tconf, device='cpu')
    pred.encode_supports(7, supd)
    with torch.inference_mode():
        return tdana.forward(pred.model, tconf, torch.from_numpy(qd),
                             torch.from_numpy(info),
                             support_feats=pred.batch_support_feats([7, 7]))


def _match_eval(to, jo):
    np.testing.assert_array_equal(to['roi_mask'].numpy(), jo['roi_mask'])
    np.testing.assert_allclose(to['rois'].numpy(), jo['rois'], rtol=0,
                               atol=ROI_ATOL)
    for key in ('cls_prob', 'bbox_pred'):
        np.testing.assert_allclose(to[key].float().numpy(), jo[key],
                                   rtol=HEAD_TOL, atol=HEAD_TOL,
                                   err_msg=key)


@pytest.mark.parametrize('ship_uint8', [False, True],
                         ids=['float', 'uint8'])
def test_eval_forward_on_packed_inputs_matches_jax(small, ship_uint8):
    """The DAnA eval forward on packed queries (float mean-subtracted, or
    uint8 with the means tiled over the 12 channels on the device) and
    packed supports, against JAX's on the same arrays."""
    jconf, tconf, params = small
    qd, supd, info = _eval_inputs(ship_uint8)
    assert qd.shape == (2, 35, 51, 12) and supd.shape == (2, 115, 115, 12)
    jo = _jax_eval(jconf, to_jnp(params), qd, supd, info)
    _match_eval(_port_eval(from_jax_params(params, tconf), tconf, qd, supd,
                           info), jo)


def test_int8_all_on_packed_inputs_matches_jax(small):
    """Int8 'all' (conv1 in int8 too, its weight rewritten by `stem_w4`
    with the per-output-channel scales kept) on packed uint8 queries: the
    trunk bit for bit against JAX's run op by op; the whole eval forward
    bit for bit against the port's direct int8 forward on the canvases
    (53 int8 convs a request, 43 for a class's supports), and its heads
    and kept proposals against JAX's jitted forward on the packed arrays.
    Under jit XLA rounds the int8 rescale once (an FMA) where the port
    rounds twice (tests/test_torch_port_quant.py), which at these inputs
    moves one roi 2.3e-3 px on either stem: the rois are held through the
    direct forward, which tests/test_torch_port_quant.py holds to JAX."""
    jconf, tconf, params = small
    qp = jq.quantize_params(params, scope='all')
    qd, supd, info = _eval_inputs(True)
    model = from_jax_params(qp, tconf)
    assert isinstance(model.backbone.conv1, TL.QuantConv2d)
    qf = qd.astype(np.float32) - np.tile(MEANS, 4)
    with jax.disable_jit():
        want = jresnet.base_forward(jnp.asarray(qf), to_jnp(qp['backbone']))
    with torch.inference_mode():
        got = tresnet.base_forward(torch.from_numpy(qf), model.backbone)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    runs = _int8_conv_runs()
    to = _port_eval(model, tconf, qd, supd, info)
    assert _int8_conv_runs() - runs == 43 + 53
    rng = np.random.default_rng(11)
    q = rng.integers(0, 256, (2, 64, 96, 3)).astype(np.uint8)
    sup = rng.normal(0, 50, (2, 224, 224, 3)).astype(np.float32)
    direct = _port_eval(model, tconf, q, sup, info)
    for k in ('rois', 'roi_mask', 'cls_prob', 'bbox_pred'):
        np.testing.assert_array_equal(to[k].numpy(), direct[k].numpy(),
                                      err_msg=k)
    jo = _jax_eval(jconf, to_jnp(qp), qd, supd, info)
    np.testing.assert_array_equal(to['roi_mask'].numpy(), jo['roi_mask'])
    for key in ('cls_prob', 'bbox_pred'):
        np.testing.assert_allclose(to[key].numpy(), jo[key], rtol=HEAD_TOL,
                                   atol=HEAD_TOL, err_msg=key)


def test_siblings_take_packed_inputs(small):
    """FSOD, whose supports run through the trunk with each request, on
    packed queries and supports equals its direct forward on the same
    canvases (the JAX package's siblings assert a raw support size of 224
    px, which a packed 320 px support, 163 px, fails)."""
    _, tconf, _ = small
    conf = tdana.DanaConfig(**{**SMALL, 'framework': 'fsod',
                               'semantic_enhance': False, 'n_shot': 1})
    tree = frameworks.init_params(conf, seed=2)
    # unsaturated RPN scores (tests/test_torch_port_cli.py's FSOD run)
    tree['RCNN_rpn']['RPN_Conv']['weight'] *= np.float32(1e-2)
    model = from_jax_params(tree, conf)
    rng = np.random.default_rng(12)
    q = rng.normal(0, 50, (1, 128, 160, 3)).astype(np.float32)
    sup = rng.normal(0, 50, (1, 1, 320, 320, 3)).astype(np.float32)
    info = np.array([[128, 160, 1.0]], np.float32)
    outs = []
    with torch.inference_mode():
        for qq, ss in ((q, sup), (blob.s2d_pack(q), blob.s2d_pack_any(sup))):
            outs.append(frameworks.forward(
                model, conf, torch.from_numpy(qq), torch.from_numpy(info),
                support_ims=torch.from_numpy(ss)))
    direct, packed = ({k: v.numpy() for k, v in o.items()} for o in outs)
    np.testing.assert_array_equal(packed['roi_mask'], direct['roi_mask'])
    np.testing.assert_allclose(packed['rois'], direct['rois'], rtol=0,
                               atol=ROI_ATOL)
    for key in ('cls_prob', 'bbox_pred'):
        np.testing.assert_allclose(packed[key], direct[key], rtol=HEAD_TOL,
                                   atol=HEAD_TOL, err_msg=key)


def test_spatial_grid_refuses_packed_queries(small):
    """sp keeps the direct stem: a grid with spatial blocks refuses a
    packed request, as the JAX package's sharding does."""
    _, tconf, params = small
    pred = Predictor(from_jax_params(params, tconf), tconf,
                     devices=['cpu', 'cpu'], sp=2)
    qd, supd, info = _eval_inputs(False)
    pred.encode_supports(7, blob.s2d_unpack(supd))
    with pytest.raises(ValueError, match='space-to-depth'):
        pred.predict(qd, info, [7, 7])


# ------------------------------------------------------------ training step

@pytest.fixture(scope='module')
def packed_step():
    """One JAX make_train_step and one Trainer.step on the packed query
    and supports of tests/test_torch_port_train.py's batch, from the same
    weights and draws."""
    from test_torch_port_train import _batch
    jconf = jdana.DanaConfig(use_pallas_attention=False, **TRAIN_SMALL)
    tconf = tdana.DanaConfig(**TRAIN_SMALL)
    params = _caffe_like(jdana.init_params(jconf, seed=8), seed=9)
    batch = _batch()
    batch['im_data'] = blob.s2d_pack(batch['im_data'])
    batch['support_ims'] = blob.s2d_pack_any(batch['support_ims'])
    assert np.array_equal(batch['im_data'], jblob.s2d_pack(
        _batch()['im_data']))
    pj = to_jnp(params)
    mask = joptim.trainable_mask(pj)
    rng = jax.random.PRNGKey(10)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    new_state, jm = jtrain.make_train_step(jconf, mask)(
        jtrain.create_train_state(pj, 1e-3), jb, rng)
    key = jax.random.fold_in(rng, 0)
    trainer = Trainer(params, tconf, device='cpu', lr=1e-3)
    n = 8 * 10 * tconf.num_anchors                 # the 128x160 query's map
    t = tconf.train_post_nms + batch['gt_boxes'].shape[1]
    tm = trainer.step(batch, draws=jax_step_draws(key, 2, n, t,
                                                  tconf.rois_per_image))
    tvel = {}
    for name, p in trainer.model.named_parameters():
        if p.requires_grad:
            v = trainer.optimizer.state[p]['momentum_buffer'].numpy()
            tvel[name] = v.transpose(2, 3, 1, 0) if v.ndim == 4 else \
                (v.T if v.ndim == 2 else v)
    assert trainer.model.backbone.conv1.weight.grad is None
    return jm, tm, dict(_leaves(jax.tree.map(
        np.asarray, new_state.opt.velocity))), tvel, dict(_leaves(mask))


@pytest.mark.parametrize('name', ['rpn_loss_cls', 'rpn_loss_box',
                                  'rcnn_loss_cls', 'rcnn_loss_bbox'])
def test_packed_step_losses_match_jax(packed_step, name):
    jm, tm = packed_step[:2]
    assert tm['skipped'].item() == 0.0
    np.testing.assert_allclose(tm[name].item(), float(jm[name]), rtol=1e-4,
                               atol=1e-7)


def test_packed_step_gradients_match_jax(packed_step):
    """Each trainable leaf's momentum buffer after the step (its gradient
    plus weight decay) within 1e-3 of JAX's norm; conv1 stays frozen."""
    _, _, vj, vt, trainable = packed_step
    n = 0
    for k, t in trainable.items():
        if not t or np.linalg.norm(vj[k]) < 1e-4:
            continue
        n += 1
        assert np.linalg.norm(vt[k] - vj[k]) <= \
            1e-3 * np.linalg.norm(vj[k]), k
    assert n > 50 and not trainable['backbone.conv1.weight']
