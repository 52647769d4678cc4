"""Int8 serving on the port (dana_tpu_torch/quant.py, models/layers.py
`dynamic_int8_conv`, ops/roi_align.py `roi_align_int8`) against the JAX
package's (dana_tpu/quant.py, `layers._dynamic_int8_conv`,
`ops/roi_align.py roi_align(int8=True)`) on the CPU.

Exact, on the same inputs:
  * the transform (BN fold, per-channel weights, identity BNs), bit for
    bit, on trees and on modules, both ways across `from_jax_params` /
    `to_jax_params`;
  * the int8 conv's quantized activations and int32 accumulators, and its
    output against JAX run op by op: under jit XLA contracts the rescale's
    multiply and add into one rounding (1 float32 ulp, measured) and may
    turn the division by 127 into a product with its reciprocal;
  * the int8 RoIAlign's quantized weights, map and accumulators, and its
    output, against JAX op by op (jit's reciprocal rewrite of extent /
    pooled moves the axis weights at the map's edge, ROADMAP C3);
  * the card's route (im2col, the operands `torch._int_mm` takes, padded
    to multiples of 8) replayed with the CPU's `torch._int_mm`.
Whole forwards: see `test_quantized_forward_matches_jax`.
"""

import importlib
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

from dana_tpu import quant as jq  # noqa: E402
from dana_tpu.models import dana as jdana  # noqa: E402
from dana_tpu.models import layers as JL  # noqa: E402
from dana_tpu.models import resnet as jresnet  # noqa: E402
from dana_tpu.models.layers import to_jnp  # noqa: E402

from dana_tpu_torch import quant as tq  # noqa: E402
from dana_tpu_torch.engine.predict import Predictor  # noqa: E402
from dana_tpu_torch.engine.train import Trainer  # noqa: E402
from dana_tpu_torch.models import dana as tdana  # noqa: E402
from dana_tpu_torch.models import layers as TL  # noqa: E402
from dana_tpu_torch.models import resnet as tresnet  # noqa: E402
from dana_tpu_torch.models import vgg as tvgg  # noqa: E402
from dana_tpu_torch.ops import roi_align as tra  # noqa: E402
from dana_tpu_torch.utils import trace  # noqa: E402
from dana_tpu_torch.utils.weights import (from_jax_params,  # noqa: E402
                                          to_jax_params)

jra = importlib.import_module('dana_tpu.ops.roi_align')

HEAD_TOL = 1e-4          # the float32 heads (tests/test_torch_port_model.py)
RECIPE_TOL = 2e-3        # the recipe's forward on JAX's features


def _int8_conv_runs():
    return trace.counts()['dynamic_int8_conv.runs']


def _int8_roi_runs():
    return trace.counts()['roi_align_int8.runs']


def _assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.fixture(scope='module')
def small():
    """The small DAnA of tests/test_torch_port_model.py with Caffe-like BN
    statistics, so that the fold is exercised."""
    jconf = jdana.DanaConfig(use_pallas_attention=False, **SMALL)
    tconf = tdana.DanaConfig(**SMALL)
    params = _caffe_like(jdana.init_params(jconf, seed=3), seed=4)
    return jconf, tconf, params


def _vgg_trunk(seed=0):
    """VGG16's thirteen biased convs with random biases (no classifier:
    the transform reads 'features' only)."""
    rng = np.random.default_rng(seed)
    features, cin = {}, 3
    for idx, v in zip(tvgg.CONV_IDX, [v for v in tvgg._CFG if v != 'M']):
        features[str(idx)] = TL.init_conv(rng, 3, 3, cin, v, bias=True)
        features[str(idx)]['bias'] = rng.normal(
            0, 0.1, v).astype(np.float32)
        cin = v
    return {'features': features, 'classifier': {'0': {
        'weight': np.ones((2, 2), np.float32)}}}


@pytest.mark.parametrize('arch', ['resnet50', 'vgg16'])
@pytest.mark.parametrize('scope', ['tail', 'all'])
def test_quantize_params_bit_for_bit(small, arch, scope):
    params = small[2] if arch == 'resnet50' else {
        'backbone': _vgg_trunk(), 'head': {'weight': np.ones(3, np.float32)}}
    want = jq.quantize_params(params, scope=scope)
    got = tq.quantize_params(params, scope=scope)
    _assert_trees_equal(got, want)
    n = jq.count_int8(want)
    assert tq.count_int8(got) == n == {
        ('resnet50', 'tail'): 10, ('resnet50', 'all'): 53,
        ('vgg16', 'tail'): 0, ('vgg16', 'all'): 13}[arch, scope]


@pytest.mark.parametrize('scope', ['tail', 'all'])
def test_quantized_modules_cross_both_ways(small, scope):
    """`quantize_model` on the port's module and `from_jax_params` of the
    JAX package's quantized tree give one module, whose `to_jax_params` is
    that tree bit for bit (int8 weights int8, OIHW in the module)."""
    _, tconf, params = small
    want = jq.quantize_params(params, scope=scope)
    model = tq.quantize_model(from_jax_params(params, tconf), scope)
    _assert_trees_equal(to_jax_params(model), want)
    loaded = from_jax_params(want, tconf)
    assert tq.count_int8(loaded) == tq.count_int8(model) == \
        jq.count_int8(want)
    for (ka, va), (kb, vb) in zip(model.state_dict().items(),
                                  loaded.state_dict().items()):
        assert ka == kb and va.dtype == vb.dtype and torch.equal(va, vb), ka
    conv = loaded.backbone.layer4[0].conv2
    assert isinstance(conv, TL.QuantConv2d) and conv.w_int8.dtype == \
        torch.int8 and conv.w_int8.shape == (512, 512, 3, 3)
    with pytest.raises(ValueError, match='quantized already'):
        tq.quantize_model(model, scope)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_identity_bn_is_exact(dtype):
    """The identity entries through the port's frozen BN: scale exactly 1
    and offset exactly 0, in float32 and after the cast to bf16."""
    bn = TL.FrozenBatchNorm2d(6)
    for k, v in tq._identity_bn(6).items():
        getattr(bn, k).copy_(torch.from_numpy(v))
    x = torch.from_numpy(np.random.default_rng(0).normal(
        0, 30, (2, 6, 5, 7)).astype(np.float32)).to(dtype)
    assert torch.equal(bn(x), x)


def _jax_quantize(x):
    """The activation quantization of `layers._dynamic_int8_conv`, op by
    op -> (xq int8, sx)."""
    xf = x.astype(jnp.float32)
    sx = jnp.maximum(jnp.max(jnp.abs(xf)), 1e-6) / 127.0
    return jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int8), sx


# (kernel, cin, cout, stride, padding, input dtype): a 3x3 conv2, a
# strided 1x1 (layer4's first conv1 and downsample), the 7x7 stem (K =
# 147, padded to 152 for `_int_mm`) and a bf16 input
CONVS = {'3x3': (3, 16, 24, 1, 1, 'float32'),
         '1x1_s2': (1, 32, 44, 2, 0, 'float32'),
         'stem': (7, 3, 64, 2, 3, 'float32'),
         '3x3_bf16': (3, 16, 24, 1, 1, 'bfloat16')}


@pytest.mark.parametrize('case', CONVS)
def test_int8_conv_matches_jax(case):
    kh, cin, cout, stride, pad, dt = CONVS[case]
    rng = np.random.default_rng(kh + cin)
    conv = jq.quantize_conv({
        'weight': rng.normal(0, 0.1, (kh, kh, cin, cout)).astype(np.float32),
        'bias': rng.normal(0, 1, cout).astype(np.float32)})
    x = torch.from_numpy(rng.normal(0, 3, (2, 20, 22, cin))
                         .astype(np.float32)).to(getattr(torch, dt))
    xj = jnp.asarray(x.float().numpy()).astype(getattr(jnp, dt))
    w = torch.from_numpy(conv['w_int8'].transpose(3, 2, 0, 1).copy())
    args = ((stride, stride), ((pad, pad), (pad, pad)))

    xq_j, sx_j = _jax_quantize(xj)
    xq, sx = TL.quantize_activation(TL.nhwc_to_nchw(x))
    assert sx.item() == float(sx_j)
    np.testing.assert_array_equal(TL.nchw_to_nhwc(xq).numpy(),
                                  np.asarray(xq_j))
    acc_j = np.asarray(jax.lax.conv_general_dilated(
        xq_j, jnp.asarray(conv['w_int8']), *args,
        dimension_numbers=('NHWC', 'HWIO', 'NHWC'),
        preferred_element_type=jnp.int32))
    acc = TL.int8_conv_acc(xq, w, stride, pad)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), acc_j)
    # the card's route: NHWC patches and `_int_mm`'s padded operands
    cols, wmat, shape = TL.conv_as_matmul(xq, w, stride, pad)
    a, b = TL.int_mm_operands(cols, wmat)
    assert a.shape[1] % 8 == 0 and b.shape[1] % 8 == 0
    routed = torch._int_mm(a, b)[:, :cout].reshape(shape)
    np.testing.assert_array_equal(routed.numpy(), acc_j)

    want = np.asarray(JL._dynamic_int8_conv(
        xj, jnp.asarray(conv['w_int8']), jnp.asarray(conv['w_scale']),
        jnp.asarray(conv['bias']), *args).astype(jnp.float32))
    n0 = _int8_conv_runs()
    got = TL.dynamic_int8_conv(TL.nhwc_to_nchw(x), w,
                               torch.from_numpy(conv['w_scale']),
                               torch.from_numpy(conv['bias']), stride, pad)
    assert _int8_conv_runs() == n0 + 1 and got.dtype == x.dtype
    np.testing.assert_array_equal(TL.nchw_to_nhwc(got).float().numpy(), want)


def test_int8_matmul_operands_pad_to_eight():
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.integers(-127, 128, (19, 13), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (13, 10), dtype=np.int8))
    pa, pb = TL.int_mm_operands(a, b)
    assert pa.shape == (19, 16) and pb.shape == (16, 16)
    assert pa.is_contiguous() and pb.t().is_contiguous()
    want = a.long() @ b.long()
    assert torch.equal(torch._int_mm(pa, pb)[:, :10].long(), want)
    assert torch.equal(TL.int8_matmul(a, b).long(), want)


def _jax_roi_int8(f, r):
    """`roi_align(int8=True)`'s int8 stage for one image, op by op ->
    (wq, sw, fq, sf, acc)."""
    h, w = f.shape[:2]
    r = r.astype(jnp.float32) * (1 / 16.)
    wy = jra._axis_weights(r[:, 1], r[:, 3], h, 7, 16, 0)
    wx = jra._axis_weights(r[:, 0], r[:, 2], w, 7, 16, 0)
    wcomb = jnp.einsum('rph,rqw->rpqhw', wy, wx)
    sw = jnp.maximum(jnp.max(jnp.abs(wcomb), axis=(3, 4)), 1e-8) / 127.0
    wq = jnp.round(wcomb / sw[..., None, None]).astype(jnp.int8)
    ff = f.astype(jnp.float32)
    sf = jnp.maximum(jnp.max(jnp.abs(ff)), 1e-8) / 127.0
    fq = jnp.clip(jnp.round(ff / sf), -127, 127).astype(jnp.int8)
    acc = jnp.einsum('rpqhw,hwc->rpqc', wq, fq,
                     preferred_element_type=jnp.int32)
    return wq, sw, fq, sf, acc


def test_roi_align_int8_matches_jax():
    """A 10x12 bf16 map, rois over and past its edges (one the whole
    canvas), rounded to bf16 as the model rounds them."""
    rng = np.random.default_rng(0)
    b, h, w, c, r = 2, 10, 12, 40, 9
    feat = torch.from_numpy(rng.normal(0, 3, (b, h, w, c))
                            .astype(np.float32)).to(torch.bfloat16)
    xy = rng.random((b, r, 2)) * 150 - 20
    wh = rng.random((b, r, 2)) * 120 + 1
    rois = np.concatenate([np.zeros((b, r, 1)), xy, xy + wh], -1)
    rois[0, 0, 1:] = (0, 0, 191, 159)
    rois = torch.from_numpy(rois.astype(np.float32)).to(torch.bfloat16)
    fj = jnp.asarray(feat.float().numpy()).astype(jnp.bfloat16)
    rj = jnp.asarray(rois.float().numpy()).astype(jnp.bfloat16)
    wy, wx = tra.roi_weights(rois, h, w)
    with jax.disable_jit():
        want = np.asarray(jra.roi_align(fj, rj, 7, 1 / 16., 0, int8=True)
                          .astype(jnp.float32))
        for i in range(b):
            wq_j, sw_j, fq_j, sf_j, acc_j = _jax_roi_int8(fj[i], rj[i, :, 1:])
            wq, sw = tra.quantize_roi_weights(wy[i], wx[i])
            fq, sf = tra.quantize_map(feat[i])
            np.testing.assert_array_equal(sw.numpy(), np.asarray(sw_j))
            np.testing.assert_array_equal(
                wq.numpy(), np.asarray(wq_j).reshape(r * 49, h * w))
            assert sf.item() == float(sf_j)
            np.testing.assert_array_equal(fq.numpy(),
                                          np.asarray(fq_j).reshape(-1, c))
            acc = TL.int8_matmul(wq, fq)
            np.testing.assert_array_equal(
                acc.numpy(), np.asarray(acc_j).reshape(r * 49, c))
            a, bb = TL.int_mm_operands(wq, fq)
            np.testing.assert_array_equal(torch._int_mm(a, bb)[:, :c],
                                          acc.numpy())
    n0 = _int8_roi_runs()
    got = tra.roi_align_int8(feat, rois)
    assert _int8_roi_runs() == n0 + 1
    assert got.dtype == torch.bfloat16 and got.shape == (b, r, 7, 7, c)
    np.testing.assert_array_equal(got.float().numpy(), want)


# ------------------------------------------------------------ forwards

def test_quantized_trunk_and_roi_tail_match_jax(small):
    """Scope 'all' (every conv int8; layer4 as under 'tail'): the trunk on
    float32 and bf16 queries and the RoI tail on pooled rois, each equal
    to JAX's run op by op.  Every product is exact and the elementwise
    steps are the same operations in the same order."""
    _, tconf, params = small
    qp = jq.quantize_params(params, scope='all')
    pj = to_jnp(qp['backbone'])
    model = from_jax_params(qp, tconf)
    rng = np.random.default_rng(7)
    x = rng.normal(0, 50, (2, 64, 96, 3)).astype(np.float32)
    r = rng.normal(0, 1, (3, 7, 7, 1024)).astype(np.float32)
    with torch.inference_mode():
        for dt, jdt in ((torch.float32, jnp.float32),
                        (torch.bfloat16, jnp.bfloat16)):
            xt = torch.from_numpy(x).to(dt)
            want = jresnet.base_forward(
                jnp.asarray(xt.float().numpy()).astype(jdt), pj)
            got = tresnet.base_forward(xt, model.backbone)
            assert got.dtype == dt
            np.testing.assert_array_equal(got.float().numpy(), _f32(want))
        n0 = _int8_conv_runs()
        got = tresnet.top_forward(torch.from_numpy(r), model.backbone)
        assert _int8_conv_runs() == n0 + 10
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jresnet.top_forward(jnp.asarray(r), pj)))


def _inputs():
    rng = np.random.default_rng(0)
    q = rng.integers(0, 256, (2, 128, 160, 3)).astype(np.uint8)
    sup = rng.normal(0, 50, (2, 224, 224, 3)).astype(np.float32)
    info = np.array([[128, 160, 1.0], [120, 150, 0.9]], np.float32)
    return q, sup, info


def _jax_forward(jconf, pj, q, sup, info):
    """JAX's eval forward (jitted) on `q` with one class's supports `sup`
    encoded as its CLI encodes them -> (outputs, supports)."""
    jsup = jax.jit(jdana.extract_support_feats, static_argnums=1)(
        pj, jconf, jnp.asarray(sup)[None])
    jsup = tuple(jnp.concatenate([f, f]) for f in jsup)
    jo = jax.jit(jdana.forward, static_argnums=1,
                 static_argnames='training')(
        pj, jconf, jnp.asarray(q), jnp.asarray(info), training=False,
        support_feats=jsup)
    return jo, jsup


def _f32(x):
    return np.asarray(x.astype(jnp.float32)) if isinstance(x, jax.Array) \
        else x.float().numpy()


@pytest.mark.parametrize('scope', ['tail', 'all'])
def test_quantized_forward_matches_jax(small, scope):
    """A float32 eval forward of the quantized detector from the same
    queries and supports, through `Predictor` (each class's supports
    encoded as one batch, as the JAX CLI encodes them): the same kept
    proposals within 2e-3 px (the float32 RPN, ROADMAP "Carried
    findings") and the heads within HEAD_TOL.  Under jit XLA rounds the
    int8 conv's rescale once (an FMA) where the port rounds twice, so a
    quantized activation can flip at an exact half; the int8 convs run
    once a request each (10 under 'tail', 53 under 'all', and 43 per class
    for the support trunk under 'all'), the int8 RoIAlign never (float32
    map)."""
    jconf, tconf, params = small
    qp = jq.quantize_params(params, scope=scope)
    jconf = jconf.__class__(**{**jconf.__dict__, 'roi_align_int8': True})
    tconf = tconf.__class__(**{**tconf.__dict__, 'roi_align_int8': True})
    q, sup, info = _inputs()
    jo, _ = _jax_forward(jconf, to_jnp(qp), q, sup, info)
    pred = Predictor(qp, tconf, device='cpu')
    runs, roi_runs = _int8_conv_runs(), _int8_roi_runs()
    pred.encode_supports(7, sup)
    enc = _int8_conv_runs() - runs
    with torch.inference_mode():
        to = tdana.forward(pred.model, tconf, torch.from_numpy(q),
                           torch.from_numpy(info),
                           support_feats=pred.batch_support_feats([7, 7]))
    assert (enc, _int8_conv_runs() - runs - enc) == \
        {'tail': (0, 10), 'all': (43, 53)}[scope]
    assert _int8_roi_runs() == roi_runs
    np.testing.assert_array_equal(to['roi_mask'].numpy(),
                                  np.asarray(jo['roi_mask']))
    np.testing.assert_allclose(to['rois'].numpy(), _f32(jo['rois']),
                               rtol=0, atol=2e-3)
    for key in ('cls_prob', 'bbox_pred'):
        err = np.abs(_f32(to[key]) - _f32(jo[key])).max()
        print(f'int8 {scope} {key}: max |port - JAX| {err:.3e}')
        assert err <= HEAD_TOL


@pytest.mark.parametrize('scope', ['tail', 'all'])
def test_quantized_recipe_forward_on_jax_features(small, scope,
                                                  monkeypatch):
    """The default recipe (bf16 trunk and attention, float32 head) under
    int8: handed JAX's bf16 base features, supports and proposals, the
    int8 RoIAlign on the bf16 map (once a request) and the int8 layer4 give
    JAX's head outputs within RECIPE_TOL, the precision recipe's forward
    tolerance (tests/test_torch_port_precision.py): bf16 attention sums in
    another order, and a pooled value one bf16 ulp apart moves its int8
    step."""
    from dana_tpu_torch.models import rpn as trpn
    jconf, tconf, params = small
    qp = jq.quantize_params(params, scope=scope)
    jconf = jconf.__class__(**{**jconf.__dict__, 'roi_align_int8': True,
                               'compute_dtype': jnp.bfloat16,
                               'head_dtype': jnp.float32})
    tconf = tconf.__class__(**{**tconf.__dict__, 'roi_align_int8': True,
                               'compute_dtype': torch.bfloat16,
                               'head_dtype': torch.float32})
    q, sup, info = _inputs()
    pj = to_jnp(qp)
    jo, jsup = _jax_forward(jconf, pj, q, sup, info)
    jbase = jax.jit(jdana.backbone_base, static_argnums=1)(
        pj, jconf, jdana.prep_query_images(jconf, jnp.asarray(q)).astype(
            jnp.bfloat16))
    base = torch.from_numpy(np.array(_f32(jbase))).to(torch.bfloat16)
    rois = torch.from_numpy(np.array(jo['rois'], np.float32))
    mask = torch.from_numpy(np.array(jo['roi_mask']))
    monkeypatch.setattr(tdana, 'query_features', lambda *a: base)
    monkeypatch.setattr(trpn, 'proposal_layer',
                        lambda *a, **k: (rois, None, mask))
    model = from_jax_params(qp, tconf)
    runs, roi_runs = _int8_conv_runs(), _int8_roi_runs()
    with torch.inference_mode():
        to = tdana.forward(model, tconf, torch.from_numpy(q),
                           torch.from_numpy(info),
                           support_feats=tuple(
                               torch.from_numpy(np.array(_f32(f))).to(
                                   torch.bfloat16)
                               for f in jsup))
    assert _int8_conv_runs() - runs == 10
    assert _int8_roi_runs() - roi_runs == 1
    for key in ('cls_prob', 'bbox_pred'):
        err = np.abs(_f32(to[key]) - _f32(jo[key])).max()
        print(f'int8 {scope} default recipe {key}: max |port - JAX| '
              f'{err:.3e}')
        assert to[key].dtype == torch.float32 and err <= RECIPE_TOL


# ------------------------------------------------------------ refusals

def test_int8_grids_and_training_are_refused(small):
    """A quantized model serves on every grid: data rows (its rows run in
    one `layers.ScaleGroup`), sp under either scope (the blocks share one
    scale) and tp (which splits no trunk conv); tests/test_torch_port_int8
    _grid.py holds their requests.  Trainer refuses it: training takes the
    float tree."""
    _, tconf, params = small
    tail = from_jax_params(jq.quantize_params(params, 'tail'), tconf)
    every = from_jax_params(jq.quantize_params(params, 'all'), tconf)
    two = ['cpu', 'cpu']
    for model, kw in ((tail, {}), (every, {}), (every, {'sp': 2}),
                      (tail, {'sp': 2}), (tail, {'tp': 2}),
                      (every, {'tp': 2})):
        pred = Predictor(model, tconf, devices=two, **kw)
        assert pred.int8 and len(pred.rows) == (1 if kw else 2)
    assert not Predictor(small[2], tconf, device='cpu').int8
    with pytest.raises(ValueError, match='float tree'):
        Trainer(tail, tconf, device='cpu')
