"""The precision recipe on the port (TPU.COMPUTE_DTYPE, ATTENTION_DTYPE,
HEAD_DTYPE) against the JAX package on the CPU.

The recipe runs the trunk in bfloat16 with float32 parameters, the
attention sites in ATTENTION_DTYPE and the RPN and R-CNN heads in
HEAD_DTYPE (float32 by default).  Inputs and weights are numpy arrays from
a seed; a bf16 input is rounded once, by torch, and handed to JAX as the
same bf16 values.  Tolerances, each with its measured value printed:
  * the kernels' plain versions (K1 at S shots and at S = 1, K2) against
    JAX's functions on the same bf16 inputs: one bf16 ulp at the output's
    scale, 2**-7 * max|JAX|.  The arithmetic is the same (bf16 operands,
    float32 sums, one rounding of the result; K1 also rounds the
    probabilities), but float32 sums in another order can move a value
    across a rounding boundary;
  * the float32 head island: bitwise equal to the float32 head, and
    within 1e-4 of JAX's (tests/test_torch_port_model.py);
  * the bf16 trunks: each package's relative L2 error against its own
    float32 trunk, the port's at most twice JAX's (bf16 rounds at other
    places in the two: XLA fuses the BN affine and the residual add
    without rounding in between, torch rounds after each op);
  * a forward under the default recipe, handed JAX's base features,
    supports and proposals: the head's outputs within 2e-3.
"""

import dataclasses
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

from test_torch_port_cli import _argv, synth_root  # noqa: E402,F401
from test_torch_port_model import SMALL, _caffe_like, _leaves  # noqa: E402
from test_torch_port_profile import STAGES, _tool  # noqa: E402

from dana_tpu.models import dana as jdana  # noqa: E402
from dana_tpu.models import resnet as jresnet  # noqa: E402
from dana_tpu.models import vgg as jvgg  # noqa: E402
from dana_tpu.models.layers import avg_pool as jax_avg_pool  # noqa: E402
from dana_tpu.models.layers import to_jnp  # noqa: E402
from dana_tpu.ops import cisa_attention as jca  # noqa: E402

from dana_tpu_torch.engine.predict import Predictor  # noqa: E402
from dana_tpu_torch.engine.train import Trainer  # noqa: E402
from dana_tpu_torch.models import dana as tdana  # noqa: E402
from dana_tpu_torch.models import frameworks as tfw  # noqa: E402
from dana_tpu_torch.models.layers import init_conv  # noqa: E402
from dana_tpu_torch.models import rpn as trpn  # noqa: E402
from dana_tpu_torch.models import vgg as tvgg  # noqa: E402
from dana_tpu_torch.ops import cisa_attention as tca  # noqa: E402
from dana_tpu_torch.ops import roi_align as tra  # noqa: E402
from dana_tpu_torch.utils import config as tcfg  # noqa: E402
from dana_tpu_torch.utils import weights as tweights  # noqa: E402
from dana_tpu_torch.utils.weights import from_jax_params  # noqa: E402

jra = importlib.import_module('dana_tpu.ops.roi_align')

BF16 = torch.bfloat16
ULP = 2.0 ** -7          # one bf16 ulp, relative to the output's scale
HEAD_TOL = 1e-4
FORWARD_TOL = 2e-3
DTYPE_KEYS = ('COMPUTE_DTYPE', 'ATTENTION_DTYPE', 'HEAD_DTYPE',
              'PARAM_DTYPE')


def _bf16(x):
    """numpy float32 -> (torch bf16, the same values as a JAX bf16 array)."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(BF16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _within_ulp(name, got, want):
    got, want = _np(got), _np(want)
    err, tol = np.abs(got - want).max(), ULP * np.abs(want).max()
    print(f'{name}: max |port - JAX| {err:.3e}, tolerance {tol:.3e}')
    assert err <= tol


def _dtype_name(dt):
    """A torch or JAX dtype (or None) -> 'float32', 'bfloat16' or None."""
    if dt is None:
        return None
    return str(dt).split('.')[-1] if isinstance(dt, torch.dtype) \
        else jnp.dtype(dt).name


# --------------------------------------------------------------- config

def test_config_keys_match_jax():
    from dana_tpu.utils.config import cfg
    tree = tcfg.default_cfg()
    for key in DTYPE_KEYS:
        assert tree.TPU[key] == cfg.TPU[key], key


# the four settings of tests/test_precision_islands.py test_cfg_plumbing
# and its docstring: the defaults, its override, the pure bf16 recipe and
# the attention island
SETTINGS = {
    'defaults': {},
    'head_follows_attention_bf16': {'HEAD_DTYPE': '',
                                    'ATTENTION_DTYPE': 'bfloat16'},
    'pure_bf16': {'COMPUTE_DTYPE': 'bfloat16', 'HEAD_DTYPE': 'bfloat16'},
    'attention_island': {'COMPUTE_DTYPE': 'bfloat16',
                         'ATTENTION_DTYPE': 'float32'},
}


@pytest.mark.parametrize('setting', SETTINGS)
def test_dana_config_maps_like_jax(monkeypatch, setting):
    import utils as cli_utils
    from dana_tpu.utils.config import cfg
    tree = tcfg.default_cfg()
    for key, value in SETTINGS[setting].items():
        monkeypatch.setitem(cfg.TPU, key, value)
        tree.TPU[key] = value
    kw = cli_utils.model_config_kwargs(2, 2)
    jconf = jdana.DanaConfig(**kw)
    tconf = tcfg.dana_config(tree, 2, 2)
    for field in ('compute_dtype', 'attention_dtype', 'head_dtype',
                  'attention_dt', 'head_dt'):
        assert _dtype_name(getattr(tconf, field)) == \
            _dtype_name(getattr(jconf, field)), field


def test_unknown_dtype_names_are_refused():
    from dana_tpu_torch.utils import args as targs
    with pytest.raises(ValueError, match='TPU.*_DTYPE'):
        tcfg.dtype_or_none('float16')
    args = targs.parse_args(['--dataset', 'synth', '--set',
                             'TPU.HEAD_DTYPE', 'fp32'])
    with pytest.raises(SystemExit, match='unknown dtype'):
        targs.load_cfg(args)
    with pytest.raises(ValueError, match='compute_dtype'):
        tdana.DanaConfig(compute_dtype=torch.float16)


# -------------------------------------------------------------- kernels

def _cisa_inputs(g, s, nq, ns, d, c, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(g, s, ns))
    u = np.exp(u - u.max(-1, keepdims=True))
    u /= u.sum(-1, keepdims=True)
    return [_bf16(x) for x in (rng.normal(size=(g, nq, d)),
                                rng.normal(size=(g, s, ns, d)),
                                rng.normal(size=(g, s, ns, c)), u)]


@pytest.mark.parametrize('jax_fn', ['xla', 'pallas_interpret'])
def test_cisa_shots_plain_bf16_matches_jax(jax_fn):
    """K1's plain bf16 version against JAX's XLA path and its Pallas
    kernel (in interpret mode on the CPU), on the same bf16 inputs."""
    (q, jq), (k, jk), (v, jv), (u, ju) = _cisa_inputs(2, 3, 40, 23, 32, 48)
    scale, gamma = 32 ** -0.5, 0.1
    if jax_fn == 'xla':
        want = jca.cisa_attention_shots_xla(jq, jk, jv, ju, scale, gamma)
    else:
        want = jca._fused_shots(jq, jk, jv, ju, scale, gamma, block_q=16)
    got = tca.cisa_attention_shots(q, k, v, u, scale, gamma)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    _within_ulp(f'cisa_attention_shots bf16 vs {jax_fn}', got, want)


def test_cisa_single_plain_bf16_matches_jax():
    """K4 (S = 1) in bf16: the port's cisa_attention on the CPU against
    JAX's cisa_attention (its Pallas kernel, interpreted)."""
    (q, jq), (k, jk), (v, jv), (u, ju) = _cisa_inputs(2, 1, 40, 23, 32, 48,
                                                      seed=1)
    want = jca.cisa_attention(jq, jk[:, 0], jv[:, 0], ju, 0.25, 0.1)
    got = tca.cisa_attention(q, k[:, 0].contiguous(), v[:, 0].contiguous(),
                             u, 0.25, 0.1)
    assert got.dtype == BF16
    _within_ulp('cisa_attention bf16', got, want)


def test_cisa_plain_float32_unchanged():
    """The float32 plain version is the casts-free arithmetic it was."""
    (q, _), (k, _), (v, _), (u, _) = _cisa_inputs(1, 2, 9, 7, 16, 8)
    q, k, v, u = (t.float() for t in (q, k, v, u))
    scores = torch.einsum('gqd,gsnd->gsqn', q, k) * 0.25
    probs = torch.softmax(scores, -1) + 0.1 * u[:, :, None, :]
    want = torch.einsum('gsqn,gsnc->gsqc', probs, v).mean(1)
    assert torch.equal(tca.cisa_attention_shots_plain(q, k, v, u, 0.25, 0.1),
                       want)


def test_roi_align_plain_bf16_matches_jax():
    """K2's plain bf16 version (JAX's combine path) against JAX's
    roi_align on the same bf16 map and bf16-rounded rois, as the model
    hands them (`rois.astype(compute_dtype)`).  JAX runs op by op here
    (`jax.disable_jit`): under jit XLA turns extent / pooled into a product
    with the reciprocal (ROADMAP Queue C, C3), and bf16-rounded rois put
    samples exactly on the map's edge often enough (roi 7 of image 0 here:
    y = 10.0 on a 10-row map) that this ulp decides whether a sample
    counts.  The port divides in IEEE arithmetic, as the reference CUDA
    kernel and the K2 kernels do."""
    rng = np.random.default_rng(2)
    feat, jfeat = _bf16(rng.normal(size=(2, 10, 12, 24)))
    edge = np.array([[0, -40, -30, 60, 50], [0, 150, 140, 260, 230],
                     [0, 30, 30, 30.4, 30.2], [0, 0, 0, 191, 159]])
    xy = rng.random((2, 13, 2)) * 170
    wh = rng.random((2, 13, 2)) * 90 + 2
    boxes = np.concatenate([np.zeros((2, 13, 1)), xy, xy + wh], -1)
    rois, jrois = _bf16(np.concatenate([np.broadcast_to(edge, (2, 4, 5)),
                                        boxes], 1))
    with jax.disable_jit():
        want = jra.roi_align(jfeat, jrois, 7, 1 / 16.0, 0)
    got = tra.roi_align(feat, rois, 7, 1 / 16.0)
    assert got.dtype == BF16 and got.shape == (2, 17, 7, 7, 24)
    _within_ulp('roi_align bf16', got, want)


def test_pool14_sums_bf16_in_float32():
    """The support AvgPool2d(14) in bf16 is the float32 mean of the bf16
    values, rounded once (one ulp).  XLA on the CPU sums a bf16
    reduce_window in bf16 (dana_tpu/models/layers.py avg_pool): on 196
    values of mean 3 it lands ~0.18 from the float32 mean, where a bf16
    ulp is 0.0078, so JAX's CPU result is not the reference here."""
    rng = np.random.default_rng(3)
    x, jx = _bf16(rng.normal(3.0, 1.0, (2, 20, 20, 8)))
    got = tdana.pool14(x)
    assert got.dtype == BF16
    want = torch.nn.functional.avg_pool2d(
        x.float().permute(0, 3, 1, 2), 14, 1).permute(0, 2, 3, 1)
    err = (got.float() - want).abs().max().item()
    jax_gap = np.abs(_np(jax_avg_pool(jx, 14, 1)) - want.numpy()).max()
    print(f'pool14 bf16: max |port - float32 mean| {err:.3e}; JAX on the '
          f'CPU {jax_gap:.3e}')
    assert err <= ULP * want.abs().max().item()


# ----------------------------------------------------------------- model

@pytest.fixture(scope='module')
def small():
    jconf = jdana.DanaConfig(use_pallas_attention=False, **SMALL)
    tconf = tdana.DanaConfig(**SMALL)
    params = _caffe_like(jdana.init_params(jconf, seed=3), seed=4)
    return jconf, tconf, params, from_jax_params(params, tconf)


def _recipe(jconf, tconf, **islands):
    """The configs at bf16 compute with `islands` (field -> 'float32',
    'bfloat16' or None) in both packages."""
    jkw = {k: None if v is None else getattr(jnp, v)
           for k, v in islands.items()}
    tkw = {k: None if v is None else getattr(torch, v)
           for k, v in islands.items()}
    return (dataclasses.replace(jconf, compute_dtype=jnp.bfloat16, **jkw),
            dataclasses.replace(tconf, compute_dtype=BF16, **tkw))


def test_head_island_matches_f32_head(small):
    """rcnn_head with float32 attention and head islands under bf16
    compute is the float32 head, bit for bit (as JAX's
    test_head_island_matches_f32_head), and within 1e-4 of JAX's."""
    jconf, tconf, params, model = small
    jisl, tisl = _recipe(jconf, tconf, attention_dtype='float32',
                         head_dtype='float32')
    rng = np.random.default_rng(7)
    b, r, p, c = 1, 16, tconf.pooling_size, tconf.feat_dim
    pooled = rng.normal(size=(b, r, p, p, c)).astype(np.float32)
    sup = rng.normal(size=(b, tconf.n_shot, p, p, c)).astype(np.float32)
    with torch.inference_mode():
        ref = tdana.rcnn_head(model, tconf, torch.from_numpy(pooled),
                              torch.from_numpy(sup))
        got = tdana.rcnn_head(model, tisl, torch.from_numpy(pooled),
                              torch.from_numpy(sup))
    for a, g in zip(ref, got):
        assert g.dtype == torch.float32 and torch.equal(a, g)
    pe = jnp.asarray(jdana.positional_encoding(p * p, c), jnp.float32)
    want = jdana.rcnn_head(to_jnp(params), jisl, jnp.asarray(pooled),
                           jnp.asarray(sup), pe)
    for name, a, w in zip(('bbox_pred', 'cls_prob', 'cls_score'), got, want):
        err = np.abs(a.numpy() - _np(w)).max()
        print(f'float32 head island {name}: max |port - JAX| {err:.3e}')
        np.testing.assert_allclose(a.numpy(), _np(w), rtol=HEAD_TOL,
                                   atol=HEAD_TOL)


def _rel_l2(a, b):
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize('arch', ['resnet50', 'vgg16'])
def test_trunk_bf16_error_within_twice_jax(small, arch):
    """The trunk in bf16 (float32 weights cast per layer): each package's
    relative L2 error against its own float32 trunk, the port's at most
    twice JAX's."""
    rng = np.random.default_rng(5)
    x32 = rng.normal(0, 50, (1, 64, 96, 3)).astype(np.float32)
    xt, xj = _bf16(x32)
    if arch == 'resnet50':
        _, _, params, model = small
        trunk = model.backbone
        pj = to_jnp(params['backbone'])

        def jax_base(x):
            return jresnet.base_forward(x, pj)
    else:
        # the convolutions only, drawn as vgg.init_params draws them (its
        # fc6 / fc7, 119M weights, are not the trunk)
        rng, cin, convs = np.random.default_rng(5), 3, {}
        for idx, cout in zip(tvgg.CONV_IDX,
                             [v for v in tvgg._CFG if v != 'M']):
            convs[str(idx)] = init_conv(rng, 3, 3, cin, cout, bias=True)
            cin = cout
        features = {'features': convs}
        trunk = tvgg.VGG16()
        missing = trunk.load_state_dict(
            {k: tweights._from_jax_layout(v) for k, v in _leaves(features)},
            strict=False).missing_keys
        assert all(k.startswith('classifier.') for k in missing)
        pj = to_jnp(features)

        def jax_base(x):
            return jvgg.base_forward(x, pj)
    with torch.inference_mode():
        t32 = trunk.base(torch.from_numpy(x32))
        t16 = trunk.base(xt)
    jax_base = jax.jit(jax_base)
    j32, j16 = jax_base(jnp.asarray(x32)), jax_base(xj)
    assert t16.dtype == BF16 and j16.dtype == jnp.bfloat16
    err_t, err_j = _rel_l2(t16, t32), _rel_l2(j16, j32)
    print(f'{arch} bf16 trunk: relative L2 error against float32, port '
          f'{err_t:.3e}, JAX {err_j:.3e}')
    assert 0 < err_t <= 2 * err_j


def _torch_bf16(x):
    """A JAX array -> torch bf16 of the same values."""
    return torch.from_numpy(_np(x)).to(BF16)


def test_default_recipe_forward_on_jax_features(small, monkeypatch):
    """An eval forward under the default recipe (bf16 trunk and attention,
    float32 head), handed JAX's bf16 base features, bf16 supports and
    proposals: its attention sites, RPN, RoIAlign (K2's plain bf16) and
    float32 head give JAX's head outputs within 2e-3."""
    jconf, tconf, params, model = small
    jrec, trec = _recipe(jconf, tconf, head_dtype='float32')
    rng = np.random.default_rng(0)
    q = rng.integers(0, 256, (1, 128, 160, 3)).astype(np.uint8)
    # 256 px supports: 256 tokens at the RPN site, 3 x 3 at the RoI site
    sup = rng.normal(0, 50, (1, 2, 256, 256, 3)).astype(np.float32)
    info = np.array([[120, 150, 0.9]], np.float32)
    pj = to_jnp(params)
    jsup = jax.jit(jdana.extract_support_feats, static_argnums=1)(
        pj, jrec, jnp.asarray(sup))
    jbase = jax.jit(jdana.backbone_base, static_argnums=1)(
        pj, jrec, jdana.prep_query_images(jrec, jnp.asarray(q)).astype(
            jnp.bfloat16))
    jo = jax.jit(jdana.forward, static_argnums=1,
                 static_argnames='training')(
        pj, jrec, jnp.asarray(q), jnp.asarray(info), training=False,
        support_feats=jsup)
    assert jbase.dtype == jnp.bfloat16 and jo['cls_prob'].dtype == jnp.float32

    base = _torch_bf16(jbase)
    rois = torch.from_numpy(np.array(jo['rois'], np.float32))
    mask = torch.from_numpy(np.array(jo['roi_mask']))
    monkeypatch.setattr(tdana, 'query_features', lambda *a: base)
    monkeypatch.setattr(trpn, 'proposal_layer',
                        lambda *a, **k: (rois, None, mask))
    with torch.inference_mode():
        to = tdana.forward(model, trec, torch.from_numpy(q),
                           torch.from_numpy(info),
                           support_feats=tuple(_torch_bf16(f) for f in jsup))
    assert torch.equal(to['rois'], rois) and to['rois'].dtype == torch.float32
    for key in ('cls_prob', 'bbox_pred'):
        got, want = to[key], _np(jo[key])
        err = np.abs(got.numpy() - want).max()
        print(f'default recipe {key}: max |port - JAX| {err:.3e}')
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=FORWARD_TOL)


def test_predictor_serves_the_recipe(small):
    """Predictor under the default recipe on the CPU: the support cache
    in compute_dtype, float32 detections."""
    _, tconf, _, model = small
    trec = dataclasses.replace(tconf, compute_dtype=BF16,
                               head_dtype=torch.float32)
    pred = Predictor(model, trec, device='cpu')
    rng = np.random.default_rng(1)
    feat, pooled = pred.encode_supports(
        3, rng.normal(0, 50, (2, 224, 224, 3)).astype(np.float32))
    assert feat.dtype == pooled.dtype == BF16
    q = rng.integers(0, 256, (1, 128, 160, 3)).astype(np.uint8)
    info = np.array([[128, 160, 1.0]], np.float32)
    dets, valid = pred.predict(q, info, [3])
    assert dets.dtype == torch.float32 and dets.shape == (1, 100, 5)
    assert torch.isfinite(dets).all() and valid.dtype == torch.bool


@pytest.mark.parametrize('head', ['float32', 'bfloat16'])
@pytest.mark.parametrize('name', ['fsod', 'meta', 'fgn', 'frcnn'])
def test_sibling_framework_islands(name, head):
    """Every sibling under bf16 compute with the float32 head island (JAX's
    test_sibling_framework_islands) and in pure bf16: finite head outputs
    in the head's dtype."""
    config, params = tcfg.get_model(name, way=2, shot=2, seed=0)
    config = dataclasses.replace(
        config, test_pre_nms=200, test_post_nms=16, nms_cap=200,
        compute_dtype=BF16, head_dtype=getattr(torch, head))
    model = from_jax_params(params, config)
    rng = np.random.default_rng(13)
    im = torch.from_numpy(rng.normal(size=(1, 128, 160, 3)).astype(
        np.float32) * 30)
    sup = torch.from_numpy(rng.normal(size=(1, 2, 320, 320, 3)).astype(
        np.float32) * 30)
    with torch.inference_mode():
        out = tfw.forward(model, config, im, torch.tensor([[128., 160, 1]]),
                          support_ims=None if name == 'frcnn' else sup)
    for key in ('cls_prob', 'bbox_pred'):
        assert out[key].dtype == config.head_dt, key
        assert torch.isfinite(out[key]).all(), key


def test_profile_tool_breaks_the_recipe_down():
    """tools/profile_torch_predict.py's --set builds the recipe, and a
    request under it opens every `dana.*` stage range the tool reads."""
    config, params = _tool().model_for(
        'DAnA', 'res50', ['TPU.COMPUTE_DTYPE', 'bfloat16',
                          'TPU.HEAD_DTYPE', 'bfloat16'], 3)
    assert (config.compute_dtype, config.attention_dt, config.head_dt) == \
        (BF16, BF16, BF16)
    pred = Predictor(params, dataclasses.replace(
        config, test_pre_nms=200, test_post_nms=16), device='cpu')
    rng = np.random.default_rng(4)
    pred.encode_supports(0, rng.normal(0, 50, (3, 224, 224, 3))
                         .astype(np.float32))
    q = rng.integers(0, 256, (1, 96, 128, 3)).astype(np.uint8)
    info = np.array([[96, 128, 1.0]], np.float32)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        pred.predict(q, info, [0])
    assert {e.key for e in prof.key_averages()
            if e.key.startswith('dana.')} == STAGES


# ------------------------------------------------- training in the recipe

def _small_batch():
    rng = np.random.default_rng(9)
    gt = np.zeros((1, 2, 5), np.float32)
    gt[0, 0] = [10, 10, 90, 70, 1]
    return dict(im_data=rng.integers(0, 256, (1, 128, 160, 3))
                .astype(np.uint8),
                im_info=np.array([[128, 160, 1.0]], np.float32),
                gt_boxes=gt, support_ims=rng.normal(0, 50, (1, 2, 224, 224,
                                                            3))
                .astype(np.float32))


@pytest.mark.parametrize('keys', [['TPU.COMPUTE_DTYPE', 'bfloat16'],
                                  ['TPU.ATTENTION_DTYPE', 'bfloat16']])
def test_training_runs_bf16(synth_root, keys):
    """The Trainer and the training CLI train in the recipe's settings
    (the refusal of ROADMAP Queue A 6 is gone): the CLI's setup builds a
    trainer in those dtypes, and a step on the CPU gives finite losses,
    skips nothing and leaves the parameters and momentum float32."""
    from dana_tpu_torch import train as ttrain
    from test_torch_port_train import SMALL
    _, _, cli_trainer, _ = ttrain.setup(ttrain.parse_args(
        ['--dataset', 'synth_test', '--device', 'cpu', '--way', '2',
         '--shot', '1', '--bs', '1', '--nw', '1', '--set', *keys]))
    tree = tcfg.default_cfg()
    tcfg.cfg_from_list(tree, keys)
    config = tcfg.dana_config(tree, 2, 1)
    for field in ('compute_dtype', 'attention_dt', 'head_dt'):
        assert getattr(cli_trainer.config, field) == getattr(config, field)
    config = dataclasses.replace(config, **SMALL)
    trainer = Trainer(tdana.init_params(config, seed=0), config,
                      device='cpu')
    m = trainer.step(_small_batch())
    assert m['skipped'].item() == 0.0 and torch.isfinite(m['loss'])
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    assert all(s['momentum_buffer'].dtype == torch.float32
               for s in trainer.optimizer.state.values())


@pytest.mark.parametrize('mode', ['pool', 'crop'])
def test_pool_and_crop_run_in_bf16(mode):
    """POOLING_MODE pool and crop under bf16 compute (the refusal of
    ROADMAP Queue A 6 is gone): the configs build, and the default recipe
    serves a request and takes a training step with finite results, its
    pooled features reaching the float32 head."""
    from dana_tpu_torch.utils import args as targs
    from test_torch_port_train import SMALL
    args = targs.parse_args(['--dataset', 'synth', '--set', 'POOLING_MODE',
                             mode, 'TPU.COMPUTE_DTYPE', 'bfloat16'])
    tree = targs.load_cfg(args)
    config = dataclasses.replace(tcfg.dana_config(tree, 2, 1), **SMALL)
    assert (config.pooling_mode, config.compute_dtype, config.head_dt) == \
        (mode, BF16, torch.float32)
    params = tdana.init_params(config, seed=0)
    pred = Predictor(params, config, device='cpu')
    rng = np.random.default_rng(5)
    pred.encode_supports(0, rng.normal(0, 50, (1, 224, 224, 3))
                         .astype(np.float32))
    batch = _small_batch()
    dets, _ = pred.predict(batch['im_data'], batch['im_info'], [0])
    assert dets.dtype == torch.float32 and torch.isfinite(dets).all()
    trainer = Trainer(params, config, device='cpu')
    m = trainer.step(batch)
    assert m['skipped'].item() == 0.0 and torch.isfinite(m['loss'])


# ------------------------------------------------------------------ CLI

def test_dataset_cli_serves_the_recipe(synth_root, tmp_path):
    """`python -m dana_tpu_torch.inference ... --set TPU.COMPUTE_DTYPE
    bfloat16` on the CPU (tests/test_torch_port_cli.py's small settings):
    every image's detections finite, 12 finite COCOeval stats."""
    from dana_tpu_torch import inference as port_cli
    result = port_cli.main(_argv(tmp_path, '--device', 'cpu')
                           + ['TPU.COMPUTE_DTYPE', 'bfloat16'])
    stats = np.asarray(result['stats'], np.float64)
    assert stats.shape == (12,) and np.isfinite(stats).all()
    assert result['timing']['images'] == 20
