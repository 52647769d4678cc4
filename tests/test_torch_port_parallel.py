"""The port's data, tensor and spatial parallelism (dana_tpu_torch/parallel)
on the CPU, in one process whose device lists name the CPU several times
(['cpu', 'cpu']), as a one-card run names 'cuda:0' twice: the halo
convolutions and pools against F.conv2d / F.max_pool2d at every window of
the ResNet and VGG16 trunks, the spatially sharded trunks, the TP column
layers, a Predictor on dp, tp and sp grids against the unsharded one (JAX's
tests/test_parallel.py bounds) and against JAX's predict_step on a
4-device CPU mesh, the refusals, a `shard_state_tp` training step against
the unsharded step, and the dataset CLI's --mGPUs, --tp and --sp.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dana_tpu.engine import train as jtrain
from dana_tpu.models import dana as jdana
from dana_tpu.models.layers import to_jnp

from dana_tpu_torch import parallel
from dana_tpu_torch.engine.predict import Predictor
from dana_tpu_torch.engine.train import Trainer
from dana_tpu_torch.models import dana as tdana
from dana_tpu_torch.models import layers as tlayers
from dana_tpu_torch.models import resnet as tresnet
from dana_tpu_torch.models import vgg as tvgg
from dana_tpu_torch.parallel import spatial
from test_torch_port_model import _caffe_like
from test_torch_port_train import SMALL, _batch, jax_step_draws

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU2 = ['cpu', 'cpu']
# tests/test_parallel.py's config
CFG = dict(n_way=2, n_shot=2, train_pre_nms=200, train_post_nms=32,
           test_pre_nms=200, test_post_nms=16, nms_cap=200,
           rois_per_image=16, rpn_batchsize=32)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _whole(model):
    """The module's parameters by name, each ColumnParallel's shards
    concatenated into its whole layer's ('x.shards.i.weight' -> 'x.weight')."""
    shards = {}
    for name, p in model.named_parameters():
        head, sep, tail = name.rpartition('shards.')
        key = head + tail.split('.', 1)[1] if sep else name
        shards.setdefault(key, []).append(p.detach())
    return {k: torch.cat(v) for k, v in shards.items()}


def _blocks(x, n):
    """NCHW x split into n row blocks as the spatial trunk splits it."""
    b = spatial.bounds(x.shape[2], n)
    return [x[:, :, b[i]:b[i + 1]] for i in range(n)]


# (k, s, p) of every convolution of a bottleneck ResNet (the stem, the 1x1s,
# the 3x3s, the caffe-style stride-2 1x1 conv1 and its downsample) and of
# VGG16 (3x3 / 1 / 1)
CONVS = [(7, 2, 3), (1, 1, 0), (3, 1, 1), (1, 2, 0)]
POOLS = [(3, 2, True), (2, 2, False)]     # ResNet's stem pool, VGG16's


@pytest.mark.parametrize('n', [2, 3])
@pytest.mark.parametrize('h', [24, 31])
@pytest.mark.parametrize('kind', ['conv', 'pool'])
def test_halo_windows_match_the_whole_map(kind, h, n):
    """Every window of the trunks on row blocks (3 blocks of 31 rows: the
    blocks are uneven) gives the whole map's output rows, bit for bit."""
    g = torch.Generator().manual_seed(h * n)
    x = torch.randn(2, 5, h, 9, generator=g)
    xs = _blocks(x, n)
    if kind == 'conv':
        for k, s, p in CONVS:
            conv = tlayers.Conv2d(5, 4, k, s, p, bias=True)
            want = conv(x)
            got = torch.cat(spatial.halo_conv(xs, [conv] * n), dim=2)
            assert got.shape == want.shape, (k, s, p)
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    else:
        for k, s, ceil in POOLS:
            want = F.max_pool2d(x, k, s, 0, ceil_mode=ceil)
            got = torch.cat(spatial.halo_max_pool(xs, k, s, ceil), dim=2)
            assert got.shape == want.shape, (k, s, ceil)
            torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_out_rows_is_pytorchs():
    for h in range(3, 40):
        for k, s, ceil in POOLS:
            assert spatial.out_rows(h, k, s, 0, ceil) == F.max_pool2d(
                torch.zeros(1, 1, h, 1), (k, 1), (s, 1),
                ceil_mode=ceil).shape[2], (h, k, s, ceil)
        for k, s, p in CONVS:
            if h + 2 * p >= k:
                assert spatial.out_rows(h, k, s, p) == \
                    (h + 2 * p - k) // s + 1


def _trunk(arch):
    m = tvgg.VGG16() if arch == 'vgg16' else tresnet.ResNet(arch)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
        for name, b in m.named_buffers():
            if name.endswith('running_var'):
                b.uniform_(0.5, 1.5, generator=g)
    return m


@pytest.mark.parametrize('arch', ['resnet50', 'resnet101', 'resnet152',
                                  'vgg16'])
def test_spatial_trunk_equals_the_trunk(arch):
    """The trunk's base on 2 row blocks of a 64x48 query (and 3 blocks of
    96 rows) gathered on the lead device equals `base` of the whole."""
    m = _trunk(arch)
    g = torch.Generator().manual_seed(2)
    for hw, n in (((64, 48), 2), ((96, 32), 3)):
        x = torch.randn(2, *hw, 3, generator=g) * 40
        with torch.inference_mode():
            want = m.base(x)
            got = spatial.spatial_base(
                [m] * n, parallel.shard_query_spatial(x, ['cpu'] * n))
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('layer', ['linear', 'conv'])
def test_column_parallel_equals_the_whole_layer(layer):
    """A layer split by output channel over two devices computes the whole
    layer, forward and backward, and merges back to it."""
    g = torch.Generator().manual_seed(3)
    if layer == 'linear':
        whole = tlayers.Linear(12, 8)
        x = torch.randn(3, 5, 12, generator=g, requires_grad=True)
    else:
        whole = tlayers.Conv2d(6, 8, 3, 1, 1)
        x = torch.randn(2, 6, 7, 5, generator=g, requires_grad=True)
    col = parallel.ColumnParallel(whole, CPU2)
    want = whole(x)
    got = col(x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    c = torch.randn(want.shape, generator=g)
    gx, gw = torch.autograd.grad((want * c).sum(), [x, whole.weight])
    hx, *hw = torch.autograd.grad((got * c).sum(),
                                  [x] + [s.weight for s in col.shards])
    torch.testing.assert_close(hx, gx, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(torch.cat(hw), gw, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(_whole(col)['weight'], whole.weight, rtol=0,
                               atol=0)
    assert col.to('cpu') is col


def test_tp_spec_splits_only_the_wide_layers():
    """JAX's `_tp_spec`: only the six named layers' weights, only where
    their output divides the model extent; shard_params_tp keeps every
    parameter of a detector, split by output channel."""
    conf = tdana.DanaConfig(**SMALL)
    w = torch.zeros(256, 1024)
    assert parallel._tp_spec('rpn_adapt_q_layer.weight', w, 2) == 0
    assert parallel._tp_spec('rpn_adapt_q_layer.bias', w[0], 2) is None
    assert parallel._tp_spec('rpn_adapt_q_layer.weight', w, 3) is None
    assert parallel._tp_spec('RCNN_bbox_pred.weight', w, 2) is None
    assert parallel._tp_spec('RCNN_rpn.RPN_Conv.weight',
                             torch.zeros(512, 4, 3, 3), 4) == 0
    model = tdana.DAnA(conf)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    parallel.shard_params_tp(model, CPU2)
    split = [n for n, m in model.named_modules()
             if isinstance(m, parallel.ColumnParallel)]
    assert sorted(split) == sorted([
        'rpn_adapt_q_layer', 'rpn_adapt_k_layer', 'rcnn_adapt_q_layer',
        'rcnn_adapt_k_layer', 'RCNN_rpn.RPN_Conv',
        'output_score_layer.linear1'])
    after = _whole(model)
    assert after.keys() == before.keys()
    for k in before:
        assert torch.equal(after[k], before[k]), k


# ------------------------------------------------------------- serving

@pytest.fixture(scope='module')
def request_data():
    rng = np.random.default_rng(0)
    conf = tdana.DanaConfig(**CFG)
    params = tdana.init_params(conf, seed=0)
    q = rng.normal(0, 40, (4, 128, 160, 3)).astype(np.float32)
    info = np.tile(np.array([[128.0, 160.0, 1.0]], np.float32), (4, 1))
    sup = rng.normal(0, 40, (2, 224, 224, 3)).astype(np.float32)
    pred = Predictor(params, conf, device='cpu')
    pred.encode_supports(1, sup)
    want = pred.forward(q, info, [1] * 4)
    dets = pred.predict(q, info, [1] * 4)
    return conf, params, q, info, sup, want, dets


@pytest.mark.parametrize('grid', [
    dict(devices=CPU2), dict(devices=CPU2, tp=2), dict(devices=CPU2, sp=2),
    dict(devices=['cpu'] * 4, tp=2), dict(devices=['cpu'] * 4, sp=2)],
    ids=['dp2', 'tp2', 'sp2', 'dp2xtp2', 'dp2xsp2'])
def test_predictor_on_a_grid_matches_one_device(request_data, grid):
    """cls_prob at rtol 1e-4 / atol 1e-5 and rois at atol 1e-3 (JAX's
    tests/test_parallel.py bounds), and the detections tie-aware."""
    from test_torch_port_model import _match_detections
    conf, params, q, info, sup, want, dets = request_data
    pred = Predictor(params, conf, device='cpu', **grid)
    pred.encode_supports(1, sup)
    got = pred.forward(q, info, [1] * 4)
    np.testing.assert_allclose(got['cls_prob'].numpy(),
                               want['cls_prob'].numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got['rois'].numpy(), want['rois'].numpy(),
                               rtol=1e-4, atol=1e-3)
    d, v = pred.predict(q, info, [1] * 4)
    for i in range(4):
        _match_detections(d[i][v[i]].numpy(), dets[0][i][dets[1][i]].numpy())


def test_dp_forward_matches_jax_mesh_predict_step():
    """The port's data-parallel forward over 4 devices against JAX's
    predict_step on a 4-device CPU mesh (both on the same Caffe-magnitude
    weights): rois within the port's 2e-3 px budget against JAX, heads
    within 1e-4 (tests/test_torch_port_model.py's bounds)."""
    jconf = jdana.DanaConfig(use_pallas_attention=False, **CFG)
    tconf = tdana.DanaConfig(**CFG)
    params = _caffe_like(jdana.init_params(jconf, seed=3), seed=4)
    rng = np.random.default_rng(1)
    q = rng.normal(0, 40, (4, 128, 160, 3)).astype(np.float32)
    info = np.tile(np.array([[128.0, 160.0, 1.0]], np.float32), (4, 1))
    sup = rng.normal(0, 40, (2, 224, 224, 3)).astype(np.float32)
    mesh = jtrain.make_mesh(jax.devices()[:4])
    sb = jtrain.shard_batch(
        {'im_data': jnp.asarray(q), 'im_info': jnp.asarray(info),
         'support_ims': jnp.broadcast_to(jnp.asarray(sup)[None],
                                         (4, *sup.shape))}, mesh)
    step = jax.jit(jtrain.predict_step, static_argnums=1)
    jo = step(jtrain.replicate(to_jnp(params), mesh), jconf, sb['im_data'],
              sb['im_info'], sb['support_ims'])
    pred = Predictor(params, tconf, device='cpu', devices=['cpu'] * 4)
    pred.encode_supports(1, sup)
    to = pred.forward(q, info, [1] * 4)
    np.testing.assert_allclose(to['rois'].numpy(), np.asarray(jo['rois']),
                               rtol=0, atol=2e-3)
    for k in ('cls_prob', 'bbox_pred'):
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


def test_refusals():
    """JAX's texts: --tp with --sp, H % n under --sp, grid extents that do
    not tile the devices; a request that does not split over the data
    rows."""
    conf = tdana.DanaConfig(**CFG)
    with pytest.raises(ValueError, match='pick one latency mode'):
        Predictor(None, conf, device='cpu', devices=CPU2, tp=2, sp=2)
    with pytest.raises(ValueError, match='H % 2 == 0, got H=7'):
        parallel.shard_query_spatial(torch.zeros(1, 7, 4, 3), CPU2)
    with pytest.raises(ValueError, match='divide the device count'):
        parallel.make_mesh_2d(['cpu'] * 4, model=3)
    with pytest.raises(ValueError, match='do not tile 4 devices'):
        parallel.make_mesh_dcn(3, ['cpu'] * 4)
    assert parallel.make_mesh_2d(['cpu'] * 8, data=8).shape == \
        {'data': 8, 'model': 1}
    assert parallel.make_mesh_2d(['cpu'] * 8).shape == {'data': 4,
                                                         'model': 2}
    g = parallel.make_mesh_dcn(2, ['cpu'] * 4)
    assert g.shape == {'slice': 2, 'data': 2}
    assert parallel.make_mesh(CPU2).shape == {'data': 2}
    blocks = parallel.shard_batch({'x': np.arange(8)}, g)
    assert [b['x'].tolist() for b in blocks] == [[0, 1], [2, 3], [4, 5],
                                                 [6, 7]]
    pred = Predictor(tdana.init_params(conf, seed=0), conf, device='cpu',
                     devices=CPU2)
    with pytest.raises(ValueError, match='does not split over'):
        pred.forward(np.zeros((3, 64, 64, 3), np.float32),
                     np.zeros((3, 3), np.float32), [1] * 3)


# ----------------------------------------------------------------- training

def test_shard_state_tp_step_matches_the_unsharded_step():
    """A Trainer whose wide layers are split over two devices
    (`shard_state_tp`) takes the unsharded step: the metrics (JAX's
    test_parallel bounds) and every updated parameter."""
    tconf = tdana.DanaConfig(**SMALL)
    params = _caffe_like(jdana.init_params(jdana.DanaConfig(**SMALL),
                                           seed=8), seed=9)
    batch = _batch()
    key = jax.random.fold_in(jax.random.PRNGKey(10), 0)
    n = (128 // 16) * (160 // 16) * tconf.num_anchors
    draws = jax_step_draws(key, 2, n, tconf.train_post_nms + 3,
                           tconf.rois_per_image)
    one = Trainer(params, tconf, device='cpu', lr=1e-3)
    want = one.step(batch, draws=draws)
    tp = parallel.shard_state_tp(Trainer(params, tconf, device='cpu',
                                         lr=1e-3), CPU2)
    assert any(isinstance(m, parallel.ColumnParallel)
               for m in tp.model.modules())
    got = tp.step(batch, draws=draws)
    for k in want:
        np.testing.assert_allclose(got[k].item(), want[k].item(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    ref = dict(one.model.named_parameters())
    for k, p in _whole(tp.model).items():
        np.testing.assert_allclose(p.numpy(),
                                   ref[k].detach().numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)


# -------------------------------------------------------- the dataset CLI

@pytest.fixture(scope='module')
def cli_runs(tmp_path_factory):
    """The dataset CLI over 8 synth_test images on one device, then with
    --mGPUs, --tp 2 and --sp 2 over local_devices() = ['cpu', 'cpu']."""
    from test_inference_cli import BASE_ARGS
    from dana_tpu_torch import inference as port_cli
    from dana_tpu_torch.data.synth import synth_fsod
    tmp = tmp_path_factory.mktemp('cli')
    mp = pytest.MonkeyPatch()
    mp.setenv('DANA_SYNTH_ROOT', str(tmp / 'synth'))
    synth_fsod('test', num_images=8)
    synth_fsod('train')
    s = BASE_ARGS.index('--set')
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    runs = {}
    try:
        for name, flags in (('one', []), ('mGPUs', ['--mGPUs']),
                            ('tp', ['--tp', '2']), ('sp', ['--sp', '2'])):
            if flags:
                mp.setattr(port_cli, 'local_devices',
                           lambda device='cuda': [torch.device('cpu')] * 2)
            out = tmp / name
            argv = (BASE_ARGS[:s] + ['--bs', '3', '--eval_dir', str(out),
                                     '--device', 'cpu', *flags]
                    + BASE_ARGS[s:] + ['TPU.STEM_S2D', 'False'])
            runs[name] = (out, port_cli.main(argv))
    finally:
        mp.undo()
        torch.set_num_threads(n)
    return runs


@pytest.mark.parametrize('mode', ['mGPUs', 'tp', 'sp'])
def test_dataset_cli_parallel_flags_match_one_device(cli_runs, mode):
    """--bs 3 rounds up to 4 under --mGPUs (two data devices); the
    detections equal the one-device run's, tie-aware."""
    from test_inference_cli import _assert_detections_match
    out, result = cli_runs[mode]
    _assert_detections_match(str(cli_runs['one'][0]), str(out))
    assert result['timing']['chunks'] == (2 if mode == 'mGPUs' else 3)
