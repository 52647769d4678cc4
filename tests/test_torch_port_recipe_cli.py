"""The precision recipe through the siblings' heads, the dataset CLI and the
training CLI on the port, against the JAX package on the CPU.

  * FSOD, Meta R-CNN, FGN and Faster R-CNN in the default recipe (bf16
    trunk, float32 head), handed JAX's bf16 query and support maps and
    JAX's proposals: their head outputs within FORWARD_TOL of JAX's, as
    tests/test_torch_port_precision.py holds DAnA's;
  * the dataset CLI in the recipe against the root `inference.py --set
    TPU.COMPUTE_DTYPE bfloat16`, on the JAX CLI's proposals;
  * the training CLI in the recipe: one tiny epoch, float32 checkpoints,
    and a resumed run equal to a straight one bit for bit;
  * tools/profile_torch_train.py's --set recipe opening every stage range
    of the bf16 step.
"""

import contextlib
import dataclasses
import importlib.util
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dana_tpu.models import frameworks as jfw
from dana_tpu.models import rpn as jrpn
from dana_tpu.models.layers import to_jnp

from dana_tpu_torch import train as cli
from dana_tpu_torch.engine.train import Trainer
from dana_tpu_torch.models import dana as tdana
from dana_tpu_torch.models import frameworks as tfw
from dana_tpu_torch.utils import weights as tweights
from test_torch_port_frameworks import _inputs, _pinned, jax_model, port_config
from test_torch_port_model import _caffe_like, _leaves
from test_torch_port_train_cli import (_payload, _train_argv, few_threads,  # noqa: F401
                                       no_ipp, synth_root)

BF16 = torch.bfloat16
FORWARD_TOL = 2e-3       # tests/test_torch_port_precision.py's, for DAnA
RECIPE = ['TPU.COMPUTE_DTYPE', 'bfloat16']
SCORE_TOL = 2e-2         # the dataset CLIs in the recipe (the test says why)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------- the siblings' heads

def _jax_recipe_eval(name, jconf, params, q, info, sup):
    """JAX's jitted eval forward of `name` in jconf's recipe -> (outputs,
    its base_forward results in call order: the query's maps, then the
    supports' [B*n, h, w, C])."""
    def run(p, q, info, sup):
        maps, real = [], jfw.resnet.base_forward

        def base_forward(*args, **kwargs):
            maps.append(real(*args, **kwargs))
            return maps[-1]
        jfw.resnet.base_forward = base_forward
        try:
            if name == 'frcnn':
                out = jfw.frcnn_forward(p, jconf, q, info, training=False)
            else:
                out = jfw.forward_fn(name)(p, jconf, q, info, sup,
                                           training=False)
        finally:
            jfw.resnet.base_forward = real
        return {k: out[k] for k in ('rois', 'roi_mask', 'cls_prob',
                                    'bbox_pred')}, maps
    out, maps = jax.jit(run)(to_jnp(params), jnp.asarray(q),
                             jnp.asarray(info), jnp.asarray(sup))
    return jax.tree.map(np.asarray, out), maps


def _torch_bf16(x):
    return torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(BF16)


@pytest.mark.parametrize('name', ['fsod', 'meta', 'fgn', 'frcnn'])
def test_sibling_default_recipe_forward_on_jax_features(name, monkeypatch):
    """A sibling's eval forward in the default recipe, handed JAX's bf16
    query maps, support maps and proposals: its conditioning, RoIAlign
    (K2's plain bf16 version) and float32 head give JAX's head outputs
    within FORWARD_TOL (the Queue C check that
    test_default_recipe_forward_on_jax_features makes for DAnA)."""
    jconf, params = jax_model(name, seed=3)
    params = _caffe_like(params, seed=4)
    jconf = dataclasses.replace(jconf, compute_dtype=jnp.bfloat16,
                                head_dtype=jnp.float32)
    q, info, sup = _inputs()
    jout, maps = _jax_recipe_eval(name, jconf, params, q, info, sup)
    assert maps[0].dtype == jnp.bfloat16
    assert jout['cls_prob'].dtype == np.float32

    conf = dataclasses.replace(port_config(name), compute_dtype=BF16,
                               head_dtype=torch.float32)
    model = tweights.from_jax_params(params, conf)
    base = _torch_bf16(maps[0])
    monkeypatch.setattr(tdana, 'query_features', lambda *a: base)
    if name != 'frcnn':
        flat = _torch_bf16(maps[1])
        monkeypatch.setattr(tdana, 'support_maps', lambda *a: flat.reshape(
            sup.shape[0], sup.shape[1], *flat.shape[1:]))
    rois, mask = (torch.from_numpy(np.array(jout[k]))
                  for k in ('rois', 'roi_mask'))
    with torch.inference_mode(), _pinned(rois, mask):
        out = tfw.forward(model, conf, torch.from_numpy(q),
                          torch.from_numpy(info),
                          support_ims=None if name == 'frcnn'
                          else torch.from_numpy(sup))
    for key in ('cls_prob', 'bbox_pred'):
        got, want = out[key], jout[key]
        assert got.dtype == torch.float32 and got.shape == want.shape
        err = np.abs(got.numpy() - want).max()
        print(f'{name} default recipe {key}: max |port - JAX| {err:.3e}')
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=FORWARD_TOL)


# ------------------------------------------------------ the training CLI

@pytest.fixture(scope='module')
def recipe_runs(synth_root, tmp_path_factory):
    """The training CLI in the default recipe on the 4-image synth_test:
    --epochs 2 straight, and --epochs 1 then --r --epochs 2."""
    straight = tmp_path_factory.mktemp('recipe_straight')
    split = tmp_path_factory.mktemp('recipe_split')
    s = cli.main(_train_argv(straight, '--epochs', '2') + RECIPE)
    first = cli.main(_train_argv(split, '--epochs', '1') + RECIPE)
    resumed = cli.main(_train_argv(split, '--epochs', '2', '--r',
                                   '--checkpath', first['checkpoint'])
                       + RECIPE)
    return s, first, resumed


def test_recipe_training_cli_resume_equals_straight(recipe_runs):
    """In the recipe as in float32: every loss finite and no step skipped,
    and the resumed epoch 2 equals the straight one bit for bit, losses,
    float32 parameters, float32 momentum and generator."""
    straight, _, resumed = recipe_runs
    assert all(e['skipped'] == 0 and np.isfinite(e['loss_curve']).all()
               for e in straight['epochs'] + resumed['epochs'])
    assert straight['epochs'][1]['loss_curve'] == \
        resumed['epochs'][0]['loss_curve']
    a, b = _payload(straight['checkpoint']), _payload(resumed['checkpoint'])
    for tree in ('model', 'velocity'):
        ta = a['model'] if tree == 'model' else a['optimizer']['velocity']
        tb = b['model'] if tree == 'model' else b['optimizer']['velocity']
        la, lb = dict(_leaves(ta)), dict(_leaves(tb))
        assert la.keys() == lb.keys()
        for k in la:
            assert la[k].dtype == np.float32, k
            np.testing.assert_array_equal(la[k], lb[k], err_msg=k)
    np.testing.assert_array_equal(a['extra']['generator'],
                                  b['extra']['generator'])


def test_recipe_checkpoint_loads_in_jax_and_trains_on(recipe_runs):
    """The recipe's checkpoint is the float32 `.dkpt` of the float32 runs
    (the JAX package reads it, its momentum included) and records no
    dtype: a run resumed from it trains in the precision its own --set
    names, as the JAX CLI's does."""
    from dana_tpu.utils import checkpoint as jckpt
    path = recipe_runs[0]['checkpoint']
    payload = jckpt.load_checkpoint(path)
    leaves = dict(_leaves(payload['model']))
    assert leaves and all(v.dtype == np.float32 for v in leaves.values())
    assert 'dtype' not in str(sorted(payload)) and \
        'dtype' not in str(sorted(payload.get('extra') or {}))
    _, _, trainer, start = cli.setup(cli.parse_args(
        _train_argv(os.path.dirname(path), '--epochs', '3', '--r',
                    '--checkpath', path)))
    assert start == 3 and trainer.config.compute_dtype == torch.float32


# -------------------------------------------------- the profile tool

def test_profile_tool_breaks_the_bf16_step_down():
    """tools/profile_torch_train.py's --set TPU.COMPUTE_DTYPE bfloat16 builds
    the recipe, and a step under it opens every `dana.*` stage range the
    tool reads (the float32 step's, tests/test_torch_port_profile.py)."""
    from test_torch_port_profile import STAGES, STEP_UNIT
    from test_torch_port_train import SMALL
    path = os.path.join(ROOT, 'tools', 'profile_torch_predict.py')
    spec = importlib.util.spec_from_file_location('profile_torch_predict',
                                                  path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    config, params = tool.model_for('DAnA', 'res50', RECIPE, 3)
    assert (config.compute_dtype, config.attention_dt, config.head_dt) == \
        (BF16, BF16, torch.float32)
    config = dataclasses.replace(config, **SMALL)
    trainer = Trainer(params, config, device='cpu')
    rng = np.random.default_rng(2)
    gt = np.zeros((1, 2, 5), np.float32)
    gt[0, 0] = [10, 10, 70, 60, 1]
    batch = dict(im_data=rng.integers(0, 256, (1, 96, 128, 3))
                 .astype(np.uint8),
                 im_info=np.array([[96, 128, 1.0]], np.float32), gt_boxes=gt,
                 support_ims=rng.normal(0, 50, (1, 2, 224, 224, 3))
                 .astype(np.float32))
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        m = trainer.step(batch)
    assert m['skipped'].item() == 0.0
    names = {e.key for e in prof.key_averages() if e.key.startswith('dana.')}
    assert names == (STAGES - {'dana.upload', 'dana.postprocess'}) | {
        'dana.support_trunk', 'dana.targets', 'dana.losses',
        'dana.backward', 'dana.update'} | STEP_UNIT


# ------------------------------------------------------ the dataset CLI

@contextlib.contextmanager
def _jax_proposals(record):
    """Append each call of the JAX proposal layer's (rois, mask), read back
    from inside the jitted predict, to `record`."""
    real = jrpn.proposal_layer

    def layer(*args, **kwargs):
        out = real(*args, **kwargs)
        jax.debug.callback(lambda r, m: record.append(
            (np.array(r), np.array(m))), out[0], out[2])
        return out
    jrpn.proposal_layer = layer
    try:
        yield
    finally:
        jrpn.proposal_layer = real


@contextlib.contextmanager
def _replayed(record):
    """The port's proposal layer returns `record`'s proposals, in order."""
    from dana_tpu_torch.models import rpn as trpn
    real, calls = trpn.proposal_layer, iter(record)

    def layer(*args, **kwargs):
        real(*args, **kwargs)
        rois, mask = next(calls)
        return torch.from_numpy(rois), None, torch.from_numpy(mask)
    trpn.proposal_layer = layer
    try:
        yield
    finally:
        trpn.proposal_layer = real


def test_dataset_cli_recipe_matches_jax_on_shared_proposals(synth_root,
                                                            tmp_path):
    """The dataset CLI in the default recipe against the root `inference.py
    --set TPU.COMPUTE_DTYPE bfloat16` (tests/test_torch_port_cli.py's small
    settings, 4 images), the port handed the JAX CLI's proposals chunk by
    chunk: every image's detections pair one to one with JAX's, boxes
    within COORD_ATOL px and scores within SCORE_TOL, and the COCOeval
    stats within STATS_ATOL.  The scores are not held at the float32 CLI's
    1e-4: the two packages' bf16 trunks round at other places (XLA keeps a
    fusion's bf16 intermediates unrounded), so the RoI features entering
    the float32 head differ by bf16 ulps, and the scores by up to 8.8e-3
    here (two ulps of a score near 0.7); the boxes come from the shared
    proposals and agree to 4e-4 px."""
    import inference as jax_cli
    from dana_tpu_torch import inference as port_cli
    from test_torch_port_cli import COORD_ATOL, STATS_ATOL, _argv
    record = []
    with _jax_proposals(record):
        jres = jax_cli.main(_argv(tmp_path / 'jax') + RECIPE)
        jax.effects_barrier()
    assert record
    with _replayed(record):
        tres = port_cli.main(_argv(tmp_path / 'port', '--device', 'cpu')
                             + RECIPE)
    np.testing.assert_allclose(tres['stats'], jres['stats'],
                               atol=STATS_ATOL)
    dets = []
    for side in ('jax', 'port'):
        with open(tmp_path / side / 'detections.pkl', 'rb') as f:
            dets.append(pickle.load(f))
    n_det, worst = 0, 0.0
    for ca, cb in zip(*dets):
        for da, db in zip(ca, cb):
            if not (isinstance(da, np.ndarray) and len(da)):
                assert not (isinstance(db, np.ndarray) and len(db))
                continue
            assert da.shape == db.shape
            dist = np.abs(da[:, None, :4] - db[None, :, :4]).max(-1)
            pair = dist.argmin(1)
            assert sorted(pair) == list(range(len(db)))
            assert dist.min(1).max() <= COORD_ATOL
            gap = np.abs(da[:, 4] - db[pair, 4]).max()
            worst, n_det = max(worst, gap), n_det + len(da)
    print(f'recipe CLIs: {n_det} detections paired, max score gap '
          f'{worst:.3e}')
    assert n_det > 0 and worst <= SCORE_TOL
