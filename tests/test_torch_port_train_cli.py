"""The port's episodic training CLI (`dana_tpu_torch.train`) and its
modules against the JAX package on the CPU: the episodic loaders and the
batcher, the SGD settings and the finetune freeze, the lr schedule,
preemption, resume, checkpoints both ways, serving the checkpoint through
both inference CLIs, and the prefetch thread's errors.

The synth sets are written by the port's generator first (PPM under a
temporary DANA_SYNTH_ROOT), with a 4-image synth_test, and cv2 runs without
IPP (tests/test_torch_port_data.py says why).  The training runs use
tests/test_train_cli.py's shrunken settings (128 px queries, ResNet-50 at
full width) at --bs 2, --way 2 --shot 1: two steps an epoch.
"""

import os
import pickle
import sys
import threading
import time

import cv2
import jax
import numpy as np
import pytest
import torch

from dana_tpu.data.fs_loader import EpisodicBatcher as JBatcher
from dana_tpu.data.fs_loader import FewShotLoader as JLoader
from dana_tpu.data.fs_loader import FinetuneLoader as JFinetune
from dana_tpu.data.imdb import combined_roidb as jcombined
from dana_tpu.engine import optim as joptim
from dana_tpu.engine import train as jtrain
from dana_tpu.utils import checkpoint as jckpt

from dana_tpu_torch import inference as port_inference
from dana_tpu_torch import train as cli
from dana_tpu_torch.data import blob
from dana_tpu_torch.data.fs_loader import (EpisodicBatcher, FewShotLoader,
                                           FinetuneLoader, Prefetcher)
from dana_tpu_torch.data.imdb import combined_roidb
from dana_tpu_torch.models import dana as tdana
from dana_tpu_torch.models import frameworks as tfw
from dana_tpu_torch.utils import checkpoint as tckpt
from dana_tpu_torch.utils.args import load_cfg, parse_args
from dana_tpu_torch.utils.config import dana_config
from dana_tpu_torch.utils.weights import to_jax_params
from test_torch_port_cli import _argv, _check_against_jax
from test_torch_port_model import _leaves

FLOAT_TOL = 1e-3      # grey levels: the port's resize against cv2's
N_IMAGES = 4
# tests/test_train_cli.py's shrunken training config
SET = ['TRAIN.SCALES', '(128,)', 'TRAIN.MAX_SIZE', '192',
       'TRAIN.RPN_PRE_NMS_TOP_N', '300', 'TRAIN.RPN_POST_NMS_TOP_N', '48',
       'TRAIN.RPN_BATCHSIZE', '64', 'TRAIN.BATCH_SIZE', '32',
       'TPU.NMS_MAX_INPUT', '300',
       'TPU.SIZE_BUCKETS', '[(128, 192), (192, 128), (160, 160)]']
BUCKETS = [(128, 192), (192, 128), (160, 160)]


def _train_argv(save_dir, *flags):
    return ['--dataset', 'synth_test', '--bs', '2', '--way', '2',
            '--shot', '1', '--disp_interval', '1', '--dlog',
            '--save_dir', str(save_dir), '--seed', '3', '--device', 'cpu',
            '--nw', '2', *flags, '--set', *SET]


@pytest.fixture(autouse=True)
def no_ipp():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    """Two intra-op threads for this file's full-width CPU steps: the suite
    runs several test processes at once, and each one's default of a
    thread per core oversubscribes the cores."""
    was = torch.get_num_threads()
    torch.set_num_threads(min(2, was))
    yield
    torch.set_num_threads(was)


@pytest.fixture(scope='module')
def synth_root(tmp_path_factory):
    from dana_tpu_torch.data.synth import synth_fsod
    root = tmp_path_factory.mktemp('synth')
    mp = pytest.MonkeyPatch()
    mp.setenv('DANA_SYNTH_ROOT', str(root))
    synth_fsod('test', num_images=N_IMAGES)
    synth_fsod('train')
    yield root
    mp.undo()


@pytest.fixture(scope='module')
def roidbs(synth_root):
    """(port imdb, port roidb, JAX roidb) of synth_test with flips."""
    imdb_, roidb, _, _ = combined_roidb('synth_test', use_flipped=True)
    _, jroidb, _, _ = jcombined('synth_test', use_flipped=True)
    assert len(roidb) == len(jroidb) == 2 * N_IMAGES
    return imdb_, roidb, jroidb


def _support_dir(root, imdb_, roidb):
    """<root>/<class>/*.ppm: three whole-image supports a class, crops of
    the set's images."""
    for c, name in enumerate(imdb_.classes[1:], 1):
        os.makedirs(root / name)
        for k in range(3):
            im = blob.imread_bgr(roidb[(c + k) % N_IMAGES]['image'])
            crop = im[10 * k:im.shape[0] - 40 * k, 15 * k:]
            blob.write_ppm(str(root / name / f's{k}.ppm'),
                           crop.astype(np.uint8))
    return str(root)


def _loaders(roidbs, tmp_path, finetune, allowed=None):
    imdb_, roidb, jroidb = roidbs
    kw = dict(num_way=2, num_shot=2, max_num_box=50, seed=3,
              buckets=BUCKETS, scale=128, allowed_classes=allowed)
    if finetune:
        sup = _support_dir(tmp_path / 'supports', imdb_, roidb)
        return (FinetuneLoader(roidb, imdb_.num_classes, imdb_.classes, sup,
                               **kw),
                JFinetune(jroidb, imdb_.num_classes, imdb_.classes, sup,
                          max_size=None, **kw))
    return (FewShotLoader(roidb, imdb_.num_classes, **kw),
            JLoader(jroidb, imdb_.num_classes, max_size=None, **kw))


def _same_item(got, want):
    assert set(got) == set(want)
    for k in want:
        if k in ('im_data', 'support_ims'):
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=FLOAT_TOL, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize('kind', ['fewshot', 'fewshot_allowed', 'finetune'])
def test_episodes_match_jax(roidbs, tmp_path, kind):
    """Every valid entry, flipped ones included: gt, the positive class
    and im_info exactly, images within the resize tolerance."""
    allowed = {1, 2, 3, 4} if kind == 'fewshot_allowed' else None
    loader, jloader = _loaders(roidbs, tmp_path, kind == 'finetune', allowed)
    valid = loader.valid_indices()
    assert valid == jloader.valid_indices()
    assert any(roidbs[1][i].get('flipped') for i in valid)
    for i in valid:
        assert loader.bucket_of(i) == jloader.bucket_of(i)
        _same_item(loader[i], jloader[i])


@pytest.mark.parametrize('workers, bs, drop_last', [
    (0, 2, True), (3, 2, True), (0, 3, False)])
def test_batches_match_jax(roidbs, tmp_path, workers, bs, drop_last):
    """The index batches of epochs 1-3 (a short last batch dropped, or
    filled by cycling its bucket), and epoch 1's assembled batches, equal
    the JAX batcher's."""
    loader, jloader = _loaders(roidbs, tmp_path, False)
    batcher = EpisodicBatcher(loader, bs, seed=3, num_workers=workers,
                              drop_last=drop_last)
    jbatcher = JBatcher(jloader, bs, seed=3, num_workers=workers,
                        drop_last=drop_last)
    for epoch in (1, 2, 3):
        jbatcher._epoch = epoch
        want = [[int(i) for i in b] for b in jbatcher._index_batches()]
        assert [[int(i) for i in b] for b in batcher.index_batches(epoch)] \
            == want
        assert want and all(len(b) == bs for b in want)
    jbatcher._epoch = 0
    pairs = list(zip(batcher, jbatcher))
    assert len(pairs) == len(batcher.index_batches(1)) and batcher.epoch == 1
    for got, want in pairs:
        _same_item(got, want)


def test_batcher_refuses_process_slicing(roidbs):
    """A global batch that does not split evenly over the processes is
    refused (the JAX batcher's ValueError)."""
    loader = FewShotLoader(roidbs[1], roidbs[0].num_classes)
    with pytest.raises(ValueError, match='divide evenly over 2 processes'):
        EpisodicBatcher(loader, 3, process_count=2)


def _cli_config(tmp_path, *flags):
    args = parse_args(_train_argv(tmp_path, *flags))
    c = load_cfg(args)
    return args, c, dana_config(c, args.way, args.shot, args.net)


def _cli_trainer(tmp_path, *flags):
    args, c, config = _cli_config(tmp_path, *flags)
    params = tfw.init_params(config, seed=args.seed)
    return cli.make_trainer(args, c, config, params, args.lr, 'cpu'), params


def test_cli_sgd_settings_are_res50_yml(tmp_path):
    trainer, _ = _cli_trainer(tmp_path)
    bias, rest = trainer.optimizer.param_groups
    assert bias['momentum'] == rest['momentum'] == 0.9
    assert rest['weight_decay'] == 1e-4 and bias['weight_decay'] == 0.0
    assert bias['lr'] == rest['lr'] == 1e-3        # DOUBLE_BIAS False
    trainer.lr = 1e-4
    assert bias['lr'] == rest['lr'] == 1e-4


# the heads --fs trains, per --net (the JAX finetune_mask keys each has)
FS_HEADS = {
    'DAnA': {'RCNN_bbox_pred', 'output_score_layer', 'rcnn_transform_layer'},
    'cisa': {'RCNN_bbox_pred', 'output_score_layer', 'rcnn_transform_layer'},
    'frcnn': {'RCNN_bbox_pred', 'RCNN_cls_score'},
    'fsod': {'RCNN_bbox_pred'},
    'meta': {'RCNN_bbox_pred', 'RCNN_cls_score'},
    'fgn': {'RCNN_bbox_pred', 'RCNN_cls_score'}}


@pytest.mark.parametrize('net', list(FS_HEADS))
def test_cli_finetune_trains_jax_heads(tmp_path, net):
    """--fs: the trainable set equals JAX's trainable_mask and
    finetune_mask, leaf for leaf."""
    trainer, params = _cli_trainer(tmp_path, '--fs', '--net', net)
    assert trainer.config.framework == net
    jp = jax.tree.map(np.asarray, params)
    mask = jax.tree.map(lambda a, b: a and b,
                        joptim.trainable_mask(jp, fixed_blocks=1),
                        joptim.finetune_mask(jp))
    want = {k for k, t in _leaves(mask) if t}
    got = {n for n, p in trainer.model.named_parameters() if p.requires_grad}
    assert got == want and len(got) >= 2
    assert {n.split('.')[0] for n in got} == FS_HEADS[net]


@pytest.mark.parametrize('step, gamma', [(1, 0.1), (3, 0.5), (1000, 0.1)])
def test_lr_schedule_follows_root_train(step, gamma):
    """Root train.py:233: lr *= gamma at every epoch divisible by step + 1."""
    args = parse_args(['--dataset', 'synth', '--lr_decay_step', str(step),
                       '--lr_decay_gamma', str(gamma)])
    lr = want = 0.01
    for epoch in range(1, 13):
        if epoch % (step + 1) == 0:
            want *= gamma
        lr = cli.decayed_lr(lr, epoch, args)
        assert lr == want, epoch


def _payload(path):
    with open(path, 'rb') as f:
        return pickle.load(f)


@pytest.fixture(scope='module')
def runs(synth_root, tmp_path_factory):
    """--epochs 2 straight (profiled from its 4th step), and --epochs 1
    then --r --epochs 2."""
    straight = tmp_path_factory.mktemp('straight')
    split = tmp_path_factory.mktemp('split')
    s = cli.main(_train_argv(straight, '--epochs', '2', '--profile',
                             str(straight / 'trace.json')))
    first = cli.main(_train_argv(split, '--epochs', '1'))
    resumed = cli.main(_train_argv(split, '--epochs', '2', '--r',
                                   '--checkpath', first['checkpoint']))
    return s, first, resumed


def test_resume_equals_straight(runs):
    straight, first, resumed = runs
    assert [e['epoch'] for e in straight['epochs']] == [1, 2]
    assert [e['epoch'] for e in resumed['epochs']] == [2]
    assert straight['epochs'][1]['loss_curve'] == \
        resumed['epochs'][0]['loss_curve']
    a, b = _payload(straight['checkpoint']), _payload(resumed['checkpoint'])
    assert os.path.basename(straight['checkpoint']) == 'model_2_1.dkpt'
    assert a['epoch'] == b['epoch'] == 2 and a['lr'] == b['lr']
    for tree in ('model', 'velocity'):
        ta = a['model'] if tree == 'model' else a['optimizer']['velocity']
        tb = b['model'] if tree == 'model' else b['optimizer']['velocity']
        la, lb = dict(_leaves(ta)), dict(_leaves(tb))
        assert la.keys() == lb.keys()
        for k in la:
            np.testing.assert_array_equal(la[k], lb[k], err_msg=k)
    np.testing.assert_array_equal(a['extra']['generator'],
                                  b['extra']['generator'])
    assert all(e['skipped'] == 0 for e in straight['epochs'])


def test_profile_writes_a_trace_of_the_step_ranges(runs):
    """--profile: a chrome trace from the 4th step on (here the last)."""
    import json
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        runs[0]['checkpoint']))), 'trace.json')
    with open(path) as f:
        names = {e.get('name') for e in json.load(f)['traceEvents']}
    assert {'dana.trunk', 'dana.backward', 'dana.update'} <= names


def test_port_checkpoint_loads_in_jax(runs):
    """A port-written .dkpt: JAX's load_checkpoint reads it and
    restore_optimizer takes its velocity, of sgd_init's tree structure;
    the momentum is nonzero where the port trains and zero elsewhere."""
    path = runs[0]['checkpoint']
    payload = jckpt.load_checkpoint(path)
    params = payload['model']
    state = jtrain.restore_optimizer(
        jtrain.create_train_state(params, payload['lr']),
        payload['optimizer'])
    assert jax.tree.structure(state.opt.velocity) == \
        jax.tree.structure(joptim.sgd_init(params).velocity)
    assert jax.tree.structure(params) == jax.tree.structure(
        tdana.init_params(_cli_config('run')[2], seed=0))
    mask = joptim.trainable_mask(params, fixed_blocks=1)
    vel = dict(_leaves(jax.tree.map(np.asarray, state.opt.velocity)))
    moving = [k for k, t in _leaves(mask) if t and vel[k].any()]
    assert not any(vel[k].any() for k, t in _leaves(mask) if not t)
    assert len(moving) > 50
    assert payload['pooling_mode'] == 'align' and payload['epoch'] == 2


def test_jax_checkpoint_momentum_resumes(synth_root, tmp_path):
    """A JAX-written .dkpt (its optimizer a pickled SGDState) with nonzero
    velocity: --r restores those values into the trainable parameters'
    momentum buffers, the lr and the next epoch."""
    _, c, config = _cli_config(tmp_path)
    params = tdana.init_params(config, seed=5)
    rng = np.random.default_rng(0)
    velocity = jax.tree.map(
        lambda v: rng.normal(0, 1, v.shape).astype(np.float32), params)
    path = str(tmp_path / 'model_3_7.dkpt')
    jckpt.save_checkpoint(path, params, joptim.SGDState(
        velocity=velocity, lr=np.float32(0.02)), epoch=3, step=7, lr=0.02)
    args = parse_args(_train_argv(tmp_path, '--r', '--checkpath', path))
    model, config, lr, start, vel, gen = cli.restore(args, c, config)
    assert (lr, start, gen) == (0.02, 4, None)
    assert config.pooling_mode == c.POOLING_MODE == 'align'
    trainer = cli.make_trainer(args, c, config, model, lr, 'cpu')
    trainer.load_state(vel, gen)
    got = dict(_leaves(trainer.state()['velocity']))
    mask = dict(_leaves(joptim.trainable_mask(params, fixed_blocks=1)))
    n = 0
    for k, v in _leaves(velocity):
        if mask[k]:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
            n += 1
        else:
            assert not got[k].any(), k
    assert n > 50


def test_serving_the_checkpoint_matches_jax(runs, tmp_path):
    """The trained checkpoint served by `dana_tpu_torch.inference` and by
    the root inference.py: the same detections, tie-aware on the query
    grid at 2e-3 px, and COCOeval stats within 1e-3."""
    import inference as jax_cli
    path = runs[0]['checkpoint']
    jout = tmp_path / 'jax'
    jresult = jax_cli.main(_argv(jout, '--checkpath', path))
    out = tmp_path / 'port'
    result = port_inference.main(_argv(out, '--device', 'cpu',
                                       '--checkpath', path))
    _check_against_jax((jout, jresult), out, result)


@pytest.fixture(scope='module')
def meta_runs(synth_root, tmp_path_factory):
    """--net meta: --epochs 2 straight, recording the batches its trainer
    steps on, and --epochs 1 then --r --epochs 2."""
    from dana_tpu_torch.engine.train import Trainer
    straight = tmp_path_factory.mktemp('meta_straight')
    split = tmp_path_factory.mktemp('meta_split')
    seen, real = [], Trainer.step

    def step(self, batch, draws=None):
        seen.append({k: np.array(v) for k, v in batch.items()})
        return real(self, batch, draws)
    mp = pytest.MonkeyPatch()
    mp.setattr(Trainer, 'step', step)
    try:
        s = cli.main(_train_argv(straight, '--net', 'meta', '--epochs', '2'))
    finally:
        mp.undo()
    first = cli.main(_train_argv(split, '--net', 'meta', '--epochs', '1'))
    resumed = cli.main(_train_argv(split, '--net', 'meta', '--epochs', '2',
                                   '--r', '--checkpath', first['checkpoint']))
    return s, resumed, seen


def test_meta_batches_carry_jax_all_gt_boxes(meta_runs):
    """Meta R-CNN's steps get the JAX batcher's every-class gt beside the
    episode's gt, epoch 1 batch for batch."""
    _, c, _ = _cli_config('run', '--net', 'meta')
    jimdb, jroidb, _, _ = jcombined('synth_test', use_flipped=False)
    jloader = JLoader(jroidb, jimdb.num_classes, num_way=2, num_shot=1,
                      max_num_box=c.MAX_NUM_GT_BOXES, seed=3, buckets=BUCKETS,
                      scale=128, max_size=None)
    jbatcher = JBatcher(jloader, 2, seed=3)
    jbatcher._epoch = 0
    want = list(jbatcher)
    seen = meta_runs[2][:len(want)]
    assert len(want) == 2 and len(meta_runs[2]) == 4
    for got, w in zip(seen, want):
        assert set(got) == set(cli.BATCH_KEYS) | {'all_gt_boxes'}
        np.testing.assert_array_equal(got['all_gt_boxes'], w['all_gt_boxes'])
        np.testing.assert_array_equal(got['gt_boxes'], w['gt_boxes'])
    assert any(not np.array_equal(g['all_gt_boxes'][..., :4],
                                  g['gt_boxes'][..., :4]) for g in seen)


def test_meta_resume_equals_straight(meta_runs):
    straight, resumed, _ = meta_runs
    assert straight['epochs'][1]['loss_curve'] == \
        resumed['epochs'][0]['loss_curve']
    a, b = _payload(straight['checkpoint']), _payload(resumed['checkpoint'])
    la, lb = dict(_leaves(a['model'])), dict(_leaves(b['model']))
    assert la.keys() == lb.keys()
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)
    assert all(e['skipped'] == 0 for e in straight['epochs'])


def test_meta_checkpoint_loads_in_jax(meta_runs):
    """The port's Meta R-CNN .dkpt is a JAX Meta R-CNN tree, with its
    velocity for restore_optimizer and the detector's name; the port
    refuses it as another detector's."""
    from dana_tpu.models import frameworks as jfw
    path = meta_runs[0]['checkpoint']
    payload = jckpt.load_checkpoint(path)
    params = payload['model']
    assert payload['extra']['framework'] == 'meta'
    _, want = jfw.get_model('meta', dict(n_way=2, n_shot=1), seed=0)
    assert jax.tree.structure(params) == jax.tree.structure(want)
    state = jtrain.restore_optimizer(
        jtrain.create_train_state(params, payload['lr']),
        payload['optimizer'])
    assert jax.tree.structure(state.opt.velocity) == \
        jax.tree.structure(params)
    with pytest.raises(ValueError, match='a meta checkpoint'):
        tckpt.load_checkpoint(path, _cli_config('run')[2])


def test_serving_the_meta_checkpoint(meta_runs, tmp_path):
    """The dataset CLI serves the trained Meta R-CNN with --net meta, each
    chunk's support stack encoded with it."""
    result = port_inference.main(_argv(
        tmp_path, '--device', 'cpu', '--checkpath',
        meta_runs[0]['checkpoint'], net='meta'))
    assert len(result['stats']) == 12 and np.isfinite(result['stats']).all()
    assert result['timing']['images'] == N_IMAGES


class _AlwaysPreempted:
    requested = True

    def install(self):
        return self

    def uninstall(self):
        pass


def test_preemption_checkpoints_previous_epoch(synth_root, tmp_path,
                                               monkeypatch):
    """A guard that always reports a signal: one step, then
    model_0_0_preempt.dkpt with epoch 0; --r from it trains epoch 1."""
    monkeypatch.setattr(cli, 'PreemptionGuard', _AlwaysPreempted)
    out = cli.main(_train_argv(tmp_path, '--epochs', '3'))
    assert out['preempted'] and out['checkpoint'].endswith(
        'model_0_0_preempt.dkpt')
    assert jckpt.load_checkpoint(out['checkpoint'])['epoch'] == 0
    assert [e['steps'] for e in out['epochs']] == [1]
    monkeypatch.undo()
    out = cli.main(_train_argv(tmp_path, '--r', '--load_dir', str(tmp_path),
                               '--checkepoch', '0', '--checkpoint', '0',
                               '--epochs', '1'))
    assert not out['preempted']
    assert os.path.basename(out['checkpoint']).startswith('model_1_')


def test_preemption_guard_second_signal_interrupts():
    """The handler, called as a signal would call it: the first sets the
    request, the second restores the previous handler and interrupts."""
    import signal
    before = signal.getsignal(signal.SIGTERM)
    guard = cli.PreemptionGuard()
    guard._prev[signal.SIGTERM] = before
    guard._handle(signal.SIGTERM, None)
    assert guard.requested
    with pytest.raises(KeyboardInterrupt):
        guard._handle(signal.SIGTERM, None)
    assert signal.getsignal(signal.SIGTERM) is before


def _consume(feed, out):
    try:
        for b in feed:
            out.append(b)
    except Exception as e:          # handed to the test's thread
        out.append(e)


@pytest.mark.parametrize('case', ['raises', 'abandoned'])
def test_prefetch_worker_errors_reach_the_caller(case):
    """An exception raised while the worker assembles batch 2 reaches the
    consumer after batch 1; an abandoned iteration stops the worker.  No
    wait is unbounded."""
    def batches():
        yield {'x': np.ones((2, 3), np.float32)}
        if case == 'raises':
            raise RuntimeError('assembly failed')
        while True:
            yield {'x': np.zeros((2, 3), np.float32)}

    got = []
    feed = Prefetcher(batches(), 'cpu')
    if case == 'raises':
        t = threading.Thread(target=_consume, args=(feed, got))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        assert isinstance(got[0], dict) and torch.equal(
            got[0]['x'], torch.ones(2, 3))
        assert isinstance(got[1], RuntimeError) and len(got) == 2
    else:
        it = iter(feed)
        assert torch.equal(next(it)['x'], torch.ones(2, 3))
        it.close()
    deadline = time.time() + 30
    while any(t.name == 'dana-prefetch' for t in threading.enumerate()):
        assert time.time() < deadline, 'the prefetch worker did not stop'
        time.sleep(0.05)


@pytest.mark.parametrize('flags, match', [
    (['--ckpt_backend', 'orbax'], 'pickle'), (['--dist'], '--num_procs'),
    (['--dist', '--num_procs', '2'], '--proc_id'),
    (['--dist', '--num_procs', '2', '--proc_id', '2'], 'not below')])
def test_train_cli_refuses_unported(tmp_path, flags, match):
    with pytest.raises(SystemExit, match=match):
        cli.main(_train_argv(tmp_path, *flags))


def test_train_cli_needs_cuda_unless_cpu(synth_root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default device works')
    argv = [a for a in _train_argv(tmp_path) if a not in ('--device', 'cpu')]
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        cli.main(argv)


def test_trainer_state_round_trips_to_the_jax_tree(runs):
    """to_jax_params of the served model equals the checkpoint's tree: the
    writer adds nothing and drops nothing."""
    payload = _payload(runs[0]['checkpoint'])
    model, _ = tckpt.load_checkpoint(runs[0]['checkpoint'],
                                     _cli_config('run')[2])
    got = dict(_leaves(to_jax_params(model)))
    want = dict(_leaves(payload['model']))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_logger_records_as_jax_without_tensorboard(monkeypatch, tmp_path):
    """FSODLogger with TensorBoard unimportable: the epoch's scalars as the
    JAX logger keeps them, and the query (gt boxes drawn as JAX draws
    them) and support images."""
    from dana_tpu.utils import fsod_logger as jlog
    from dana_tpu_torch.utils import fsod_logger as tlog
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    rng = np.random.default_rng(0)
    batch = {'im_data': rng.normal(0, 60, (2, 64, 96, 3)).astype(np.float32),
             'gt_boxes': np.array([[[5, 6, 40, 50, 1], [0, 0, 0, 0, 0]]] * 2,
                                  np.float32),
             'support_ims': rng.normal(0, 60, (2, 2, 32, 32, 3))
             .astype(np.float32)}
    losses = {'loss': 1.5, 'rpn_loss_cls': np.float32(0.25)}
    logger = tlog.FSODLogger(str(tmp_path))
    jlogger = jlog.FSODLogger(str(tmp_path / 'jax'))
    logger.write(3, losses, batch=batch, save_im=True)
    jlogger.write(3, losses, batch=batch, save_im=True)
    assert logger.scalars == jlogger.scalars
    tags = [t for _, t, _ in logger.images]
    assert tags == ['query', 'support/0', 'support/1']
    means = np.array(tlog.PIXEL_MEANS, np.float32)
    want = jlog.draw_boxes(jlog._to_uint8(batch['im_data'][0], means),
                           batch['gt_boxes'][0])
    np.testing.assert_array_equal(logger.images[0][2], want)
    logger.close()
