"""The port's multi-process runs (dana_tpu_torch/parallel/distributed.py)
on the CPU: the row blocks, the process-row batcher, the stop vote, the
batch-coupled reductions under W simulated ranks in one process, one real
2-process gloo training step against the one-process step and JAX's
2-device mesh step, and a 2-process --dist run of the dataset CLI against
its one-process run.

Child processes rendezvous through a file (a FileStore under tmp_path: the
suite runs several test processes at once, so no fixed port), write their
output to a file, not a pipe (a rank blocked on a full pipe would strand
its peer in a collective), and are killed at a timeout that fails the
test.
"""

import os
import pathlib
import pickle
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dana_tpu.engine import optim as joptim
from dana_tpu.engine import train as jtrain
from dana_tpu.models import dana as jdana
from dana_tpu.models.layers import to_jnp

from dana_tpu_torch.data.fs_loader import EpisodicBatcher
from dana_tpu_torch.engine.train import Trainer
from dana_tpu_torch.models import dana as tdana
from dana_tpu_torch.models import layers as tlayers
from dana_tpu_torch.models import losses as tlosses
from dana_tpu_torch.models import rpn as trpn
from dana_tpu_torch.parallel import distributed
from dana_tpu_torch.parallel.distributed import BatchGroup
from test_torch_port_model import _caffe_like, _leaves
from test_torch_port_train import SMALL, _batch, jax_step_draws

ROOT = pathlib.Path(__file__).resolve().parents[1]
HARNESS = ROOT / 'tools' / 'torch_dist_step.py'
CHILD_TIMEOUT_S = 240
METRICS = ('rpn_loss_cls', 'rpn_loss_box', 'rcnn_loss_cls', 'rcnn_loss_bbox',
           'loss', 'fg_cnt', 'bg_cnt')


def _child_env():
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS='2')
    for k in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
              'MASTER_PORT'):
        env.pop(k, None)
    return env


def _run_children(cmds, tmp_path, tag):
    """Start every command with its output in a file; wait for all, kill
    every one at CHILD_TIMEOUT_S; -> their outputs (asserting exit 0)."""
    procs = []
    for i, cmd in enumerate(cmds):
        log = open(tmp_path / f'{tag}{i}.log', 'w+')
        procs.append((subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT, cwd=ROOT,
                                       env=_child_env()), log))
    outs = []
    try:
        for p, log in procs:
            try:
                p.wait(timeout=CHILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                for q, _ in procs:
                    q.kill()
                pytest.fail(f'a {tag} process did not finish in '
                            f'{CHILD_TIMEOUT_S} s')
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.seek(0)
            outs.append(log.read())
            log.close()
    for (p, _), out in zip(procs, outs):
        assert p.returncode == 0, f'{tag} process failed:\n{out[-4000:]}'
    return outs


# ------------------------------------------------------------- row blocks

def test_local_rows_partition():
    got = [distributed.local_rows(8, process_id=r, process_count=2)
           for r in (0, 1)]
    assert got == [slice(0, 4), slice(4, 8)]
    covered = np.concatenate([np.arange(8)[s] for s in got])
    np.testing.assert_array_equal(covered, np.arange(8))
    with pytest.raises(ValueError, match='divide evenly'):
        distributed.local_rows(7, process_id=0, process_count=2)
    assert distributed.local_rows(6) == slice(0, 6)     # one process


class FakeLoader:
    def __init__(self, n, buckets=1):
        self.n, self.buckets = n, buckets

    def valid_indices(self):
        return list(range(self.n))

    def bucket_of(self, i):
        return i % self.buckets

    def __getitem__(self, i):
        rng = np.random.default_rng((7, i))
        return {'x': rng.normal(size=(3, 3)).astype(np.float32),
                'i': np.int32(i)}


@pytest.mark.parametrize('workers', [0, 3])
def test_episodic_batcher_process_slices_reassemble(workers):
    """The ranks' row blocks of every batch, in rank order, are the
    one-process batches, with or without assembly threads, over epochs."""
    single = EpisodicBatcher(FakeLoader(32, 2), 4, seed=3)
    ranks = [EpisodicBatcher(FakeLoader(32, 2), 4, seed=3, process_id=r,
                             process_count=2, num_workers=workers)
             for r in (0, 1)]
    for _ in range(2):
        got = [list(r) for r in ranks]
        want = list(single)
        assert len(want) == len(got[0]) == len(got[1]) == 8
        for sb, r0, r1 in zip(want, *got):
            assert r0['x'].shape[0] == r1['x'].shape[0] == 2
            for k in sb:
                np.testing.assert_array_equal(
                    sb[k], np.concatenate([r0[k], r1[k]]))
    with pytest.raises(ValueError, match='divide evenly'):
        EpisodicBatcher(FakeLoader(16), 5, process_count=2)


@pytest.mark.parametrize('n', [1, 3, 5])
def test_episodic_batcher_short_bucket_fills_batch(n):
    """A bucket shorter than the batch (drop_last False) is cycled to a
    full batch, so both ranks get equal blocks that reassemble it."""
    single = list(EpisodicBatcher(FakeLoader(n), 8, seed=0, drop_last=False))
    ranks = [list(EpisodicBatcher(FakeLoader(n), 8, seed=0, drop_last=False,
                                  process_id=r, process_count=2))
             for r in (0, 1)]
    assert len(single) == len(ranks[0]) == len(ranks[1]) == 1
    assert ranks[0][0]['x'].shape[0] == ranks[1][0]['x'].shape[0] == 4
    np.testing.assert_array_equal(
        single[0]['i'], np.concatenate([ranks[0][0]['i'],
                                        ranks[1][0]['i']]))


def test_agree_stop_and_barrier_single_process():
    """On one process the stop vote is the local flag and the barrier
    returns at once."""
    assert distributed.agree_stop(True) is True
    assert distributed.agree_stop(False) is False
    distributed.barrier('nothing', timeout_ms=1)
    assert not distributed.is_multiprocess()
    assert distributed.current_group() is distributed.SINGLE


@pytest.mark.parametrize('hosts, device, want', [
    ([('a', 4)] * 4, 'cuda', 'nccl'),
    ([('a', 4)] * 4 + [('b', 4)] * 4, 'cuda', 'nccl'),
    ([('a', 4)] * 4 + [('b', 8)] * 8, 'cuda', 'nccl'),
    ([('a', 1)] * 2, 'cuda', 'gloo'),
    ([('a', 4)] * 4 + [('b', 2)] * 3, 'cuda', 'gloo'),
    ([('a', 4)] * 2, 'cpu', 'gloo')],
    ids=['one_host', 'two_hosts_8_ranks', 'uneven_hosts', 'shared_card',
         'one_host_short', 'cpu'])
def test_backend_is_chosen_per_host(hosts, device, want):
    """NCCL when each host holds no more ranks than cards, whatever the
    world size: 8 ranks over two hosts of 4 cards each have cards of their
    own; gloo when a host's ranks outnumber its cards, or on the CPU."""
    assert distributed.choose_backend(hosts, device) == want


def test_ranks_tell_their_hosts_through_the_store(monkeypatch):
    """Every rank's host and card count comes back from the rendezvous
    store, in rank order."""
    store = torch.distributed.HashStore()
    peers = torch.distributed.PrefixStore('dana_hosts', store)
    for r, name in ((1, 'b'), (2, 'a'), (3, 'b')):
        peers.set(str(r), f'["{name}", 2]')
    monkeypatch.setattr(distributed.socket, 'gethostname', lambda: 'a')
    hosts = distributed._exchange_hosts(store, 0, 4, 'cpu')
    assert hosts == [('a', 0), ('b', 2), ('a', 2), ('b', 2)]


# --------------------------------------------- simulated ranks in one process

class ThreadGroup(BatchGroup):
    """A BatchGroup whose ranks are threads of this process: `reduce_`
    sums every rank's tensor in rank order at a barrier."""

    def __init__(self, rank, size, shared):
        super().__init__(rank, size)
        self.shared = shared

    def reduce_(self, t):
        slots, barrier = self.shared['slots'], self.shared['barrier']
        slots[self.rank] = t.detach().clone()
        barrier.wait()
        total = slots[0].clone()
        for s in slots[1:]:
            total += s
        barrier.wait()
        t.copy_(total)


def _on_ranks(fn, size=2):
    """fn(group) on `size` simulated ranks, each in its thread and inside
    its group; -> their results in rank order."""
    shared = {'slots': [None] * size, 'barrier': threading.Barrier(size)}
    out, errors = [None] * size, []

    def run(r):
        try:
            with ThreadGroup(r, size, shared) as g:
                out[r] = fn(g)
        except BaseException as e:          # reported below
            errors.append(e)
            shared['barrier'].abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    if errors:
        raise errors[0]
    return out


def _global_and_ranks(loss_fn, inputs, size=2):
    """The loss and its input gradients on the whole batch, and on `size`
    ranks holding its row blocks: -> (global loss, global grads, the ranks'
    mean loss, the ranks' gradients (each divided by size, as the step's
    mean of gradients divides), the ranks' own means)."""
    xs = [torch.tensor(x, requires_grad=x.dtype == np.float32)
          for x in inputs]
    want = loss_fn(*xs)
    grads = torch.autograd.grad(want, [x for x in xs if x.requires_grad])

    def rank(g):
        local = [torch.tensor(g.rows(torch.from_numpy(x)).numpy(),
                              requires_grad=x.dtype == np.float32)
                 for x in inputs]
        loss = loss_fn(*local)
        gs = torch.autograd.grad(loss, [x for x in local if x.requires_grad])
        with distributed.SINGLE:
            naive = loss_fn(*[x.detach() for x in local]).item()
        return loss.item(), [x / g.size for x in gs], naive

    res = _on_ranks(rank, size)
    got = float(np.mean([r[0] for r in res]))
    got_grads = [torch.cat(parts) for parts in zip(*[r[1] for r in res])]
    return want.item(), grads, got, got_grads, [r[2] for r in res]


def test_masked_cross_entropy_is_global_over_ranks():
    """Ranks with different labelled counts: the mean of the ranks' losses
    and their gradients are the global batch's; the ranks' own means are
    not."""
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (4, 50, 2)).astype(np.float32)
    labels = rng.integers(-1, 2, (4, 50)).astype(np.int64)
    labels[2:, 10:] = -1                       # rank 1 labels far fewer
    want, grads, got, got_grads, naive = _global_and_ranks(
        lambda lg, lb: tlosses.masked_cross_entropy(lg, lb, lb != -1),
        [logits, labels])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    torch.testing.assert_close(got_grads[0], grads[0], rtol=1e-5, atol=1e-8)
    assert abs(np.mean(naive) - want) > 1e-2


@pytest.mark.parametrize('case', ['ties', 'skewed_fg'])
def test_hard_mined_pair_ce_is_global_over_ranks(case):
    """The picks are the global batch's (ranks of tied probabilities in
    rank order included), so the mean loss and gradients equal the
    one-process loss on the whole batch."""
    rng = np.random.default_rng(2)
    b, s = 4, 32
    logits = rng.normal(0, 2, (b, s, 2)).astype(np.float32)
    neg = rng.normal(0, 2, (b, s, 2)).astype(np.float32)
    labels = (rng.random((b, s)) < 0.2).astype(np.int64)
    if case == 'ties':
        logits[:, ::3] = [-30.0, 30.0]
        logits[:, 1::5] = [2.0, 2.0]
        neg[:, ::2] = [-40.0, 40.0]
    else:
        labels[:2] = (rng.random((2, s)) < 0.7)
        labels[2:] = 0
    want, grads, got, got_grads, naive = _global_and_ranks(
        lambda lg, lb, ng: tlosses.hard_mined_pair_ce(lg, lb, ng),
        [logits, labels, neg])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    for a, w in zip(got_grads, grads):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-8)
    if case == 'skewed_fg':
        assert abs(np.mean(naive) - want) > 1e-3


def test_batch_norm_global_statistics_over_ranks():
    """BatchNorm2d(batch_stats=True) on each rank's rows normalises with
    the global batch's statistics: outputs, input and affine gradients and
    the running statistics equal the one-process layer's."""
    rng = np.random.default_rng(3)
    x = (rng.normal(0, 1, (4, 6, 3, 3)) * np.arange(1, 5)[:, None, None,
                                                        None]
         + np.arange(4)[:, None, None, None]).astype(np.float32)
    c = rng.normal(0, 1, x.shape).astype(np.float32)

    def make():
        bn = tlayers.BatchNorm2d(6)
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, 6))
            bn.bias.copy_(torch.linspace(-0.2, 0.3, 6))
        return bn

    bn = make()
    xt = torch.tensor(x, requires_grad=True)
    loss = (bn(xt, batch_stats=True) * torch.from_numpy(c)).sum()
    gx, gw, gb = torch.autograd.grad(loss, [xt, bn.weight, bn.bias])

    def rank(g):
        layer = make()
        xr = torch.tensor(g.rows(torch.from_numpy(x)).numpy(),
                          requires_grad=True)
        y = layer(xr, batch_stats=True)
        lr = (y * g.rows(torch.from_numpy(c))).sum() * g.size
        grads = torch.autograd.grad(lr, [xr, layer.weight, layer.bias])
        return (y.detach(), [t / g.size for t in grads],
                layer.running_mean, layer.running_var)

    res = _on_ranks(rank)
    torch.testing.assert_close(torch.cat([r[0] for r in res]),
                               make()(torch.from_numpy(x), True).detach(),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(torch.cat([r[1][0] for r in res]), gx,
                               rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(sum(r[1][1] for r in res), gw, rtol=1e-4,
                               atol=1e-5)
    torch.testing.assert_close(sum(r[1][2] for r in res), gb, rtol=1e-4,
                               atol=1e-5)
    for r in res:
        torch.testing.assert_close(r[2], bn.running_mean, rtol=1e-5,
                                   atol=1e-6)
        torch.testing.assert_close(r[3], bn.running_var, rtol=1e-5,
                                   atol=1e-6)


def test_gather_rows_and_draws_over_ranks():
    """gather concatenates the ranks' rows in rank order (bools too); each
    rank's generator draws are its rows of the one-process draws."""
    x = torch.arange(12.0).reshape(4, 3)
    got = _on_ranks(lambda g: (g.gather(g.rows(x)), g.gather(g.rows(x) > 4),
                               g.all_sum(torch.ones(2))))
    for gathered, mask, total in got:
        torch.testing.assert_close(gathered, x)
        assert mask.dtype == torch.bool and torch.equal(mask, x > 4)
        torch.testing.assert_close(total, torch.full((2,), 2.0))
    want = trpn.uniform_draws(torch.Generator().manual_seed(4), 4, 30, 20, 8)

    def rank(g):
        d = trpn.uniform_draws(torch.Generator().manual_seed(4), 4, 30, 20,
                               8)
        return {k: g.rows(v) for k, v in d.items()}

    ranks = _on_ranks(rank)
    for k in want:
        torch.testing.assert_close(torch.cat([r[k] for r in ranks]),
                                   want[k], rtol=0, atol=0)


# ------------------------------------------------- one real 2-process step

def _dp_batch():
    """tests/test_torch_port_train.py's batch of 2, image 1 cut to a
    smaller image: the images differ in gt boxes (fg rois) and in labelled
    anchors, so a per-rank mean of the RPN loss is not the global one."""
    b = _batch()
    b['im_info'] = b['im_info'].copy()
    b['im_info'][1] = [96.0, 112.0, 1.0]
    return b


@pytest.fixture(scope='module')
def dp_step(tmp_path_factory):
    """One step of the small config at a global batch of 2: two gloo
    processes (tools/torch_dist_step.py), the port on one process, and
    JAX on a 2-device data mesh, from the same weights, batch and JAX's
    draws."""
    tmp = tmp_path_factory.mktemp('dp_step')
    jconf = jdana.DanaConfig(use_pallas_attention=False, **SMALL)
    tconf = tdana.DanaConfig(**SMALL)
    params = _caffe_like(jdana.init_params(jconf, seed=8), seed=9)
    batch = _dp_batch()
    rng = jax.random.PRNGKey(10)
    key = jax.random.fold_in(rng, 0)
    n = (128 // 16) * (160 // 16) * tconf.num_anchors
    draws = jax_step_draws(key, 2, n, tconf.train_post_nms
                           + batch['gt_boxes'].shape[1],
                           tconf.rois_per_image)
    draws = {k: v.numpy() for k, v in draws.items()}

    inputs = tmp / 'inputs.pkl'
    with open(inputs, 'wb') as f:
        pickle.dump(dict(params=params, batch=batch, draws=draws, lr=1e-3,
                         runs=[dict(label='main', config=tconf)]), f)
    init = f'file://{tmp}/rdzv'
    _run_children([[sys.executable, str(HARNESS), '--inputs', str(inputs),
                    '--out', str(tmp / f'rank{r}.pkl'), '--rank', str(r),
                    '--world', '2', '--init', init, '--device', 'cpu']
                   for r in (0, 1)], tmp, 'rank')
    ranks = []
    for r in (0, 1):
        with open(tmp / f'rank{r}.pkl', 'rb') as f:
            out = pickle.load(f)
        assert out['backend'] == 'gloo'
        ranks.append(out['runs']['main'])

    torch.set_num_threads(2)
    trainer = Trainer(params, tconf, device='cpu', lr=1e-3)
    one = {k: v.item() for k, v in trainer.step(
        batch, draws={k: torch.from_numpy(v) for k, v in draws.items()})
        .items()}
    one_params = {n: p.detach().numpy().copy()
                  for n, p in trainer.model.named_parameters()
                  if p.requires_grad}
    one_abs = sum(p.detach().double().abs().sum().item()
                  for p in trainer.model.parameters())
    names = {n for n, _ in trainer.model.named_parameters()}

    pj = to_jnp(params)
    mask = joptim.trainable_mask(pj)
    mesh = jtrain.make_mesh(jax.devices()[:2])
    state = jtrain.replicate(jtrain.create_train_state(pj, 1e-3), mesh)
    jb = jtrain.shard_batch({k: jnp.asarray(v) for k, v in batch.items()},
                            mesh)
    new_state, jm = jtrain.make_train_step(jconf, mask)(state, jb, rng)
    # the port's parameters (the trunk's BatchNorms are buffers there)
    jabs = float(sum(np.abs(np.asarray(leaf, np.float64)).sum()
                     for n, leaf in _leaves(new_state.params) if n in names))
    return dict(ranks=ranks, one=one, one_params=one_params,
                one_abs=one_abs, jax={k: float(v) for k, v in jm.items()},
                jax_abs=jabs)


@pytest.mark.parametrize('name', METRICS)
def test_two_process_step_matches_one_process_and_jax(dp_step, name):
    """Each rank reports the global batch's metrics: the one-process
    step's and JAX's mesh step's (JAX's test_distributed bounds)."""
    for r in dp_step['ranks']:
        assert r['metrics']['skipped'] == 0.0
        np.testing.assert_allclose(r['metrics'][name], dp_step['one'][name],
                                   rtol=1e-4, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(r['metrics'][name], dp_step['jax'][name],
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_two_process_step_updates_the_parameters_alike(dp_step):
    """Both ranks hold the same parameters after the step, each the
    one-process step's within 1e-6, and JAX's by their absolute sum (JAX's
    test_distributed bound)."""
    r0, r1 = dp_step['ranks']
    np.testing.assert_allclose(r0['param_abs_sum'], r1['param_abs_sum'],
                               rtol=1e-12)
    np.testing.assert_allclose(r0['param_abs_sum'], dp_step['one_abs'],
                               rtol=1e-6)
    np.testing.assert_allclose(r0['param_abs_sum'], dp_step['jax_abs'],
                               rtol=1e-6)
    for r in (r0, r1):
        assert r['params'].keys() == dp_step['one_params'].keys()
        for k, v in dp_step['one_params'].items():
            np.testing.assert_allclose(r['params'][k], v, rtol=0, atol=1e-6,
                                       err_msg=k)


def test_per_rank_mean_would_miss(dp_step):
    """The test has teeth: the two images label different numbers of
    anchors, so the mean of the ranks' own RPN losses misses the global
    loss by more than the bound the step is held to."""
    naive = np.mean([r['naive_rpn_loss_cls'] for r in dp_step['ranks']])
    want = dp_step['one']['rpn_loss_cls']
    assert abs(naive - want) > 1e-4 * abs(want) + 1e-5, (naive, want)


# ------------------------------------------- the dataset CLI under --dist

def test_dataset_cli_dist_matches_one_process(tmp_path, monkeypatch):
    """Two processes of `python -m dana_tpu_torch.inference --dist` split
    the chunks; the chief's merged detections equal a one-process run's
    (tie-aware), and each rank wrote its partial."""
    from test_inference_cli import BASE_ARGS, _assert_detections_match
    from dana_tpu_torch import inference as port_cli
    from dana_tpu_torch.data.synth import synth_fsod
    monkeypatch.setenv('DANA_SYNTH_ROOT', str(tmp_path / 'synth'))
    synth_fsod('test', num_images=12)
    synth_fsod('train')
    s = BASE_ARGS.index('--set')

    def argv(out, *flags):
        return (BASE_ARGS[:s] + ['--bs', '2', '--eval_dir', str(out),
                                 '--device', 'cpu', *flags]
                + BASE_ARGS[s:] + ['TPU.STEM_S2D', 'False'])

    torch.set_num_threads(2)
    one = port_cli.main(argv(tmp_path / 'one'))
    init = f'file://{tmp_path}/rdzv'
    _run_children([[sys.executable, '-m', 'dana_tpu_torch.inference',
                    *argv(tmp_path / 'pair', '--dist', '--coordinator', init,
                          '--num_procs', '2', '--proc_id', str(r))]
                   for r in (0, 1)], tmp_path, 'eval_rank')
    for r in (0, 1):
        assert (tmp_path / 'pair' / f'detections_rank{r}.pkl').exists()
    _assert_detections_match(str(tmp_path / 'one'), str(tmp_path / 'pair'))
    assert len(one['stats']) == 12


# ------------------------------------------- the training CLI under --dist

def test_training_cli_dist_matches_one_process(tmp_path, monkeypatch):
    """Two processes of `python -m dana_tpu_torch.train --dist --mGPUs`
    (gloo on the CPU) train the one-process run's epoch at the same global
    --bs 2, each assembling its row of every batch and drawing its rows of
    the global draws: the chief's checkpoint equals the one-process
    run's, and only the chief writes one."""
    from test_torch_port_train_cli import SET
    from dana_tpu_torch import train as train_cli
    from dana_tpu_torch.data.synth import synth_fsod
    from dana_tpu_torch.utils import checkpoint as tckpt
    monkeypatch.setenv('DANA_SYNTH_ROOT', str(tmp_path / 'synth'))
    synth_fsod('test', num_images=4)

    def argv(save, *flags):
        return ['--dataset', 'synth_test', '--bs', '2', '--way', '2',
                '--shot', '1', '--epochs', '1', '--disp_interval', '1',
                '--dlog', '--save_dir', str(save), '--seed', '3',
                '--device', 'cpu', '--nw', '1', *flags, '--set', *SET]

    torch.set_num_threads(2)
    one = train_cli.main(argv(tmp_path / 'one'))
    assert one['epochs'][0]['steps'] == 2
    init = f'file://{tmp_path}/rdzv'
    outs = _run_children([[sys.executable, '-m', 'dana_tpu_torch.train',
                           *argv(tmp_path / f'pair{r}', '--mGPUs', '--dist',
                                 '--coordinator', init, '--num_procs', '2',
                                 '--proc_id', str(r))]
                          for r in (0, 1)], tmp_path, 'train_rank')
    assert 'data-parallel over 2 devices' in outs[0]
    name = os.path.relpath(one['checkpoint'], tmp_path / 'one')
    assert not (tmp_path / 'pair1' / name).exists()
    want = tckpt.read_dkpt(one['checkpoint'])['model']
    got = tckpt.read_dkpt(str(tmp_path / 'pair0' / name))['model']
    want, got = dict(_leaves(want)), dict(_leaves(got))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=0, atol=1e-5, err_msg=k)
