"""The port's serving export (dana_tpu_torch/serve.py and
tools/torch_export_serving.py) on the CPU, at the size of
tests/test_serve.py: DAnA 2-way 1-shot, 100 proposals before NMS, query
buckets 64x96 and 96x64, at most 2 queries a request, 224 px supports.

An artifact is held bit for bit against the live port (the same ops on
the same inputs, one process or two with the same thread count), and
against the JAX package's live `dana.forward` + `postprocess_batch` on the
same numpy weights at tests/test_torch_port_model.py's tolerances.  The
s2d variant of tests/test_serve.py has no port counterpart: the port
refuses a space-to-depth stem (ROADMAP "Not queued").
"""

import collections
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dana_tpu.engine.postprocess import postprocess_batch as jax_postprocess
from dana_tpu.models import dana as jdana
from dana_tpu.models.layers import to_jnp
from dana_tpu.utils import checkpoint as jckpt

from dana_tpu_torch import quant, serve
from dana_tpu_torch.engine.postprocess import postprocess_batch
from dana_tpu_torch.models import dana as tdana
from dana_tpu_torch.utils.weights import from_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(n_way=2, n_shot=1, train_pre_nms=100, train_post_nms=16,
             test_pre_nms=100, test_post_nms=8, nms_cap=100)
BUCKETS = ((64, 96), (96, 64))


def _caffe_like(tree, seed):
    """Caffe-magnitude BN statistics and non-zero residual convs (as
    tests/test_torch_port_model.py), so the numerics are a checkpoint's."""
    rng = np.random.default_rng(seed)

    def walk(node):
        for k, v in node.items():
            if not isinstance(v, dict):
                continue
            if 'running_var' in v:
                c = v['running_var'].shape[0]
                v['weight'] = rng.normal(1.0, 0.1, c).astype(np.float32)
                v['bias'] = rng.normal(0.0, 0.1, c).astype(np.float32)
                v['running_mean'] = rng.normal(0.0, 30.0, c).astype(np.float32)
                v['running_var'] = (rng.random(c) * 400 + 1).astype(np.float32)
            elif k == 'conv3' and not v['weight'].any():
                w = v['weight']
                v['weight'] = rng.normal(0.0, np.sqrt(2.0 / w.shape[-1]),
                                         w.shape).astype(np.float32)
            else:
                walk(v)
    walk(tree)
    return tree


def _match_detections(da, db, coord_atol=1e-4):
    """Tie-aware (tests/test_torch_port_model.py): same count, same score
    multiset, equal boxes for every score unique within the image."""
    assert da.shape == db.shape
    np.testing.assert_allclose(np.sort(da[:, 4]), np.sort(db[:, 4]),
                               rtol=1e-4, atol=1e-4)
    qa, qb = np.round(da[:, 4], 3), np.round(db[:, 4], 3)
    uniq, cnt = np.unique(qa, return_counts=True)
    for s in uniq[cnt == 1]:
        rb = db[qb == s]
        if len(rb) == 1:
            np.testing.assert_allclose(da[qa == s][:, :4], rb[:, :4],
                                       rtol=1e-4, atol=coord_atol)


def _inputs(seed, hw=(64, 96), b=2, sup_size=224):
    rng = np.random.default_rng(seed)
    sup = rng.normal(0, 50, (1, 2, sup_size, sup_size, 3)).astype(np.float32)
    im = (rng.normal(size=(b, *hw, 3)) * 40).astype(np.float32)
    info = np.tile(np.array([[*hw, 1.0]], np.float32), (b, 1))
    return torch.from_numpy(sup), torch.from_numpy(im), torch.from_numpy(info)


def _live(model, config, sup, im, info):
    """The live port: the support features (the artifact's encoder input),
    each query's row the first class's, then forward + postprocess."""
    with torch.inference_mode():
        feats = tdana.extract_support_feats(model, config, sup)
        rows = tuple(torch.cat([f] * len(im)) for f in feats)
        out = tdana.forward(model, config, im, info, support_feats=rows)
        return feats, rows, postprocess_batch(
            out['rois'], out['cls_prob'], out['bbox_pred'], info)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.fixture(scope='module')
def small():
    jconf = jdana.DanaConfig(use_pallas_attention=False, **SMALL)
    tconf = tdana.DanaConfig(**SMALL)
    trees = [_caffe_like(jdana.init_params(jconf, seed=s), seed=s + 10)
             for s in (0, 1)]
    return jconf, tconf, trees, [from_jax_params(t, tconf) for t in trees]


@pytest.fixture(scope='module')
def exported(small, tmp_path_factory):
    _, tconf, _, models = small
    out = str(tmp_path_factory.mktemp('serve') / 'artifact')
    meta = serve.export_predictor(models[0], tconf, out, buckets=BUCKETS,
                                  batch_size=2, sup_size=224, device='cpu')
    return out, meta, serve.load(out, device='cpu')


def test_export_roundtrip_bit_for_bit(small, exported):
    _, tconf, _, models = small
    out, meta, pred = exported
    assert {'batch_size', 'n_way', 'n_shot', 'arch', 's2d', 'sup_size',
            'buckets', 'postprocess', 'quantized'} <= set(meta)
    assert not meta['quantized'] and not meta['s2d']
    assert meta['weights'] == list(models[0].state_dict())
    with open(os.path.join(out, 'meta.json')) as f:
        assert json.load(f) == meta
    assert pred.buckets() == [(64, 96), (96, 64)]
    params = models[0].state_dict()
    for i, hw in enumerate(BUCKETS):
        sup, im, info = _inputs(i, hw)
        feats, rows, want = _live(models[0], tconf, sup, im, info)
        assert _equal(pred.encode(params, sup), feats)
        got = pred(params, im, info, *rows)
        assert got[0].shape == (2, 100, 5) and _equal(got, want)


def test_export_matches_jax(small, exported):
    jconf, _, trees, models = small
    _, _, pred = exported
    sup, im, info = _inputs(5)
    params = models[0].state_dict()
    feats = pred.encode(params, sup)
    dets, valid = pred(params, im, info,
                       *(torch.cat([f, f]) for f in feats))
    pj = to_jnp(trees[0])
    jfeats = jdana.extract_support_feats(pj, jconf, jnp.asarray(sup.numpy()))
    for a, b in zip(feats, jfeats):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4 * np.abs(np.asarray(b)).max())
    fwd = jax.jit(lambda p, q, i, f: jdana.forward(
        p, jconf, q, i, training=False, support_feats=f))
    jinfo = jnp.asarray(info.numpy())
    jo = fwd(pj, jnp.asarray(im.numpy()), jinfo,
             tuple(jnp.concatenate([f, f]) for f in jfeats))
    jd, jv = (np.asarray(x) for x in jax_postprocess(
        jo['rois'], jo['cls_prob'], jo['bbox_pred'], jinfo))
    td, tv = dets.numpy(), valid.numpy()
    np.testing.assert_array_equal(tv.sum(1), jv.sum(1))
    for i in range(len(td)):
        _match_detections(jd[i][jv[i]], td[i][tv[i]])


def test_export_refuses_s2d(small, tmp_path):
    _, tconf, _, models = small
    with pytest.raises(ValueError, match='space-to-depth'):
        serve.export_predictor(models[0], tconf, str(tmp_path / 'a'),
                               buckets=BUCKETS, s2d=True, device='cpu')
    assert not (tmp_path / 'a').exists()


def _program_ops(graph):
    """The ops a program's graph calls, in order."""
    return [str(n.target) for n in graph.nodes if n.op == 'call_function']


def _assert_card_artifact(card_dir, cpu_step, files):
    """An artifact for the card written on this host without one: every
    tensor its programs' nodes describe and every device they name is the
    card's, no tensor constant, each program loads, and the predict step
    calls the ops of `cpu_step` (the CPU export's, loaded) in the same
    order; `serve.load` refuses it here rather than serving on the CPU.
    -> the predict step's ops."""
    with open(os.path.join(card_dir, 'meta.json')) as f:
        assert json.load(f)['device'] == 'cuda:0'
    for name in files:
        ep = torch.export.load(os.path.join(card_dir, name))
        assert serve.program_devices(ep) == {'cuda:0'}, name
        assert not [k for k, t in ep.constants.items()
                    if isinstance(t, torch.Tensor)], name
    ops = _program_ops(ep.graph)
    assert ops == _program_ops(cpu_step.graph)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        serve.load(card_dir)
    return ops


def test_export_for_the_card_needs_the_card(small, exported, tmp_path):
    """The float32 export for the card is written on this host without
    one (traced on the CPU, placed on cuda:0), its predict step the CPU
    export's op for op, and only the card serves it: `serve.load` here
    raises rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a host with a card serves the artifact instead')
    _, tconf, _, models = small
    out = str(tmp_path / 'a')
    meta = serve.export_predictor(models[0], tconf, out, buckets=BUCKETS[:1],
                                  batch_size=2, sup_size=224, device='cuda')
    assert not meta['quantized']
    _assert_card_artifact(out, exported[2]._predict[BUCKETS[0]],
                          ['encode_supports.pt2', 'predict_64x96.pt2'])


def test_positional_table_and_anchors_built_on_the_device():
    """The tables the forward builds on its device, so that a program
    holds no constant, equal the numpy tables they replace."""
    from dana_tpu_torch.core import anchors
    for length, c in ((49, 1024), (400, 1024), (400, 512)):
        np.testing.assert_array_equal(
            tdana._pe(length, torch.zeros(1, c), torch.float32).numpy(),
            tdana.positional_encoding(length, c))
    base = anchors.generate_anchors(scales=np.array([4, 8, 16, 32]))
    sx, sy = np.meshgrid(np.arange(9) * 16, np.arange(5) * 16)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], 1)
    np.testing.assert_array_equal(
        anchors.shifted_anchors(5, 9, 16, base).numpy(),
        (base[None] + shifts[:, None]).reshape(-1, 4).astype(np.float32))


def test_second_seed_through_first_artifact(small, exported):
    """The weights are an argument: seed 1's state dict served through the
    artifact traced with seed 0's equals the live seed-1 model."""
    _, tconf, _, models = small
    _, _, pred = exported
    sup, im, info = _inputs(7, (96, 64))
    params = models[1].state_dict()
    feats, rows, want = _live(models[1], tconf, sup, im, info)
    assert _equal(pred.encode(params, sup), feats)
    got = pred(params, im, info, *rows)
    assert _equal(got, want)
    assert not _equal(got, _live(models[0], tconf, sup, im, info)[2])


def test_artifacts_hold_no_weights(small, exported):
    out, _, _ = exported
    weights = sum(v.numel() * v.element_size()
                  for v in small[3][0].state_dict().values())
    sizes = {f: os.path.getsize(os.path.join(out, f))
             for f in os.listdir(out) if f.endswith('.pt2')}
    assert len(sizes) == 3
    assert max(sizes.values()) < weights / 10, (sizes, weights)


def test_params_in_any_mapping(small, exported):
    """A state_dict() OrderedDict, and a dict in another key order, are
    taken in meta.json's order."""
    _, tconf, _, models = small
    _, _, pred = exported
    sup, im, info = _inputs(3)
    sd = models[0].state_dict()
    assert isinstance(sd, collections.OrderedDict)
    _, rows, want = _live(models[0], tconf, sup, im, info)
    assert _equal(pred(sd, im, info, *rows), want)
    shuffled = dict(reversed(list(sd.items())))
    assert _equal(pred(shuffled, im, info, *rows), want)


_CHILD = '''
import sys
import torch
torch.set_num_threads(int(sys.argv[3]))
from dana_tpu_torch import serve
pred = serve.load(sys.argv[1], device="cpu")
job = torch.load(sys.argv[2])
feats = pred.encode(job["params"], job["sup"])
outs = pred(job["params"], job["im"], job["info"],
            *(torch.cat([f, f]) for f in feats))
torch.save({"outs": outs, "feats": feats,
            "models": "dana_tpu_torch.models" in sys.modules},
           sys.argv[2] + ".out")
'''


def test_serves_in_a_process_without_the_model_code(small, exported,
                                                    tmp_path):
    _, tconf, _, models = small
    out, _, _ = exported
    sup, im, info = _inputs(4)
    job = str(tmp_path / 'job.pt')
    torch.save(dict(params=models[0].state_dict(), sup=sup, im=im,
                    info=info), job)
    subprocess.run([sys.executable, '-c', _CHILD, out, job,
                    str(torch.get_num_threads())], check=True, cwd=ROOT,
                   env=dict(os.environ, PYTHONPATH=ROOT), timeout=300)
    res = torch.load(job + '.out')
    assert res['models'] is False
    feats, _, want = _live(models[0], tconf, sup, im, info)
    assert _equal(res['feats'], feats) and _equal(res['outs'], want)


@pytest.fixture(scope='module')
def cli_export(tmp_path_factory):
    """tools/torch_export_serving.py on a JAX-written .dkpt (DAnA 2-way
    1-shot at the CLI's config: 12 anchors) with --quant tail, and the
    artifact loaded on the CPU."""
    sys.path.insert(0, os.path.join(ROOT, 'tools'))
    import torch_export_serving
    tmp = tmp_path_factory.mktemp('cli')
    tree = jdana.init_params(jdana.DanaConfig(n_way=2, n_shot=1,
                                              semantic_enhance=True), seed=2)
    ckpt = str(tmp / 'model_1_0.dkpt')
    jckpt.save_checkpoint(ckpt, tree)
    out = str(tmp / 'artifact')
    argv = ['--checkpath', ckpt, '--out', out, '--way', '2', '--shot', '1',
            '--quant', 'tail', '--buckets', '64x96', '--bs', '1',
            '--platforms', 'cpu']
    meta = torch_export_serving.main(argv)
    return (torch_export_serving, tree, ckpt, out, meta,
            serve.load(out, device='cpu'))


def test_cli_exports_a_quantized_artifact(cli_export):
    _, _, _, out, meta, _ = cli_export
    assert meta['quantized'] and meta['buckets'] == [
        {'bucket': [64, 96], 'file': 'predict_64x96.pt2'}]
    assert meta['device'] == 'cpu' and meta['batch_size'] == 1
    assert sorted(os.listdir(out)) == ['encode_supports.pt2', 'meta.json',
                                       'predict_64x96.pt2']


def test_int8_tail_artifact_equals_live_int8(cli_export):
    from dana_tpu_torch.utils import config as tcfg
    _, tree, _, _, _, pred = cli_export
    from dana_tpu_torch.utils.args import ASCALE_PRESETS
    c = tcfg.default_cfg()
    tcfg.cfg_from_list(c, ASCALE_PRESETS[4])          # the CLI's default
    config = tcfg.dana_config(c, 2, 1)
    model = from_jax_params(quant.quantize_params(tree, 'tail'), config)
    assert quant.count_int8(model) == 10
    sup, im, info = _inputs(6, b=1, sup_size=320)       # the tool's default
    params = model.state_dict()
    feats, rows, want = _live(model, config, sup, im, info)
    assert _equal(pred.encode(params, sup), feats)
    assert _equal(pred(params, im, info, *rows), want)


def test_cli_refuses_an_anchor_mismatch(cli_export, tmp_path):
    tool, _, ckpt, _, _, _ = cli_export
    with pytest.raises(SystemExit, match='anchor mismatch'):
        tool.main(['--checkpath', ckpt, '--out', str(tmp_path / 'a'),
                   '--ascale', '3', '--platforms', 'cpu'])
    with pytest.raises(SystemExit, match='space-to-depth'):
        tool.main(['--checkpath', ckpt, '--out', str(tmp_path / 'b'),
                   '--s2d'])


def test_cli_trace_on_cpu_for_the_card_needs_the_card(cli_export, tmp_path):
    """`--platforms cuda --quant tail` (the JAX tool's `--platforms tpu`)
    traces on the CPU of this host without a card and writes the int8
    artifact for the card, its predict step the CPU export's op for op
    (each int8 product one `dana_torch::int8_mm` call either way); only
    the card serves it (`serve.load` here raises)."""
    if torch.cuda.is_available():
        pytest.skip('a host with a card serves the artifact instead')
    tool, _, ckpt, _, _, cpu_pred = cli_export
    out = str(tmp_path / 'a')
    meta = tool.main(['--checkpath', ckpt, '--out', out, '--way', '2',
                      '--shot', '1', '--quant', 'tail', '--buckets', '64x96',
                      '--bs', '1', '--platforms', 'cuda'])
    assert meta['quantized']
    ops = _assert_card_artifact(out, cpu_pred._predict[(64, 96)],
                                ['encode_supports.pt2', 'predict_64x96.pt2'])
    assert sum(op == 'dana_torch.int8_mm.default' for op in ops) == 10
