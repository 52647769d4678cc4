"""The port's dataset inference CLI (`dana_tpu_torch.inference`) against the
JAX package's (`inference.py`) on the CPU.

Both run `tests/test_inference_cli.py`'s shrunken BASE_ARGS (ResNet-50 at
full width, 128 px queries, 12 anchors from the default `--ascale 4`) with
`TPU.STEM_S2D False` over `synth_test`, with DAnA and with FSOD, written
by the port's generator (PPM images, which cv2 reads too), from the same
seed.  cv2 runs without IPP for
the JAX run: IPP's float resize sits ~0.01 grey from cv2's own algorithm,
which the port reproduces (tests/test_torch_port_data.py).

Detections are compared on the network's pixel grid: `detections.pkl`
holds boxes in source-image pixels, 1 / im_scale = 3.75 times the query's
at these settings, so each image's boxes are scaled back by its im_scale
before `_assert_detections_match` holds them to the 2e-3 px that rois keep
through the two packages' float32 forwards (ROADMAP "Carried findings").
"""

import pathlib
import pickle
import sys

import cv2
import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from test_inference_cli import BASE_ARGS, _assert_detections_match  # noqa

from dana_tpu_torch import inference as port_cli  # noqa: E402
from dana_tpu_torch.models import dana as tdana  # noqa: E402
from dana_tpu_torch.utils import args as targs  # noqa: E402
from dana_tpu_torch.utils import checkpoint as tckpt  # noqa: E402

COORD_ATOL = 2e-3      # query px: rois through the two float32 forwards
STATS_ATOL = 1e-3
_SET = BASE_ARGS.index('--set')


def _argv(out_dir, *flags, net='DAnA'):
    base = list(BASE_ARGS)
    base[base.index('--net') + 1] = net
    return (base[:_SET] + ['--bs', '4', '--eval_dir', str(out_dir), *flags]
            + base[_SET:] + ['TPU.STEM_S2D', 'False'])


@pytest.fixture(scope='module')
def synth_root(tmp_path_factory):
    from dana_tpu_torch.data.synth import synth_fsod
    root = tmp_path_factory.mktemp('synth')
    mp = pytest.MonkeyPatch()
    mp.setenv('DANA_SYNTH_ROOT', str(root))
    synth_fsod('test', num_images=20)
    synth_fsod('train')
    yield root
    mp.undo()


def _jax_cli(out, *flags, net='DAnA', extra_set=()):
    import inference as jax_cli
    ipp = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        return out, jax_cli.main(_argv(out, *flags, net=net)
                                 + list(extra_set))
    finally:
        cv2.ipp.setUseIPP(ipp)


@pytest.fixture(scope='module')
def jax_run(synth_root, tmp_path_factory):
    return _jax_cli(tmp_path_factory.mktemp('jax_eval'))


def _on_query_grid(src, dst):
    """Copy src/detections.pkl to dst with every image's boxes times its
    query scale (synth images are 480 x 640, scaled to 128 px)."""
    from dana_tpu_torch.data.blob import query_scale
    with open(src / 'detections.pkl', 'rb') as f:
        boxes = pickle.load(f)
    scale = np.float32(query_scale(480, 640, 128))
    for cls_boxes in boxes:
        for i, d in enumerate(cls_boxes):
            if isinstance(d, np.ndarray) and len(d):
                cls_boxes[i] = np.concatenate([d[:, :4] * scale, d[:, 4:]],
                                              1)
    dst.mkdir()
    with open(dst / 'detections.pkl', 'wb') as f:
        pickle.dump(boxes, f)
    return dst


def _check_against_jax(jax_run, out, result):
    jax_out, jax_result = jax_run
    _assert_detections_match(_on_query_grid(jax_out, out / 'jax_grid'),
                             _on_query_grid(out, out / 'port_grid'),
                             coord_atol=COORD_ATOL)
    assert len(result['stats']) == 12
    np.testing.assert_allclose(result['stats'], jax_result['stats'],
                               atol=STATS_ATOL)
    with open(out / 'detections.pkl', 'rb') as f:
        boxes = pickle.load(f)
    assert sum(isinstance(d, np.ndarray) and len(d) > 0
               for c in boxes for d in c) > 0


def test_cli_matches_jax(jax_run, tmp_path):
    result = port_cli.main(_argv(tmp_path, '--device', 'cpu'))
    _check_against_jax(jax_run, tmp_path, result)
    t = result['timing']
    assert t['images'] == 20 and t['chunks'] == 5 and t['img_per_s'] > 0


def test_cli_fsod_matches_jax(synth_root, tmp_path):
    """--net fsod, each chunk's support stack encoded with it in both CLIs:
    the same detections and COCOeval stats, serving the seed-5 weights
    with the RPN conv scaled by 1e-2.  At random init FSOD correlates
    un-normalised features (up to 1.9e4 here), so its RPN saturates: 41%
    of a chunk's anchors score exactly 1.0 and which of those NMS keeps
    follows the float32 last bits of each package (a kept proposal 127 px
    apart in one chunk); scaled, the scores spread."""
    from dana_tpu.utils import checkpoint as jckpt
    c = targs.load_cfg(targs.parse_args(_argv(tmp_path, net='fsod')))
    from dana_tpu_torch.models import frameworks
    from dana_tpu_torch.utils.config import dana_config
    params = frameworks.init_params(dana_config(c, 1, 1, 'fsod'), seed=5)
    params['RCNN_rpn']['RPN_Conv']['weight'] *= np.float32(1e-2)
    path = str(tmp_path / 'fsod.dkpt')
    jckpt.save_checkpoint(path, params)
    jax_run = _jax_cli(tmp_path / 'jax', '--checkpath', path, net='fsod')
    result = port_cli.main(_argv(tmp_path / 'port', '--device', 'cpu',
                                 '--checkpath', path, net='fsod'))
    _check_against_jax(jax_run, tmp_path / 'port', result)
    assert result['timing']['chunks'] == 5


@pytest.fixture(scope='module')
def port_int8_run(synth_root, tmp_path_factory):
    """The port's CLI with --set TPU.QUANT_INT8 True on one device, and the
    int8 line it printed."""
    import contextlib
    import io
    out = tmp_path_factory.mktemp('port_int8')
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        result = port_cli.main(_argv(out, '--device', 'cpu') + INT8_SET)
    return out, result, [ln for ln in printed.getvalue().splitlines()
                         if 'int8' in ln]


INT8_SET = ['TPU.QUANT_INT8', 'True']


def test_cli_int8_matches_jax(port_int8_run, tmp_path, capsys):
    """--set TPU.QUANT_INT8 True (scope 'tail': layer4 in int8, float32
    maps, so the float32 RoIAlign) in both CLIs on the seed-5 weights: the
    JAX CLI's line, and its detections and COCOeval stats at the float32
    tolerances.  The int8 layer4 quantizes each chunk's pooled rois by one
    max, so a pooled value that differs in its last float32 bits between
    the packages could flip a quantized step at an exact half and move a
    box by more than COORD_ATOL; at this size none does (the test would
    name the box)."""
    jax_run = _jax_cli(tmp_path / 'jax', extra_set=INT8_SET)
    jax_line = [ln for ln in capsys.readouterr().out.splitlines()
                if 'int8' in ln]
    out, result, port_line = port_int8_run
    assert port_line == jax_line == [
        'int8-quantized 10 convs (scope=tail) + int8 roi_align']
    _check_against_jax(jax_run, out, result)


def test_cli_int8_on_data_rows_matches_one_device(port_int8_run, tmp_path,
                                                  monkeypatch):
    """--mGPUs with TPU.QUANT_INT8 over two data rows (['cpu', 'cpu']):
    each chunk of 4 splits over the rows, whose int8 convs take the max
    over the whole chunk, so the detections equal the one-device int8
    CLI's (tie-aware at COORD_ATOL on the query grid)."""
    monkeypatch.setattr(port_cli, 'local_devices',
                        lambda device='cuda': [torch.device('cpu')] * 2)
    out = tmp_path / 'mgpus'
    n = torch.get_num_threads()
    torch.set_num_threads(2)     # two rows' threads share the CPU's cores
    try:
        result = port_cli.main(_argv(out, '--device', 'cpu', '--mGPUs')
                               + INT8_SET)
    finally:
        torch.set_num_threads(n)
    one, one_result, _ = port_int8_run
    assert result['timing']['chunks'] == one_result['timing']['chunks']
    a, b = tmp_path / 'a', tmp_path / 'b'
    _on_query_grid(out, a)
    _on_query_grid(one, b)
    _assert_detections_match(str(a), str(b), coord_atol=COORD_ATOL)


def _config():
    c = targs.load_cfg(targs.parse_args(BASE_ARGS))
    from dana_tpu_torch.utils.config import dana_config
    return dana_config(c, 1, 1)


@pytest.mark.parametrize('fmt', ['dkpt', 'pth'])
def test_cli_loads_jax_written_checkpoints(jax_run, tmp_path, fmt):
    """A `.dkpt` (with an optimizer state of the JAX package's classes) and
    a reference-format `.pth`, both written by the JAX package's exporters
    from the seed-5 weights, serve the JAX run's detections."""
    from dana_tpu.engine import optim
    from dana_tpu.utils import checkpoint as jckpt
    from dana_tpu.utils.torch_import import save_reference_pth
    params = tdana.init_params(_config(), seed=5)
    path = tmp_path / f'model_1_0.{fmt}'
    if fmt == 'dkpt':
        jckpt.save_checkpoint(str(path), params,
                              opt_state=optim.sgd_init(params))
        payload = tckpt.read_dkpt(str(path))
        assert isinstance(payload['optimizer'], tckpt.PickledObject)
        assert payload['optimizer'].name == 'SGDState'
    else:
        save_reference_pth(str(path), params)
    out = tmp_path / 'eval'
    result = port_cli.main(_argv(out, '--device', 'cpu', '--checkpath',
                                 str(path)))
    _check_against_jax(jax_run, out, result)


@pytest.mark.parametrize('flags, match', [
    (['--tp', '2', '--sp', '2'], 'pick one latency mode'),
    (['--dist'], '--num_procs'), (['--dist', '--num_procs', '2'], '--proc_id'),
    (['--dist', '--num_procs', '2', '--proc_id', '2'], 'not below'),
    (['--net', 'frcnn'], 'postprocess'),
    (['--set', 'TPU.QUANT_SCOPE', 'every'], 'the scopes are'),
    (['--set', 'TPU.STEM_S2D', 'True'], 'space-to-depth'),
    (['--net', 'fsod', '--backbone', 'vgg16'], 'ResNet-only'),
    (['--backbone', 'res152'], 'the trunks are'),
])
def test_cli_refuses_unported(tmp_path, flags, match):
    argv = ['--dataset', 'synth', '--eval_dir', str(tmp_path),
            '--device', 'cpu', *flags]
    with pytest.raises(SystemExit, match=match):
        port_cli.main(argv)


def test_cli_needs_cuda_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default device works')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        port_cli.main(['--dataset', 'synth', '--eval_dir', str(tmp_path)])
