"""The port's two CLIs on the new trunks and pooling modes against the JAX
package's on the CPU: `--backbone res101 --ls` and `--net vgg16` through
both dataset CLIs, a POOLING_MODE pool checkpoint served with the mode it
records, `--ls`'s config values against cfgs/res101_ls.yml, and the
training CLI's crop-mode checkpoint, resume and VGG16 gradient clip.

The dataset CLIs run tests/test_torch_port_cli.py's shrunken settings (128
px queries, 32 proposals an image: JAX's RoIPool takes a multiple of its
32-roi chunk) over synth_test; detections are held tie-aware at 2e-3 px on
the query grid and COCOeval's stats within 1e-3.  The VGG16 weights have
their RPN conv scaled by 0.1 (tests/test_torch_port_backbones_slice.py
`jax_params` says why), and torch computes its CPU convolutions itself,
not through oneDNN (that file's `cpu_convs`).
"""

import pathlib

import cv2
import numpy as np
import pytest

from dana_tpu_torch import inference as port_cli
from dana_tpu_torch import train as train_cli
from dana_tpu_torch.models import dana as tdana
from dana_tpu_torch.models import frameworks as tfw
from dana_tpu_torch.utils import args as targs
from dana_tpu_torch.utils import checkpoint as tckpt
from dana_tpu_torch.utils.config import dana_config
from test_torch_port_backbones_slice import cpu_convs  # noqa: F401 (a fixture)
from test_torch_port_cli import _argv, _check_against_jax, _jax_cli
from test_torch_port_imports import _flat
from test_torch_port_train_cli import _train_argv

from chip_smoke import call_count  # noqa: E402 (the root, on the path above)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def no_ipp():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


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


def test_cli_res101_large_scale_matches_jax(synth_root, tmp_path):
    """--backbone res101 --ls (its config's 800 px and 1000 proposals
    overridden by the shrunken --set, which comes after): the same
    detections and stats as the JAX CLI from the same seed."""
    flags = ('--backbone', 'res101', '--ls')
    jax_run = _jax_cli(tmp_path / 'jax', *flags)
    result = port_cli.main(_argv(tmp_path / 'port', '--device', 'cpu',
                                 *flags))
    _check_against_jax(jax_run, tmp_path / 'port', result)


def test_cli_vgg16_pool_checkpoint_matches_jax(synth_root, tmp_path):
    """--net vgg16 serving a checkpoint written with pooling_mode 'pool'
    and no POOLING_MODE on the command line: both CLIs take the mode from
    the checkpoint (the port pools with RoIPool, never RoIAlign) and give
    the same detections and stats."""
    from dana_tpu.utils import checkpoint as jckpt
    c = targs.load_cfg(targs.parse_args(_argv(tmp_path, net='vgg16')))
    assert c.POOLING_MODE == 'align'
    config = dana_config(c, 1, 1, 'vgg16')
    assert config.arch == 'vgg16' and config.framework == 'DAnA'
    params = tfw.init_params(config, seed=5)
    params['RCNN_rpn']['RPN_Conv']['weight'] *= np.float32(0.1)
    path = str(tmp_path / 'vgg16_pool.dkpt')
    jckpt.save_checkpoint(path, params, pooling_mode='pool')
    del params
    jax_run = _jax_cli(tmp_path / 'jax', '--checkpath', path, net='vgg16')
    with call_count(tdana, 'roi_pool') as pools, \
            call_count(tdana, 'roi_align') as aligns:
        result = port_cli.main(_argv(tmp_path / 'port', '--device', 'cpu',
                                     '--checkpath', path, net='vgg16'))
    _check_against_jax(jax_run, tmp_path / 'port', result)
    assert pools == [result['timing']['chunks']] and aligns == [0]


def test_large_scale_config_equals_res101_ls_yml(tmp_path):
    """--ls: the port's tree equals the JAX package's cfg after it loads
    cfgs/res101_ls.yml, wherever the two trees share a key but the port's
    own two (tests/test_torch_port_imports.py); without --ls, res50.yml's
    values (the JAX CLI reads no other file, whatever the backbone)."""
    import yaml
    from dana_tpu.utils.config import cfg, cfg_from_file
    from test_torch_port_imports import _PORT_OWN
    argv = ['--dataset', 'synth', '--backbone', 'vgg16', '--ls']
    port = dict(_flat(targs.load_cfg(targs.parse_args(argv))))
    cfg_from_file(str(ROOT / 'cfgs' / 'res101_ls.yml'))
    jax_flat = dict(_flat(cfg))
    for key, value in port.items():
        if key in _PORT_OWN or key == 'TRAIN.USE_FLIPPED' or \
                key.startswith(('ANCHOR_', 'MAX_NUM')):
            continue        # the port's own; --flip's; the --ascale preset
        want = jax_flat[key]
        if isinstance(want, np.ndarray):
            np.testing.assert_array_equal(value, want, err_msg=key)
        else:
            assert value == want, key
    with open(ROOT / 'cfgs' / 'res101_ls.yml') as f:
        file_flat = dict(_flat(yaml.safe_load(f)))
    for key in ('TRAIN.SCALES', 'TEST.SCALES', 'TEST.MAX_SIZE',
                'TEST.RPN_POST_NMS_TOP_N'):
        assert list(np.atleast_1d(port[key])) == \
            list(np.atleast_1d(file_flat[key])), key
    plain = dict(_flat(targs.load_cfg(targs.parse_args(argv[:-1]))))
    assert plain['TEST.SCALES'] == (600,) and plain['TEST.MAX_SIZE'] == 1000
    assert plain['TEST.RPN_POST_NMS_TOP_N'] == 300


@pytest.mark.parametrize('flags, clip', [
    ((), 0.0), (('--backbone', 'vgg16'), 10.0),
    (('--backbone', 'vgg16', '--clip_norm', '3'), 3.0),
    (('--net', 'vgg16'), 0.0)])
def test_train_cli_clip_norm_default(tmp_path, flags, clip):
    """The JAX CLI clips at 10 when --backbone is vgg16 and --clip_norm is
    0 (root train.py:161-162), which it reads from --backbone alone."""
    args = targs.parse_args(_train_argv(tmp_path, *flags))
    c = targs.load_cfg(args)
    config = dana_config(c, args.way, args.shot, args.net, args.backbone)
    assert config.arch == ('vgg16' if 'vgg16' in flags else 'resnet50')
    trainer = train_cli.make_trainer(args, c, config, tfw.build(config),
                                     args.lr, 'cpu')
    assert trainer.clip_norm == clip


def test_train_cli_crop_checkpoint_and_resume(tmp_path, monkeypatch):
    """One epoch (a 4-image synth_test at --bs 2) with --set POOLING_MODE
    crop: the crop pools every step, the checkpoint records 'crop', and --r
    without the --set takes crop back from it into the tree and the
    trainer's config."""
    from dana_tpu_torch.data.synth import synth_fsod
    monkeypatch.setenv('DANA_SYNTH_ROOT', str(tmp_path / 'synth'))
    synth_fsod('test', num_images=4)
    argv = _train_argv(tmp_path, '--epochs', '1')
    with call_count(tdana, 'roi_crop_pool') as crops:
        run = train_cli.main(argv + ['POOLING_MODE', 'crop'])
    epoch = run['epochs'][0]
    assert crops == [epoch['steps']] and epoch['steps'] == 2
    assert np.isfinite(epoch['loss_curve']).all() and not epoch['skipped']
    payload = tckpt.read_dkpt(run['checkpoint'])
    assert payload['pooling_mode'] == 'crop'
    c, _, trainer, start = train_cli.setup(targs.parse_args(
        _train_argv(tmp_path, '--epochs', '2', '--r', '--checkpath',
                    run['checkpoint'])))
    assert start == 2
    assert c.POOLING_MODE == trainer.config.pooling_mode == 'crop'


def test_cli_refuses_unknown_pooling_mode(tmp_path):
    with pytest.raises(SystemExit, match='align, pool, crop'):
        port_cli.main(['--dataset', 'synth', '--eval_dir', str(tmp_path),
                       '--device', 'cpu', '--set', 'POOLING_MODE', 'bilinear'])
