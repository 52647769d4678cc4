"""The port stands alone: it imports neither JAX nor the JAX package, nor
cv2, PIL, PyYAML, pycocotools or torchvision, and its entry points run on
the card unless the caller asks for the CPU."""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / 'dana_tpu_torch'


def test_import_pulls_in_no_jax():
    code = (
        'import importlib, pkgutil, sys\n'
        'import dana_tpu_torch\n'
        'for m in pkgutil.walk_packages(dana_tpu_torch.__path__,\n'
        '                               "dana_tpu_torch."):\n'
        '    importlib.import_module(m.name)\n'
        'bad = [m for m in sys.modules if m.split(".")[0] in (\n'
        '       "jax", "dana_tpu", "cv2", "PIL", "yaml", "pycocotools",\n'
        '       "torchvision")]\n'
        'print(len([m for m in sys.modules if m.startswith("dana_tpu_torch")]))\n'
        'assert not bad, bad\n')
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 38     # every module was imported


def test_no_source_names_jax():
    pat = re.compile(r'\bjax\b|\bdana_tpu\.')
    files = [p for p in PKG.rglob('*') if p.suffix in ('.py', '.cu')]
    assert len(files) >= 40
    hits = [f'{p.relative_to(ROOT)}:{i}'
            for p in files
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if pat.search(line)]
    assert not hits, hits


def test_predictor_defaults_to_cuda():
    from dana_tpu_torch.engine.predict import Predictor
    from dana_tpu_torch.utils.device import resolve_device
    if torch.cuda.is_available():
        assert resolve_device().type == 'cuda'
        return
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        Predictor(None, None)
    assert resolve_device('cpu').type == 'cpu'


def test_kernel_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA device is refused,
    never routed to the plain version."""
    from dana_tpu_torch.ops.cisa_attention import cisa_attention_shots
    from dana_tpu_torch.ops.roi_align import roi_align
    meta = torch.empty(1, 4, 4, 8, device='meta')
    with pytest.raises(ValueError):
        roi_align(meta, torch.empty(1, 2, 4, device='meta'))
    q = torch.empty(1, 4, 8, device='meta')
    with pytest.raises(ValueError):
        cisa_attention_shots(q, torch.empty(1, 1, 2, 8, device='meta'),
                             torch.empty(1, 1, 2, 8, device='meta'),
                             torch.empty(1, 1, 2, device='meta'), 1.0, 0.1)


def test_trainer_defaults_to_cuda():
    from dana_tpu_torch.engine.train import Trainer
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default device works')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        Trainer(None, None)


def test_training_kernel_wrappers_refuse_other_devices():
    from dana_tpu_torch.ops.cisa_attention import cisa_attention
    from dana_tpu_torch.ops.roi_align import roi_align_pw
    with pytest.raises(ValueError):
        roi_align_pw(torch.empty(1, 4, 4, 8, device='meta'),
                     torch.empty(1, 2, 7, 4, device='meta'),
                     torch.empty(1, 2, 7, 4, device='meta'))
    with pytest.raises(ValueError):
        cisa_attention(torch.empty(1, 4, 8, device='meta'),
                       torch.empty(1, 2, 8, device='meta'),
                       torch.empty(1, 2, 8, device='meta'),
                       torch.empty(1, 1, 2, device='meta'), 1.0, 0.1)


# run with cv2, PIL, PyYAML, JAX and the JAX package made unimportable
_WITHOUT = (
    'import sys\n'
    'for m in ("cv2", "PIL", "yaml", "jax", "optax", "dana_tpu"):\n'
    '    sys.modules[m] = None\n')


def test_data_path_runs_without_cv2_pil_yaml_or_jax(tmp_path):
    """What the CLI needs before its model: every port module, a synth
    split written and read back, its roidb, a support pool, a loader item,
    the CLI's arguments and config, and a checkpoint the JAX package wrote
    (optimizer state of its classes included), all with those modules
    blocked."""
    import numpy as np
    from dana_tpu.engine import optim
    from dana_tpu.utils import checkpoint as jckpt
    params = {'w': np.arange(6, dtype=np.float32).reshape(2, 3)}
    ckpt = str(tmp_path / 'model_1_0.dkpt')
    jckpt.save_checkpoint(ckpt, params, opt_state=optim.sgd_init(params))
    code = _WITHOUT + (
        'import importlib, pkgutil\n'
        'import dana_tpu_torch\n'
        'for m in pkgutil.walk_packages(dana_tpu_torch.__path__,\n'
        '                               "dana_tpu_torch."):\n'
        '    importlib.import_module(m.name)\n'
        'from dana_tpu_torch.data.imdb import combined_roidb\n'
        'from dana_tpu_torch.data.inference_loader import (\n'
        '    InferenceLoader, SupportPool)\n'
        'from dana_tpu_torch.utils import args, checkpoint\n'
        'ds, roidb, _, _ = combined_roidb("synth_test", training=False,\n'
        '                                 use_flipped=False)\n'
        'pool = SupportPool(ds.classes, 2, support_roidb=roidb, seed=0)\n'
        'item = InferenceLoader(roidb, pool, scale=128,\n'
        '                       buckets=[(128, 192)])[0]\n'
        'assert item["im_data"].shape == (128, 192, 3), item["im_data"].shape\n'
        'assert pool.get(item["target_cls"]).shape == (2, 320, 320, 3)\n'
        'a = args.parse_args(["--dataset", "synth", "--device", "cpu"])\n'
        'c = args.load_cfg(a)\n'
        'assert c.ANCHOR_SCALES == [4, 8, 16, 32] and c.MAX_NUM_GT_BOXES == 50\n'
        f'p = checkpoint.read_dkpt({ckpt!r})\n'
        'assert p["model"]["w"].sum() == 15 and p["optimizer"].name\n'
        'bad = [m for m in sys.modules if sys.modules[m] is not None\n'
        '       and m.split(".")[0] in ("cv2", "PIL", "yaml", "jax",\n'
        '                               "dana_tpu", "optax")]\n'
        'assert not bad, bad\n'
        'print("ok")\n')
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               DANA_SYNTH_ROOT=str(tmp_path / 'synth'))
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == 'ok'


def _flat(tree, prefix=''):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f'{prefix}{k}.')
        else:
            yield f'{prefix}{k}', v


# deliberate departures of the port's built-in config (utils/config.py):
# a smaller image cache a process, and the direct stem by default (the
# space-to-depth stem is there, TPU.STEM_S2D True; the JAX package's
# default was chosen for its TPU, and the port's awaits a benchmark)
_PORT_OWN = {'TPU.IMAGE_CACHE_MB': 256, 'TPU.STEM_S2D': False}


def test_builtin_config_equals_res50_yml():
    """The port's built-in tree equals the JAX package's cfg after it loads
    cfgs/res50.yml, for every key the port reads, but the two it sets
    itself; and every key of the file the port has, the file's value."""
    import numpy as np
    import yaml
    from dana_tpu.utils.config import cfg, cfg_from_file
    from dana_tpu_torch.utils.config import default_cfg
    yml = ROOT / 'cfgs' / 'res50.yml'
    cfg_from_file(str(yml))
    jax_flat = dict(_flat(cfg))
    port_flat = dict(_flat(default_cfg()))
    assert len(port_flat) >= 25
    for key, value in port_flat.items():
        want = _PORT_OWN.get(key, jax_flat[key])
        if isinstance(want, np.ndarray):
            np.testing.assert_array_equal(value, want, err_msg=key)
        else:
            assert value == want and type(value) is type(want), key
    with open(yml) as f:
        file_flat = dict(_flat(yaml.safe_load(f)))
    shared = set(file_flat) & set(port_flat)
    assert {'POOLING_MODE', 'POOLING_SIZE', 'TRAIN.BATCH_SIZE'} <= shared
    for key in shared:
        assert port_flat[key] == file_flat[key], key
