"""Both CLIs of the port with `--set TPU.STEM_S2D True` on the CPU: the
dataset CLI against the JAX package's CLI at its default (the
space-to-depth stem), the loaders' packed items against the JAX package's
packing, and the training CLI's steps on packed episodes.

Sizes and tolerances are tests/test_torch_port_cli.py's and
tests/test_torch_port_train_cli.py's (ResNet-50 at full width, 128 px
queries over `synth_test`, detections tie-aware at 2e-3 px on the
network's grid, COCOeval stats within 1e-3).
"""

import cv2
import numpy as np
import pytest
import torch

from test_torch_port_cli import _argv, _check_against_jax, _jax_cli
from test_torch_port_train_cli import _train_argv

from dana_tpu.data import blob as jblob
from dana_tpu.data.imdb import combined_roidb as jcombined
from dana_tpu.data.inference_loader import InferenceLoader as JLoader

from dana_tpu_torch import inference as port_cli
from dana_tpu_torch import train as port_train
from dana_tpu_torch.data import blob
from dana_tpu_torch.data.fs_loader import FewShotLoader
from dana_tpu_torch.data.imdb import combined_roidb
from dana_tpu_torch.data.inference_loader import InferenceLoader
from dana_tpu_torch.data.synth import synth_fsod
from dana_tpu_torch.engine.train import Trainer

S2D = ['TPU.STEM_S2D', 'True']
FLOAT_TOL = 1e-3        # grey levels: the port's resize against cv2's


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


@pytest.mark.parametrize('ship_uint8', [False, True],
                         ids=['float', 'uint8'])
def test_inference_loader_packs_as_jax(synth_root, ship_uint8):
    """The eval loader's packed queries against the JAX loader's
    (`pack_s2d`, the fused native pad + pack) within the resize's
    tolerance, and bit for bit the port's own canvas packed."""
    from dana_tpu.utils.config import cfg
    cfg.TPU.SHIP_UINT8 = ship_uint8
    _, roidb, _, _ = combined_roidb('synth_test', training=False,
                                    use_flipped=False)
    _, jroidb, _, _ = jcombined('synth_test', training=False,
                                use_flipped=False)
    loader = InferenceLoader(roidb, None, pack_s2d=True,
                             ship_uint8=ship_uint8)
    plain = InferenceLoader(roidb, None, ship_uint8=ship_uint8)
    jloader = JLoader(jroidb, None, pack_s2d=True, skip_supports=True)
    for i in range(3):
        got, want = loader[i]['im_data'], jloader[i]['im_data']
        assert got.shape == want.shape == (307, 515, 12)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, jblob.s2d_pack(
            plain[i]['im_data'], u8_pad=blob.u8_pad_of(loader.pixel_means)))
        np.testing.assert_allclose(got.astype(np.float32),
                                   want.astype(np.float32), rtol=0,
                                   atol=1 if ship_uint8 else FLOAT_TOL)


def test_episode_loader_packs_as_the_jax_cli(synth_root):
    """A packed episode is its unpacked one through the JAX training CLI's
    `_pack_batch_s2d` (`s2d_pack` of the query, `s2d_pack_any` of the
    supports), bit for bit."""
    _, roidb, _, _ = combined_roidb('synth_train', use_flipped=True)
    kw = dict(num_way=2, num_shot=2, scale=128, buckets=[(128, 192)])
    packed = FewShotLoader(roidb, 9, pack_s2d=True, **kw)
    plain = FewShotLoader(roidb, 9, **kw)
    for i in packed.valid_indices()[:2] + [len(roidb) - 1]:
        a, b = packed[i], plain[i]
        np.testing.assert_array_equal(a['im_data'],
                                      jblob.s2d_pack(b['im_data']))
        np.testing.assert_array_equal(a['support_ims'],
                                      jblob.s2d_pack_any(b['support_ims']))
        for k in ('im_info', 'gt_boxes', 'all_gt_boxes', 'num_boxes'):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_cli_s2d_matches_jax_default(synth_root, tmp_path):
    """`--set TPU.STEM_S2D True` against the JAX CLI at its default stem:
    the same detections and COCOeval stats; the assembly threads packed
    every query (the loader's items are 12-channel)."""
    jax_run = _jax_cli(tmp_path / 'jax', extra_set=S2D)
    seen = []
    real = port_cli.Predictor.predict

    def predict(self, im_data, *a, **kw):
        seen.append(tuple(im_data.shape))
        return real(self, im_data, *a, **kw)
    port_cli.Predictor.predict = predict
    try:
        result = port_cli.main(_argv(tmp_path / 'port', '--device', 'cpu')
                               + S2D)
    finally:
        port_cli.Predictor.predict = real
    _check_against_jax(jax_run, tmp_path / 'port', result)
    assert len(seen) == result['timing']['chunks'] == 5
    assert all(s[-1] == 12 for s in seen), seen


def test_train_cli_steps_on_packed_episodes(tmp_path, monkeypatch):
    """The training CLI with `--set TPU.STEM_S2D True` trains on packed
    episodes (queries and supports 12-channel) over four images (two steps),
    and its losses are finite."""
    monkeypatch.setenv('DANA_SYNTH_ROOT', str(tmp_path / 'synth'))
    synth_fsod('test', num_images=4)
    seen = []
    real = Trainer.step

    def step(self, batch, *a, **kw):
        seen.append((batch['im_data'].shape[-1],
                     batch['support_ims'].shape[-1]))
        return real(self, batch, *a, **kw)
    Trainer.step = step
    was = torch.get_num_threads()
    torch.set_num_threads(min(2, was))
    try:
        summary = port_train.main(_train_argv(tmp_path / 'run', '--epochs',
                                              '1') + S2D)
    finally:
        Trainer.step = real
        torch.set_num_threads(was)
    assert len(seen) == 2 and all(s == (12, 12) for s in seen), seen
    curve = summary['epochs'][0]['loss_curve']
    assert len(curve) == len(seen) and np.isfinite(curve).all()
