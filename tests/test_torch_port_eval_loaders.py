"""The port's evaluation loaders and its N-way evaluation against the JAX
package's on the CPU: `GeneralTestLoader`, `OracleLoader`,
`MultiwayLoader`, `ResamplingSupportPool` with `ALLCLSFSLoader` (crop and
directory modes) item for item, and `python -m
dana_tpu_torch.multiway_eval` against the computation of
`tools/synth_multiway_eval.py` on a random-init detector.

Everything but the pixels is held exactly: gt rows, counts, classes,
selected ways.  The pixels of queries and supports are held at
FLOAT_TOL grey, as tests/test_torch_port_data.py holds them: the port's
numpy resize reproduces cv2's INTER_LINEAR arithmetic to within float32
rounding (cv2 runs without IPP here, see that file).
"""

import dataclasses
import os
import random
import sys
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import pytest

from dana_tpu.data import inference_loader as jil
from dana_tpu.data.imdb import combined_roidb as jcombined

from dana_tpu_torch import multiway_eval
from dana_tpu_torch.data import blob, inference_loader as il
from dana_tpu_torch.data.coco_split import CocoFormatDataset
from dana_tpu_torch.data.imdb import combined_roidb
from dana_tpu_torch.data.synth import synth_fsod

sys.path.insert(0, os.path.dirname(__file__))
from test_inference_cli import _assert_detections_match  # noqa: E402

FLOAT_TOL = 1e-3        # grey levels (tests/test_torch_port_data.py)
SMALL = dict(scale=128, buckets=[(128, 192), (192, 128)])
COORD_ATOL = 2e-3       # query px: rois through the two float32 forwards
STATS_ATOL = 1e-3


@pytest.fixture(autouse=True)
def no_ipp():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


@pytest.fixture(scope='module')
def synth_root(tmp_path_factory):
    """synth_train (60 images) and a 6-image synth_test."""
    root = tmp_path_factory.mktemp('synth')
    mp = pytest.MonkeyPatch()
    mp.setenv('DANA_SYNTH_ROOT', str(root))
    synth_fsod('test', num_images=6)
    synth_fsod('train')
    yield root
    mp.undo()


def _roidbs(name):
    ds, roidb, _, _ = combined_roidb(name, training=False, use_flipped=False)
    _, jroidb, _, _ = jcombined(name, training=False, use_flipped=False)
    return ds, roidb, jroidb


def _same_item(got, want):
    assert set(got) == set(want)
    for k in want:
        if k in ('im_data', 'support_ims'):
            assert got[k].shape == want[k].shape, k
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=FLOAT_TOL, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _same_loaders(loader, jloader, order=None):
    assert len(loader) == len(jloader)
    for i in order or range(len(loader)):
        _same_item(loader[i], jloader[i])


def test_general_and_oracle_loaders_match_jax(synth_root):
    _, roidb, jroidb = _roidbs('synth_test')
    _same_loaders(il.GeneralTestLoader(roidb, **SMALL),
                  jil.GeneralTestLoader(jroidb, **SMALL))
    oracle = il.OracleLoader(roidb, seed=7, **SMALL)
    _same_loaders(oracle, jil.OracleLoader(jroidb, seed=7, **SMALL))
    # every class's gt, shuffled: not the roidb's order for some image
    assert any(not np.array_equal(oracle[i]['gt_boxes'][:len(e['boxes']), 4],
                                  e['gt_classes'])
               for i, e in enumerate(roidb))


@pytest.mark.parametrize('way,epi_seed', [(2, 0), (5, 3)])
def test_multiway_loader_matches_jax(synth_root, way, epi_seed):
    imdb_, roidb, jroidb = _roidbs('synth_test')
    _, sup, jsup = _roidbs('synth_train')
    pool = il.SupportPool(imdb_.classes, 2, support_roidb=sup, seed=0)
    jpool = jil.SupportPool(imdb_.classes, 2, support_roidb=jsup, seed=0)
    loader = il.MultiwayLoader(roidb, pool, num_way=way, epi_seed=epi_seed,
                               **SMALL)
    _same_loaders(loader, jil.MultiwayLoader(jroidb, jpool, num_way=way,
                                             epi_seed=epi_seed, **SMALL))
    item = loader[0]
    assert item['support_ims'].shape == (way * 2, 320, 320, 3)
    assert len(set(item['selected_ways'].tolist())) == way


def test_resampling_pool_and_allcls_crop_mode_match_jax(synth_root):
    """Crop mode draws each item's supports from default_rng((seed,
    index)): the same items as the JAX loader's reseeded shared generator,
    in any order and from threads."""
    imdb_, roidb, jroidb = _roidbs('synth_test')
    _, sup, jsup = _roidbs('synth_train')
    loader = il.ALLCLSFSLoader(roidb, sup, imdb_.classes, num_shot=2,
                               seed=3, **SMALL)
    jloader = jil.ALLCLSFSLoader(jroidb, jsup, imdb_.classes, num_shot=2,
                                 seed=3, **SMALL)
    _same_loaders(loader, jloader)
    order = [4, 1, 5, 0, 3, 2]
    _same_loaders(loader, jloader, order)
    with ThreadPoolExecutor(4) as ex:
        threaded = list(ex.map(loader.__getitem__, order))
    for i, item in zip(order, threaded):
        _same_item(item, jloader[i])
    # the pool alone: item index -> the JAX pool reseeded with it
    jpool = jloader.pool
    for cls in loader.pool.classes_available()[:3]:
        for index in (0, 9):
            jpool.reseed(index)
            np.testing.assert_allclose(loader.pool.get(cls, index),
                                       jpool.get(cls), rtol=0, atol=FLOAT_TOL)
    assert loader.pool.classes_available() == jpool.classes_available()


def _support_dir(root, classes, roidb, counts):
    """<root>/<class>/ with counts[class] whole-image supports (PPM bytes
    in .jpg files) cut from the roidb's images."""
    for c, name in enumerate(classes[1:], 1):
        os.makedirs(root / name)
        for k in range(counts.get(name, 3)):
            im = blob.read_ppm(roidb[(3 * c + k) % len(roidb)]['image'])
            blob.write_ppm(str(root / name / f's{k}.jpg'),
                           im[5 * k:400 - 7 * k, 9 * k:600 - 3 * k])


def test_allcls_directory_mode_matches_jax(synth_root, tmp_path):
    imdb_, roidb, jroidb = _roidbs('synth_test')
    _, sup, _ = _roidbs('synth_train')
    _support_dir(tmp_path / 'sup', imdb_.classes, sup, {})
    kw = dict(classes=imdb_.classes, num_shot=2,
              support_dir=str(tmp_path / 'sup'), **SMALL)
    loader = il.ALLCLSFSLoader(roidb, **kw)
    jloader = jil.ALLCLSFSLoader(jroidb, **kw)
    _same_loaders(loader, jloader, [3, 0, 5, 1, 4, 2])
    for i in range(len(loader)):
        seen = []
        for c in roidb[i]['gt_classes']:
            if int(c) not in seen:
                seen.append(int(c))
        assert loader.target_class(i) == random.Random(0).sample(seen, 1)[0]


def test_allcls_directory_mode_refusals_match_jax(synth_root, tmp_path):
    """A class without images, a short class that can be a target and a
    seed raise in both packages; a short class that is never a target
    warns."""
    imdb_, roidb, jroidb = _roidbs('synth_test')
    _, sup, _ = _roidbs('synth_train')
    targets = {random.Random(0).sample(
        list(dict.fromkeys(int(c) for c in e['gt_classes'])), 1)[0]
        for e in roidb}
    never = [n for c, n in enumerate(imdb_.classes) if c and c not in targets]
    target = imdb_.classes[min(targets)]
    for name, counts, err in (
            ('empty', {target: 0}, FileNotFoundError),
            ('short', {target: 1}, ValueError)):
        _support_dir(tmp_path / name, imdb_.classes, sup, counts)
        kw = dict(classes=imdb_.classes, num_shot=2,
                  support_dir=str(tmp_path / name))
        with pytest.raises(err):
            il.ALLCLSFSLoader(roidb, **kw)
        with pytest.raises(err):
            jil.ALLCLSFSLoader(jroidb, **kw)
    with pytest.raises(ValueError, match='seed'):
        il.ALLCLSFSLoader(roidb, classes=imdb_.classes, num_shot=2, seed=1,
                          support_dir=str(tmp_path / 'short'))
    if never:
        _support_dir(tmp_path / 'warn', imdb_.classes, sup, {never[0]: 1})
        with pytest.warns(UserWarning, match='never sampled'):
            il.ALLCLSFSLoader(roidb, classes=imdb_.classes, num_shot=2,
                              support_dir=str(tmp_path / 'warn'))


def _jax_multiway(path, way, shot, out_dir):
    """tools/synth_multiway_eval.py's computation (its settings, loop and
    evaluation), on the JAX package, from the checkpoint at `path`; ->
    (all_boxes, COCOeval result)."""
    import jax
    import jax.numpy as jnp
    from dana_tpu.engine.postprocess import postprocess_batch
    from dana_tpu.models import dana
    from dana_tpu.models.layers import to_jnp
    from dana_tpu.utils import checkpoint as ck
    from dana_tpu.utils.config import cfg_from_list
    cfg_from_list(multiway_eval.SETTINGS)       # reset after the test
    imdb_tr, roidb_tr, _, _ = jcombined('synth_train', training=False,
                                        use_flipped=False)
    imdb_te, roidb_te, _, _ = jcombined('synth_test', training=False,
                                        use_flipped=False)
    params = to_jnp(ck.load_checkpoint(path)['model'])
    config = dana.DanaConfig(
        n_way=way, n_shot=shot, arch='resnet50', anchor_scales=(4, 8, 16, 32),
        test_pre_nms=600, test_post_nms=64, nms_cap=600)
    pool = jil.SupportPool(imdb_te.classes, shot, support_roidb=roidb_tr,
                           seed=0)
    loader = jil.MultiwayLoader(roidb_te, pool, num_way=way)

    @jax.jit
    def predict(params, im, info, sup):
        out = dana.forward(params, config, im, info, sup, training=False)
        return postprocess_batch(out['rois'], out['cls_prob'],
                                 out['bbox_pred'], info,
                                 max_per_image=100 // way)

    all_boxes = [[[] for _ in roidb_te] for _ in range(imdb_te.num_classes)]
    for i in range(len(roidb_te)):
        item = loader[i]
        sup = item['support_ims'].reshape(way, shot,
                                          *item['support_ims'].shape[1:])
        for wi, cls in enumerate(item['selected_ways']):
            dets, valid = predict(params, jnp.asarray(item['im_data'])[None],
                                  jnp.asarray(item['im_info'])[None],
                                  jnp.asarray(sup[wi])[None])
            all_boxes[int(cls)][i] = np.asarray(dets[0])[np.asarray(valid[0])]
    return all_boxes, imdb_te.evaluate_detections(all_boxes, out_dir)


def _on_query_grid(all_boxes, scale, path):
    """all_boxes with every box times the query scale, as detections.pkl
    in the directory `path`."""
    import pickle
    grid = [[np.concatenate([d[:, :4] * scale, d[:, 4:]], 1)
             if isinstance(d, np.ndarray) and len(d) else d for d in row]
            for row in all_boxes]
    path.mkdir()
    with open(path / 'detections.pkl', 'wb') as f:
        pickle.dump(grid, f)
    return path


def test_multiway_eval_matches_the_jax_tool(synth_root, tmp_path,
                                            monkeypatch):
    """5-way 2-shot: one request an image with its ways as a batch gives
    the tool's one request a way (detections tie-aware at 2e-3 query px,
    stats within 1e-3), on a random-init detector without a BA block (the
    kind the tool's harness trains), read from a JAX-written checkpoint as
    cisa."""
    from dana_tpu.models import dana as jdana
    from dana_tpu.utils import checkpoint as ck
    path = str(tmp_path / 'tool.dkpt')
    ck.save_checkpoint(path, jdana.init_params(jdana.DanaConfig(), seed=3))
    want_boxes, want = _jax_multiway(path, 5, 2, str(tmp_path / 'eval'))

    seen = {}
    real = CocoFormatDataset.evaluate_detections

    def record(self, all_boxes, output_dir='.'):
        seen['all_boxes'] = all_boxes
        return real(self, all_boxes, output_dir)
    monkeypatch.setattr(CocoFormatDataset, 'evaluate_detections', record)
    got = multiway_eval.main([path, '5', '2', 'resnet50', '--device', 'cpu'])
    assert got['timing']['images'] == 6
    scale = np.float32(blob.query_scale(480, 640, 304))
    _assert_detections_match(
        _on_query_grid(want_boxes, scale, tmp_path / 'jax'),
        _on_query_grid(seen['all_boxes'], scale, tmp_path / 'port'),
        coord_atol=COORD_ATOL)
    assert sum(len(d) for row in seen['all_boxes'] for d in row) > 0
    np.testing.assert_allclose(got['stats'], want['stats'], atol=STATS_ATOL)


def test_multiway_eval_takes_the_checkpoints_detector(tmp_path):
    """A checkpoint with a BA block serves as DAnA, one without as cisa,
    at the tool's proposal counts and anchors; a sibling is refused."""
    from dana_tpu_torch.models import frameworks
    from dana_tpu_torch.utils import checkpoint as ckpt_lib
    from dana_tpu_torch.utils import config as cfg
    from dana_tpu_torch.utils.weights import from_jax_params
    c = cfg.default_cfg()
    cfg.cfg_from_list(c, multiway_eval.SETTINGS)
    for net, ba in (('DAnA', True), ('cisa', False), ('fsod', False)):
        config = dataclasses.replace(
            cfg.dana_config(c, 5, 2, net),
            anchor_scales=multiway_eval.ANCHOR_SCALES)
        path = ckpt_lib.save_checkpoint(
            str(tmp_path / f'{net}.dkpt'),
            from_jax_params(frameworks.init_params(config, seed=0), config),
            extra=None if net == 'cisa' else {'framework': net})
        if net == 'fsod':
            with pytest.raises(SystemExit, match='fsod'):
                multiway_eval.load_detector(path, 5, 2, 'resnet50', c)
            continue
        _, got = multiway_eval.load_detector(path, 5, 2, 'resnet50', c)
        assert (got.framework, got.semantic_enhance) == (net, ba)
        assert (got.n_way, got.n_shot, got.test_pre_nms, got.test_post_nms,
                got.nms_cap, got.anchor_scales) == (5, 2, 600, 64, 600,
                                                    (4, 8, 16, 32))
