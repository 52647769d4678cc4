"""The port's data path (dana_tpu_torch/data, eval) against the JAX
package's on the CPU: image decoding, the cv2-free resize, query and
support blobs at every query bucket, the synth roidb, the support pool,
the inference loader and the numpy COCOeval.

The synth sets are written by the port's generator (PPM), which the JAX
package reads through cv2.  cv2 runs without IPP here: IPP's float resize
sits ~0.01 grey from cv2's own INTER_LINEAR algorithm, which the port
reproduces (`blob.resize_linear`).
"""

import json
import sys

import cv2
import numpy as np
import pytest

from dana_tpu.data import blob as jblob
from dana_tpu.data.imdb import combined_roidb as jcombined
from dana_tpu.data.inference_loader import InferenceLoader as JLoader
from dana_tpu.data.inference_loader import SupportPool as JPool
from dana_tpu.data.coco_json import COCO as JCOCO
from dana_tpu.eval import coco_eval as jce

from dana_tpu_torch.data import blob
from dana_tpu_torch.data.coco_json import COCO
from dana_tpu_torch.data.imdb import combined_roidb
from dana_tpu_torch.data.inference_loader import InferenceLoader, SupportPool
from dana_tpu_torch.data.synth import synth_fsod
from dana_tpu_torch.eval import coco_eval as ce

MEANS = np.array([[[102.9801, 115.9465, 122.7717]]])
FLOAT_TOL = 1e-3        # grey levels, float32 images
# (source h, w) -> the query bucket its 600 px scaling lands in
BUCKET_SOURCES = {(480, 640): (608, 1024), (640, 480): (1024, 608),
                  (500, 500): (704, 704), (300, 580): (608, 1216),
                  (580, 300): (1216, 608)}


@pytest.fixture(autouse=True)
def no_ipp():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


@pytest.fixture(scope='module')
def synth_root(tmp_path_factory):
    root = tmp_path_factory.mktemp('synth')
    mp = pytest.MonkeyPatch()
    mp.setenv('DANA_SYNTH_ROOT', str(root))
    synth_fsod('test', num_images=20)
    synth_fsod('train')
    yield root
    mp.undo()


def _image(hw, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (*hw, 3)).astype(np.float32)


def test_imread_ppm_and_npy_match_cv2(tmp_path):
    im = np.random.default_rng(1).integers(0, 256, (37, 53, 3), np.uint8)
    ppm = str(tmp_path / 'a.ppm')
    blob.write_ppm(ppm, im)
    np.testing.assert_array_equal(blob.imread_bgr(ppm),
                                  cv2.imread(ppm, cv2.IMREAD_COLOR))
    np.testing.assert_array_equal(blob.imread_bgr(ppm), im)
    npy = str(tmp_path / 'a.npy')
    np.save(npy, im)
    cache = blob.ImageCache(1)
    np.testing.assert_array_equal(blob.imread_bgr(npy, cache), im)
    np.testing.assert_array_equal(blob.imread_bgr(npy, cache), im)  # a hit


def test_imread_other_formats_need_cv2(tmp_path, monkeypatch):
    jpg = str(tmp_path / 'a.jpg')
    cv2.imwrite(jpg, np.zeros((8, 8, 3), np.uint8))
    assert blob.imread_bgr(jpg).shape == (8, 8, 3)        # through cv2
    monkeypatch.setitem(sys.modules, 'cv2', None)
    with pytest.raises(ImportError, match='a.jpg'):
        blob.imread_bgr(jpg)


@pytest.mark.parametrize('hw, scale', [
    ((480, 640), 1.25), ((333, 517), 600 / 333), ((700, 900), 0.61),
    ((37, 53), 2.7), ((101, 63), 0.33), ((300, 580), 2.0)])
def test_resize_matches_cv2(hw, scale):
    im = _image(hw) - 120
    got = blob.resize_linear(im, scale=scale)
    want = cv2.resize(im, None, fx=scale, fy=scale,
                      interpolation=cv2.INTER_LINEAR)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_TOL)
    for out_hw in ((320, 211), (157, 320), (hw[0] + 7, hw[1] - 5), (320, 1)):
        want = cv2.resize(im, out_hw[::-1], interpolation=cv2.INTER_LINEAR)
        np.testing.assert_allclose(blob.resize_linear(im, out_hw), want,
                                   rtol=0, atol=FLOAT_TOL)
    u8 = (im + 120).astype(np.uint8)
    want = cv2.resize(u8, None, fx=scale, fy=scale,
                      interpolation=cv2.INTER_LINEAR).astype(int)
    got = np.rint(blob.resize_linear(u8.astype(np.float32), scale=scale))
    assert np.abs(got - want).max() <= 1


@pytest.mark.parametrize('hw', list(BUCKET_SOURCES),
                         ids=lambda hw: f'{hw[0]}x{hw[1]}')
def test_blobs_match_jax_at_every_bucket(hw):
    im = _image(hw, seed=hw[0])
    got, info = blob.query_blob(im, MEANS, 600)
    want, jinfo = jblob.query_blob(im, MEANS, 600)
    assert got.shape[:2] == BUCKET_SOURCES[hw] == want.shape[:2]
    np.testing.assert_array_equal(info, jinfo)
    np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_TOL)
    got, info = blob.query_blob_u8(im, 600, pixel_means=MEANS)
    want, jinfo = jblob.query_blob_u8(im, 600, pixel_means=MEANS)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(info, jinfo)
    assert np.abs(got.astype(int) - want).max() <= 1
    box = np.array([hw[1] * 0.1, hw[0] * 0.2, hw[1] * 0.7, hw[0] * 0.6])
    for name, args in (('support_blob_exact', (box, MEANS)),
                       ('support_blob', (box, MEANS)),
                       ('support_blob_whole', (MEANS,))):
        np.testing.assert_allclose(getattr(blob, name)(im, *args),
                                   getattr(jblob, name)(im, *args),
                                   rtol=0, atol=FLOAT_TOL, err_msg=name)


def test_synth_roidb_matches_jax(synth_root):
    for split in ('synth_test', 'synth_train'):
        _, got, gr, gi = combined_roidb(split, training=False,
                                        use_flipped=False)
        _, want, wr, wi = jcombined(split, training=False, use_flipped=False)
        assert len(got) == len(want) > 0
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gr, wr)
        for g, w in zip(got, want):
            assert (g['image'], g['width'], g['height'], g['img_id']) \
                == (w['image'], w['width'], w['height'], w['img_id'])
            assert g['image'].endswith('.ppm')
            for k in ('boxes', 'gt_classes', 'gt_overlaps', 'seg_areas',
                      'max_overlaps', 'max_classes'):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _pools(synth_root, support_dir=None, shot=3):
    imdb_, _, _, _ = combined_roidb('synth_test', training=False,
                                    use_flipped=False)
    _, sup, _, _ = combined_roidb('synth_train', training=False,
                                  use_flipped=False)
    _, jsup, _, _ = jcombined('synth_train', training=False,
                              use_flipped=False)
    kw = dict(support_dir=support_dir, seed=0)
    return (SupportPool(imdb_.classes, shot, support_roidb=sup, **kw),
            JPool(imdb_.classes, shot, support_roidb=jsup, **kw))


def _same_pool(got, want):
    assert got.classes_available() == want.classes_available()
    assert len(got.classes_available()) > 0
    for c in want.classes_available():
        np.testing.assert_allclose(got.get(c), want.get(c), rtol=0,
                                   atol=FLOAT_TOL)


def test_support_pool_crops_match_jax(synth_root):
    _same_pool(*_pools(synth_root))


def test_support_pool_directory_matches_jax(synth_root, tmp_path):
    """The directory pool: <dir>/<class>/ of whole-image supports, four
    per class, three drawn by the reference's seeded sample."""
    imdb_, roidb, _, _ = combined_roidb('synth_train', training=False,
                                        use_flipped=False)
    for c, name in enumerate(imdb_.classes[1:], 1):
        (tmp_path / name).mkdir()
        for k in range(4):
            im = cv2.imread(roidb[(4 * c + k) % len(roidb)]['image'])
            h, w = im.shape[:2]
            crop = im[k * 10:h - 50 * k, 20 * k:w - 30]
            blob.write_ppm(str(tmp_path / name / f's{k}.ppm'), crop)
    _same_pool(*_pools(synth_root, support_dir=str(tmp_path)))


def test_inference_loader_matches_jax(synth_root):
    pool, jpool = _pools(synth_root)
    _, roidb, _, _ = combined_roidb('synth_test', training=False,
                                    use_flipped=False)
    _, jroidb, _, _ = jcombined('synth_test', training=False,
                                use_flipped=False)
    loader = InferenceLoader(roidb, pool, max_num_box=50)
    jloader = JLoader(jroidb, jpool, max_num_box=50)
    assert len(loader) == len(jloader) == 20
    for i in range(len(loader)):
        assert loader.bucket_of(i) == jloader.bucket_of(i)
        got, want = loader[i], jloader[i]
        # the port's items carry no supports: its pool gives them per class
        got['support_ims'] = pool.get(got['target_cls'])
        assert set(got) == set(want)
        for k in want:
            if k == 'im_data' or k == 'support_ims':
                np.testing.assert_allclose(got[k], want[k], rtol=0,
                                           atol=FLOAT_TOL, err_msg=k)
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _fixed_detections(coco, seed=3):
    """Detections near each gt box (some far off, some of other classes)
    with seeded scores."""
    rng = np.random.default_rng(seed)
    dets = []
    for ann in coco.dataset['annotations']:
        x, y, w, h = ann['bbox']
        for _ in range(3):
            j = rng.normal(0, 0.15, 4) * [w, h, w, h]
            dets.append({'image_id': ann['image_id'],
                         'category_id': int(rng.choice(
                             [ann['category_id'], rng.integers(1, 9)],
                             p=[0.8, 0.2])),
                         'bbox': [float(x + j[0]), float(y + j[1]),
                                  float(max(1.0, w + j[2])),
                                  float(max(1.0, h + j[3]))],
                         'score': float(rng.random())})
    return dets


def test_coco_eval_matches_jax(synth_root):
    ann = synth_root / 'annotations_test.json'
    gt, jgt = COCO(str(ann)), JCOCO(str(ann))
    dets = _fixed_detections(gt)
    got = ce.evaluate_detections(gt, gt.loadRes(json.loads(json.dumps(dets))))
    want = jce.evaluate_detections(jgt, jgt.loadRes(dets))
    assert len(got['stats']) == 12
    assert got['stats'][1] > 0.1          # the near-gt boxes score
    np.testing.assert_allclose(got['stats'], want['stats'], rtol=0,
                               atol=1e-12)
    assert got['per_class_ap'].keys() == want['per_class_ap'].keys()
    np.testing.assert_allclose(list(got['per_class_ap'].values()),
                               list(want['per_class_ap'].values()), rtol=0,
                               atol=1e-12)


def test_evaluate_detections_matches_jax(synth_root, tmp_path):
    """CocoFormatDataset.evaluate_detections: the all_boxes layout, the
    results JSON's xywh +1 conversion and COCOeval, both packages."""
    from dana_tpu.data.factory import get_imdb as jget
    from dana_tpu_torch.data.factory import get_imdb
    ds, jds = get_imdb('synth_test'), jget('synth_test')
    rng = np.random.default_rng(4)
    roidb = ds.roidb
    all_boxes = [[[] for _ in roidb] for _ in range(ds.num_classes)]
    for i, e in enumerate(roidb):
        b = e['boxes'][0]
        jit = rng.normal(0, 3, (5, 4)).astype(np.float32)
        all_boxes[int(e['gt_classes'][0])][i] = np.concatenate(
            [b + jit, rng.random((5, 1)).astype(np.float32)], 1)
    got = ds.evaluate_detections(all_boxes, str(tmp_path / 'port'))
    want = jds.evaluate_detections(all_boxes, str(tmp_path / 'jax'))
    np.testing.assert_allclose(got['stats'], want['stats'], rtol=0,
                               atol=1e-12)
    assert got['stats'][1] > 0.1
