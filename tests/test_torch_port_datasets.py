"""The port's Pascal VOC, Visual Genome and ImageNet datasets, its dataset
registry and box helpers against the JAX package's on the CPU, on
fixtures written here (no dataset is downloaded): roidbs equal, VOC and VG
evaluations within 1e-12, every registered name of the JAX package
resolvable, and the decoder choosing a file's format by its first bytes
as cv2 does.

VOC's JPEGImages/*.jpg files hold PPM bytes: cv2 (the JAX package's
decoder) picks its decoder from a file's signature, and so does the
port's `blob.imread_bgr`.
"""

import os
import os.path as osp
import sys

import numpy as np
import pytest

from dana_tpu.data import blob as jblob
from dana_tpu.data import ds_utils as jds
from dana_tpu.data import factory as jfactory
from dana_tpu.data.imagenet import imagenet as jimagenet
from dana_tpu.data.imdb import combined_roidb as jcombined
from dana_tpu.data.pascal_voc import pascal_voc as jvoc
from dana_tpu.data.pascal_voc import voc_ap as jvoc_ap
from dana_tpu.data.vg import vg as jvg

from dana_tpu_torch.data import blob, ds_utils, factory
from dana_tpu_torch.data.imagenet import imagenet
from dana_tpu_torch.data.imdb import combined_roidb
from dana_tpu_torch.data.pascal_voc import VOC_CLASSES, pascal_voc, voc_ap
from dana_tpu_torch.data.vg import vg

sys.path.insert(0, osp.dirname(__file__))
from test_vg_imagenet import _write, imagenet_root, vg_root  # noqa: E402,F401

EVAL_TOL = 1e-12


def _same_roidb(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]),
                                          err_msg=k)


def _voc_xml(w, h, objs):
    rows = ''.join(
        f'<object><name>{name}</name><difficult>{int(diff)}</difficult>'
        f'<bndbox><xmin>{b[0]}</xmin><ymin>{b[1]}</ymin><xmax>{b[2]}</xmax>'
        f'<ymax>{b[3]}</ymax></bndbox></object>'
        for name, diff, b in objs)
    return (f'<annotation><size><width>{w}</width><height>{h}</height>'
            f'<depth>3</depth></size>{rows}</annotation>')


def write_voc(root, year, n_images=6, seed=0):
    """A VOC<year> devkit under root: n_images PPM-bytes .jpg scenes with
    1-4 objects each (some difficult, names in mixed case), trainval the
    even indices and test the odd ones."""
    rng = np.random.default_rng(seed)
    data = osp.join(root, f'VOCdevkit{year}', f'VOC{year}')
    for sub in ('Annotations', 'JPEGImages', osp.join('ImageSets', 'Main')):
        os.makedirs(osp.join(data, sub), exist_ok=True)
    names = []
    for i in range(n_images):
        idx = f'{year}_{i:06d}'
        names.append(idx)
        h, w = int(rng.integers(40, 80)), int(rng.integers(40, 80))
        blob.write_ppm(osp.join(data, 'JPEGImages', idx + '.jpg'),
                       rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        objs = []
        for k in range(int(rng.integers(1, 5))):
            x1, y1 = int(rng.integers(1, w // 2)), int(rng.integers(1, h // 2))
            x2, y2 = int(rng.integers(x1, w)), int(rng.integers(y1, h))
            cls = VOC_CLASSES[1 + int(rng.integers(0, 4))]
            name = f' {cls.upper()} ' if k % 2 else cls
            objs.append((name, k == 2 or (i == 3 and k == 0),
                         (x1, y1, x2, y2)))
        _write(osp.join(data, 'Annotations', idx + '.xml'),
               _voc_xml(w, h, objs))
    main = osp.join(data, 'ImageSets', 'Main')
    for split, ids in (('trainval', names[0::2]), ('test', names[1::2]),
                       ('train', names[0::2]), ('val', names[1::2])):
        _write(osp.join(main, split + '.txt'), ''.join(f'{n}\n' for n in ids))
    return data


def _voc_detections(roidb, num_classes, seed):
    """Per class and image: jittered copies of the gt and difficult boxes
    (some twice), and random boxes, with random scores."""
    rng = np.random.default_rng(seed)
    all_boxes = [[[] for _ in roidb] for _ in range(num_classes)]
    for i, e in enumerate(roidb):
        for c in range(1, num_classes):
            boxes = np.concatenate(
                [e['boxes'][e['gt_classes'] == c],
                 e['difficult_boxes'][e['difficult_classes'] == c],
                 rng.uniform(0, 40, (2, 2)).repeat(2, 1)
                 + np.array([0, 0, 10, 12])], 0)
            if rng.random() < 0.3:
                boxes = np.concatenate([boxes, boxes[:1]], 0)
            boxes = boxes + rng.normal(0, 2, boxes.shape)
            all_boxes[c][i] = np.concatenate(
                [boxes, rng.random((len(boxes), 1))], 1).astype(np.float32)
    return all_boxes


@pytest.mark.parametrize('year', ['2007', '2012'])
def test_voc_roidb_and_evaluation_match_jax(tmp_path, year):
    write_voc(str(tmp_path), year)
    devkit = osp.join(str(tmp_path), f'VOCdevkit{year}')
    for split in ('trainval', 'test'):
        ds, jds_ = pascal_voc(split, year, devkit), jvoc(split, year, devkit)
        assert ds.name == jds_.name and ds.classes == jds_.classes
        assert ds.image_index == jds_.image_index
        _same_roidb(ds.roidb, jds_.roidb)
        assert [ds.image_path_at(i) for i in range(ds.num_images)] == \
            [jds_.image_path_at(i) for i in range(jds_.num_images)]
        assert any(len(e['difficult_boxes']) for e in ds.roidb)
        for seed in range(3):
            dets = _voc_detections(ds.roidb, ds.num_classes, seed)
            got = ds.evaluate_detections(dets)
            want = jds_.evaluate_detections(dets)
            assert got['ap'].keys() == want['ap'].keys()
            np.testing.assert_allclose(list(got['ap'].values()),
                                       list(want['ap'].values()), rtol=0,
                                       atol=EVAL_TOL)
            assert abs(got['map'] - want['map']) <= EVAL_TOL
            assert 0 < got['map'] < 1


def test_voc_through_the_factory_and_cv2(tmp_path, monkeypatch):
    """voc_2007_test through both registries (DATA_DIR) and both image
    readers: the PPM bytes in the .jpg files decode alike."""
    from dana_tpu.utils.config import cfg
    write_voc(str(tmp_path), '2007')
    monkeypatch.setattr(cfg, 'DATA_DIR', str(tmp_path))
    _, roidb, _, _ = combined_roidb('voc_2007_test', training=False,
                                    use_flipped=False, data_dir=str(tmp_path))
    _, jroidb, _, _ = jcombined('voc_2007_test', training=False,
                                use_flipped=False)
    _same_roidb(roidb, jroidb)
    for e in roidb:
        np.testing.assert_array_equal(blob.imread_bgr(e['image']),
                                      jblob.imread_bgr(e['image']))
    # training: flipped doubling and the empty-image filter
    _, train, ratios, order = combined_roidb(
        'voc_2007_trainval', training=True, use_flipped=True,
        data_dir=str(tmp_path))
    _, jtrain, jratios, jorder = jcombined('voc_2007_trainval',
                                           training=True, use_flipped=True)
    _same_roidb(train, jtrain)
    np.testing.assert_array_equal(ratios, jratios)
    np.testing.assert_array_equal(order, jorder)
    assert any(e['flipped'] for e in train)


@pytest.mark.parametrize('use_07', [True, False])
def test_voc_ap_matches_jax(use_07):
    rng = np.random.default_rng(4)
    for n in (1, 7, 60):
        rec = np.sort(rng.random(n))
        prec = rng.random(n)
        assert abs(voc_ap(rec, prec, use_07) - jvoc_ap(rec, prec, use_07)) \
            <= EVAL_TOL
    assert voc_ap(np.array([1.0]), np.array([1.0]), use_07) == \
        pytest.approx(1.0, abs=EVAL_TOL)


def _size_free_vg(vg_root, img_bytes):
    """Image 7 of the VG fixture without <size>: its size comes from the
    image file (a PPM-bytes or a real JPEG .jpg of 100 x 80)."""
    xml = osp.join(vg_root, 'genome', 'xml', '7.xml')
    with open(xml) as f:
        text = f.read()
    with open(xml, 'w') as f:
        f.write(text.replace(
            '<size><width>100</width><height>80</height></size>', ''))
    os.makedirs(osp.join(vg_root, 'vg', 'VG_100K'), exist_ok=True)
    img_bytes(osp.join(vg_root, 'vg', 'VG_100K', '7.jpg'))


def _ppm(path):
    blob.write_ppm(path, np.zeros((80, 100, 3), np.uint8))


def _jpeg(path):
    import cv2
    cv2.imwrite(path, np.full((80, 100, 3), 90, np.uint8))


@pytest.mark.parametrize('image', [None, _ppm, _jpeg],
                         ids=['size_in_xml', 'ppm_header', 'jpeg_header'])
def test_vg_matches_jax(vg_root, image):  # noqa: F811
    if image is not None:
        _size_free_vg(vg_root, image)
    kw = dict(data_path=osp.join(vg_root, 'genome'),
              img_path=osp.join(vg_root, 'vg'))
    ds, jds_ = vg('150-50-50', 'val', **kw), jvg('150-50-50', 'val', **kw)
    assert ds.classes == jds_.classes and ds.image_index == jds_.image_index
    assert ds._attributes == jds_._attributes
    assert ds._relations == jds_._relations
    _same_roidb(ds.roidb, jds_.roidb)
    assert ds.roidb[0]['width'] == 100 and ds.roidb[0]['height'] == 80
    assert ds.image_path_at(0) == jds_.image_path_at(0)
    rng = np.random.default_rng(1)
    for _ in range(3):
        dets = [[[] for _ in ds.roidb] for _ in ds.classes]
        for c in (1, 2):
            dets[c][0] = np.concatenate(
                [ds.roidb[0]['boxes'] + rng.normal(0, 4, (2, 4)),
                 rng.random((2, 1))], 1)
        got, want = ds.evaluate_detections(dets), \
            jds_.evaluate_detections(dets)
        assert got['ap'].keys() == want['ap'].keys()
        np.testing.assert_allclose(list(got['ap'].values()),
                                   list(want['ap'].values()), rtol=0,
                                   atol=EVAL_TOL)


def _mat_synsets(path, wnids, names):
    import scipy.io as sio
    rec = np.zeros((1, len(wnids)), dtype=[('ID', 'O'), ('WNID', 'O'),
                                           ('name', 'O')])
    for i, (w, n) in enumerate(zip(wnids, names)):
        rec[0, i] = (np.array([[i + 1]]), np.array([w]), np.array([n]))
    sio.savemat(path, {'synsets': rec})


@pytest.mark.parametrize('meta', ['txt', 'mat'])
def test_imagenet_matches_jax(imagenet_root, meta):  # noqa: F811
    devkit, data = imagenet_root
    if meta == 'mat':
        for kind, count in (('det', 200), ('vid', 30)):
            txt = osp.join(devkit, 'data', f'meta_{kind}.txt')
            with open(txt) as f:
                rows = [line.rstrip('\n').split('\t') for line in f][:count]
            _mat_synsets(osp.join(devkit, 'data', f'meta_{kind}.mat'),
                         [r[0] for r in rows], [r[1] for r in rows])
            os.remove(txt)
    ds, jds_ = imagenet('val', devkit, data), jimagenet('val', devkit, data)
    assert ds.classes == jds_.classes and ds.image_index == jds_.image_index
    assert ds._valid_image_flag == jds_._valid_image_flag
    assert ds._classes_image == jds_._classes_image
    _same_roidb(ds.roidb, jds_.roidb)
    assert ds.image_path_at(0) == jds_.image_path_at(0)


def test_every_jax_dataset_name_is_registered():
    assert set(factory.list_imdbs()) == set(jfactory.list_imdbs())
    # no name is refused: one of each family reaches its files
    for name in ('voc_2012_val', 'vg_150-50-50_minival', 'imagenet_test',
                 'coco_60_set1', 'ycb2d_train'):
        with pytest.raises(FileNotFoundError):
            factory.get_imdb(name, '/nonexistent-data-dir')


def _coco_fallback(root, sub, split):
    """A COCO-format annotation file at root/<sub>/annotations/<split>.json
    with two images and three boxes."""
    import json
    ann = {'images': [{'id': 1, 'file_name': 'a.jpg', 'width': 64,
                       'height': 48},
                      {'id': 2, 'file_name': 'b.jpg', 'width': 50,
                       'height': 40}],
           'annotations': [
               {'id': 1, 'image_id': 1, 'category_id': 3,
                'bbox': [1.5, 2.0, 20.0, 10.7], 'area': 200.0, 'iscrowd': 0},
               {'id': 2, 'image_id': 1, 'category_id': 7,
                'bbox': [10.0, 5.0, 30.0, 30.0], 'area': 900.0, 'iscrowd': 0},
               {'id': 3, 'image_id': 2, 'category_id': 3,
                'bbox': [0.0, 0.0, 49.0, 39.0], 'area': 1900.0,
                'iscrowd': 0}],
           'categories': [{'id': 3, 'name': 'dog'}, {'id': 7, 'name': 'cat'}]}
    _write(osp.join(root, sub, 'annotations', f'{split}.json'),
           json.dumps(ann))


def test_factory_falls_back_to_coco_format(tmp_path, monkeypatch):
    """An incomplete native layout (a bare genome/ directory, a devkit
    without ImageSets) takes the COCO-format file, in both packages."""
    from dana_tpu.utils.config import cfg
    monkeypatch.setattr(cfg, 'DATA_DIR', str(tmp_path))
    os.makedirs(tmp_path / 'genome')
    os.makedirs(tmp_path / 'imagenet' / 'ILSVRC_devkit')
    for name, sub, split in (('vg_150-50-50_val', 'vg', 'val'),
                             ('imagenet_val', 'imagenet', 'val'),
                             ('imagenet_test', 'imagenet', 'test')):
        with pytest.raises(FileNotFoundError):
            factory.get_imdb(name, str(tmp_path))
        _coco_fallback(str(tmp_path), sub, split)
        ds, jds_ = factory.get_imdb(name, str(tmp_path)), \
            jfactory.get_imdb(name)
        assert ds.name == jds_.name == f'{sub}_{split}'
        assert ds.classes == jds_.classes
        _same_roidb(ds.roidb, jds_.roidb)
        assert ds.image_path_at(1) == jds_.image_path_at(1)


def test_factory_takes_the_native_parsers(vg_root, imagenet_root,  # noqa
                                          tmp_path_factory, monkeypatch):
    """With the full native layout under DATA_DIR the registry builds the
    native datasets, in both packages."""
    import shutil
    from dana_tpu.utils.config import cfg
    data_dir = tmp_path_factory.mktemp('data_dir')
    shutil.copytree(osp.join(vg_root, 'genome'), data_dir / 'genome')
    devkit, data = imagenet_root
    shutil.copytree(devkit, data_dir / 'imagenet' / 'ILSVRC_devkit')
    shutil.copytree(data, data_dir / 'imagenet' / 'ILSVRC')
    monkeypatch.setattr(cfg, 'DATA_DIR', str(data_dir))
    for name, kind in (('vg_150-50-50_val', vg),
                       ('imagenet_val', imagenet)):
        ds = factory.get_imdb(name, str(data_dir))
        assert isinstance(ds, kind)
        _same_roidb(ds.roidb, jfactory.get_imdb(name).roidb)


def test_ds_utils_match_jax():
    rng = np.random.default_rng(2)
    xy = rng.uniform(0, 50, (40, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0, 30, (40, 2))], 1)
    boxes[5] = boxes[3]
    boxes[9] = boxes[3] + 0.2
    for scale in (1.0, 1 / 16.0):
        np.testing.assert_array_equal(ds_utils.unique_boxes(boxes, scale),
                                      jds.unique_boxes(boxes, scale))
    xywh = np.concatenate([xy, rng.uniform(1, 30, (40, 2))], 1)
    np.testing.assert_array_equal(ds_utils.xywh_to_xyxy(xywh),
                                  jds.xywh_to_xyxy(xywh))
    np.testing.assert_array_equal(ds_utils.xyxy_to_xywh(boxes),
                                  jds.xyxy_to_xywh(boxes))
    for min_size in (0, 5, 16):
        np.testing.assert_array_equal(
            ds_utils.filter_small_boxes(boxes, min_size),
            jds.filter_small_boxes(boxes, min_size))
    ds_utils.validate_boxes(boxes, 100, 100)
    for bad, w, h in ((boxes - 60, 100, 100), (boxes, 60, 100),
                      (boxes[:, [2, 1, 0, 3]], 100, 100)):
        with pytest.raises(AssertionError):
            jds.validate_boxes(bad, w, h)
        with pytest.raises(AssertionError):
            ds_utils.validate_boxes(bad, w, h)


def test_decode_by_signature(tmp_path):
    """imread_bgr tells PPM, .npy and the rest by their first bytes, as
    cv2.imread does: a PPM in a .jpg and an .npy named .png read as
    themselves, and a real JPEG goes to cv2 whatever its name."""
    import cv2
    im = np.random.default_rng(3).integers(0, 256, (31, 45, 3),
                                           dtype=np.uint8)
    blob.write_ppm(str(tmp_path / 'ppm.jpg'), im)
    np.save(str(tmp_path / 'arr.npy'), im)
    os.rename(tmp_path / 'arr.npy', tmp_path / 'arr.png')
    cv2.imwrite(str(tmp_path / 'real.jpg'), im)
    os.rename(tmp_path / 'real.jpg', tmp_path / 'real.ppm')
    for name in ('ppm.jpg', 'arr.png'):
        np.testing.assert_array_equal(blob.imread_bgr(str(tmp_path / name)),
                                      im.astype(np.float32))
    np.testing.assert_array_equal(blob.imread_bgr(str(tmp_path / 'ppm.jpg')),
                                  jblob.imread_bgr(str(tmp_path / 'ppm.jpg')))
    np.testing.assert_array_equal(
        blob.imread_bgr(str(tmp_path / 'real.ppm')),
        cv2.imread(str(tmp_path / 'real.ppm')).astype(np.float32))


def test_image_size_from_headers(tmp_path):
    """(width, height) from a PPM header and a JPEG's frame header
    (baseline, progressive, with an EXIF segment) equal PIL's."""
    import cv2
    from PIL import Image
    im = np.random.default_rng(5).integers(0, 256, (37, 53, 3),
                                           dtype=np.uint8)
    blob.write_ppm(str(tmp_path / 'a.jpg'), im)
    cv2.imwrite(str(tmp_path / 'b.jpg'), im)
    cv2.imwrite(str(tmp_path / 'c.jpg'), im,
                [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    exif = Image.Exif()
    exif[0x010f] = 'maker'
    Image.fromarray(im).save(str(tmp_path / 'd.jpg'), exif=exif)
    for name in 'abcd':
        path = str(tmp_path / f'{name}.jpg')
        with Image.open(path) as pim:
            assert blob.image_size(path) == pim.size == (53, 37)
    np.save(str(tmp_path / 'e.npy'), im)
    with pytest.raises(ValueError):
        blob.image_size(str(tmp_path / 'e.npy'))


# ------------------------------------------------- the CLIs on Pascal VOC

@pytest.fixture(scope='module')
def voc_data(tmp_path_factory):
    """chip_smoke.py's VOC2007 devkit (synth scenes as PPM-bytes .jpg
    files, classes mapped onto VOC_CLASSES) from a 4-image synth_train
    (trainval) and a 3-image synth_test (test)."""
    import cv2
    sys.path.insert(0, osp.dirname(osp.dirname(__file__)))
    import chip_smoke
    from dana_tpu_torch.data.synth import synth_fsod
    root = tmp_path_factory.mktemp('voc')
    mp = pytest.MonkeyPatch()
    mp.setenv('DANA_SYNTH_ROOT', str(root / 'synth'))
    synth_fsod('train', num_images=4)
    synth_fsod('test', num_images=3)
    assert chip_smoke.write_voc(str(root / 'data')) == [4, 3]
    ipp = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield root
    cv2.ipp.setUseIPP(ipp)
    mp.undo()


def test_training_cli_trains_on_its_default_dataset(voc_data):
    """`python -m dana_tpu_torch.train` without --dataset reads
    voc_2007_trainval, as the root train.py does, and trains its epoch."""
    from test_torch_port_train_cli import SET
    from dana_tpu_torch import train
    from dana_tpu_torch.utils.args import parse_args
    argv = ['--bs', '2', '--way', '2', '--shot', '1', '--epochs', '1',
            '--nw', '2', '--dlog', '--save_dir', str(voc_data / 'run'),
            '--seed', '3', '--device', 'cpu', '--set', *SET, 'DATA_DIR',
            str(voc_data / 'data')]
    args = parse_args(argv)
    assert (args.dataset, args.imdb_name, args.imdbval_name) == \
        ('pascal_voc', 'voc_2007_trainval', 'voc_2007_test')
    out = train.main(argv)
    epoch = out['epochs'][0]
    assert epoch['steps'] == 2 and not epoch['skipped']
    assert np.isfinite(epoch['loss_curve']).all()
    assert osp.exists(out['checkpoint'])


def test_dataset_cli_on_voc_matches_jax(voc_data, tmp_path):
    """The dataset CLI over voc_2007_test against the root inference.py on
    the same devkit and random-init weights: detections tie-aware at 2e-3
    query px, every class's VOC AP within 1e-3."""
    import inference as jax_cli
    from test_inference_cli import BASE_ARGS, _assert_detections_match
    from test_torch_port_cli import COORD_ATOL, STATS_ATOL, _on_query_grid
    from dana_tpu_torch import inference
    flags = list(BASE_ARGS)
    flags[flags.index('--dataset') + 1] = 'pascal_voc'
    flags += ['TPU.STEM_S2D', 'False', 'DATA_DIR', str(voc_data / 'data')]
    at = flags.index('--set')

    def argv(out, *extra):
        return flags[:at] + ['--bs', '2', '--eval_dir', str(out), *extra] \
            + flags[at:]
    want = jax_cli.main(argv(tmp_path / 'jax'))
    got = inference.main(argv(tmp_path / 'port', '--device', 'cpu'))
    _assert_detections_match(
        _on_query_grid(tmp_path / 'jax', tmp_path / 'jax_grid'),
        _on_query_grid(tmp_path / 'port', tmp_path / 'port_grid'),
        coord_atol=COORD_ATOL)
    assert got['ap'].keys() == want['ap'].keys()
    np.testing.assert_allclose(list(got['ap'].values()),
                               list(want['ap'].values()), atol=STATS_ATOL)
    assert got['timing']['images'] == 3
