"""ImageNet DET / VID: the native devkit parser, ported from the JAX
package's `data/imagenet.py` (reference imagenet.py:26-214).

Layout:
    <devkit>/data/meta_det.mat, meta_vid.mat  (read with scipy.io; or
        meta_{det,vid}.txt with "wnid<TAB>name" lines)
    <data>/ImageSets/{trainr,val}.txt
    <data>/Data/<set>/<index>.JPEG
    <data>/Annotations/<set>/<index>.xml

The classes are the 30 VID synsets and the background; the 200 DET
synsets are kept with a flag marking those that are also VID classes.
"""

from __future__ import annotations

import os.path as osp
import xml.etree.ElementTree as ET

import numpy as np

from dana_tpu_torch.data.imdb import imdb


def _load_synsets(devkit_path, kind, count):
    """(wnids, names) of the first `count` 'det' or 'vid' synsets, from
    the devkit's .mat, else from meta_<kind>.txt."""
    mat_path = osp.join(devkit_path, 'data', f'meta_{kind}.mat')
    if osp.exists(mat_path):
        import scipy.io as sio
        synsets = sio.loadmat(mat_path)['synsets'][0]
        return ([str(synsets[i][1][0]) for i in range(count)],
                [str(synsets[i][2][0]) for i in range(count)])
    wnids, names = [], []
    with open(osp.join(devkit_path, 'data', f'meta_{kind}.txt')) as f:
        for line in f:
            parts = line.rstrip('\n').split('\t')
            if len(parts) >= 2:
                wnids.append(parts[0].strip())
                names.append(parts[1].strip())
            if len(wnids) >= count:
                break
    return wnids, names


class imagenet(imdb):
    """ImageNet detection dataset (reference imagenet.py class
    `imagenet`)."""

    def __init__(self, image_set, devkit_path, data_path):
        self._image_set = image_set
        self._devkit_path = devkit_path
        self._data_path = data_path

        det_wnids, det_names = _load_synsets(devkit_path, 'det', 200)
        vid_wnids, vid_names = _load_synsets(devkit_path, 'vid', 30)

        self._classes_image = ('__background__',) + tuple(det_names)
        self._wnid_image = (0,) + tuple(det_wnids)
        self._wnid = (0,) + tuple(vid_wnids)
        super().__init__(f'imagenet_{image_set}',
                         ['__background__'] + vid_names)

        self._wnid_to_ind_image = {w: i for i, w
                                   in enumerate(self._wnid_image)}
        self._class_to_ind_image = {c: i for i, c
                                    in enumerate(self._classes_image)}
        self._wnid_to_ind = {w: i for i, w in enumerate(self._wnid)}
        self._class_to_ind = {c: i for i, c in enumerate(self._classes)}
        # DET image classes whose synset is also a VID class
        self._valid_image_flag = [0] + [
            1 if self._wnid_image[i] in self._wnid_to_ind else 0
            for i in range(1, len(self._wnid_image))]

        self._image_ext = '.JPEG'
        self._image_index = self._load_image_set_index()

    def _load_image_set_index(self):
        """train reads ImageSets/trainr.txt (which must exist: the
        reference samples it as a preparation step), else val.txt."""
        name = 'trainr' if self._image_set == 'train' else 'val'
        with open(osp.join(self._data_path, 'ImageSets', f'{name}.txt')) as f:
            return [x.strip() for x in f if x.strip()]

    def image_path_at(self, i):
        return osp.join(self._data_path, 'Data', self._image_set,
                        self._image_index[i] + self._image_ext)

    def gt_roidb(self):
        return [self._load_imagenet_annotation(idx)
                for idx in self._image_index]

    def _load_imagenet_annotation(self, index):
        """XML -> roidb entry; wnids map through the VID synsets and
        objects of other wnids are skipped."""
        path = osp.join(self._data_path, 'Annotations', self._image_set,
                        index + '.xml')
        tree = ET.parse(path)
        size = tree.find('size')
        if size is None:
            raise ValueError(f'annotation {path} has no <size> element')
        width = int(size.findtext('width'))
        height = int(size.findtext('height'))

        boxes, classes = [], []
        for obj in tree.findall('object'):
            wnid = (obj.findtext('name') or '').lower().strip()
            if wnid not in self._wnid_to_ind:
                continue
            bb = obj.find('bndbox')
            boxes.append([float(bb.findtext(k))
                          for k in ('xmin', 'ymin', 'xmax', 'ymax')])
            classes.append(self._wnid_to_ind[wnid])

        n = len(boxes)
        boxes = np.asarray(boxes, np.float32).reshape(n, 4)
        gt_classes = np.asarray(classes, np.int32)
        overlaps = np.zeros((n, self.num_classes), np.float32)
        overlaps[np.arange(n), gt_classes] = 1.0
        return {'width': width, 'height': height, 'boxes': boxes,
                'gt_classes': gt_classes, 'gt_overlaps': overlaps,
                'flipped': False,
                'seg_areas': (boxes[:, 2] - boxes[:, 0] + 1)
                * (boxes[:, 3] - boxes[:, 1] + 1)}
