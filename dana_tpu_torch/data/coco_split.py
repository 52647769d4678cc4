"""COCO-format FSOD datasets, ported from the JAX package's
`data/coco_split.py`.

One parameterized class (`CocoFormatDataset`) covers the reference's COCO
split, COCO, finetune, episode and ycb2d datasets, which differ only in
annotation-file routing and image-directory layout; `coco_split` gives the
reference's annotation paths (coco60_train, coco20_evaluate, ...) and its
train2014 / val2014 image routing.  Evaluation runs the port's numpy
COCOeval (`eval/coco_eval.py`); the results JSON keeps the reference's
xywh +1 conversion.
"""

from __future__ import annotations

import json
import os
import os.path as osp

import numpy as np

from dana_tpu_torch.data.coco_json import COCO
from dana_tpu_torch.data.imdb import imdb
from dana_tpu_torch.eval import coco_eval as ce


class CocoFormatDataset(imdb):
    """Generic COCO-format detection dataset."""

    def __init__(self, name, ann_file, image_dir, image_name_fn=None):
        super().__init__(name)
        self._ann_file = ann_file
        self._image_dir = image_dir
        self._image_name_fn = image_name_fn or (lambda idx, info:
                                                info.get('file_name'))
        self._COCO = COCO(ann_file)
        cats = self._COCO.loadCats(self._COCO.getCatIds())
        self._classes = tuple(['__background__'] + [c['name'] for c in cats])
        self._class_to_ind = dict(zip(self._classes,
                                      range(self.num_classes)))
        self._class_to_coco_cat_id = dict(
            zip([c['name'] for c in cats], self._COCO.getCatIds()))
        self._image_index = self._COCO.getImgIds()
        self.config = {'use_salt': True, 'cleanup': True}

    def image_id_at(self, i):
        return self._image_index[i]

    def image_path_at(self, i):
        idx = self._image_index[i]
        info = self._COCO.loadImgs(idx)[0]
        return osp.join(self._image_dir, self._image_name_fn(idx, info))

    def gt_roidb(self):
        return [self._load_annotation(idx) for idx in self._image_index]

    def _load_annotation(self, index):
        """COCO anns -> roidb entry; crowd boxes get all-(-1) overlap rows
        (coco_split.py:165-221).

        Box coordinates are TRUNCATED to integers: the reference stores
        the sanitized boxes in a uint16 array (coco_split.py:190), so
        fractional COCO bbox coords floor.  We keep float32 storage but
        apply the same truncation."""
        im_ann = self._COCO.loadImgs(index)[0]
        width, height = im_ann['width'], im_ann['height']
        objs = self._COCO.loadAnns(self._COCO.getAnnIds(imgIds=index))
        valid = []
        for obj in objs:
            x1 = max(0, obj['bbox'][0])
            y1 = max(0, obj['bbox'][1])
            x2 = min(width - 1, x1 + max(0, obj['bbox'][2] - 1))
            y2 = min(height - 1, y1 + max(0, obj['bbox'][3] - 1))
            if obj.get('area', obj['bbox'][2] * obj['bbox'][3]) > 0 \
                    and x2 >= x1 and y2 >= y1:
                valid.append((obj, [x1, y1, x2, y2]))
        n = len(valid)
        boxes = np.zeros((n, 4), np.float32)
        gt_classes = np.zeros((n,), np.int32)
        overlaps = np.zeros((n, self.num_classes), np.float32)
        seg_areas = np.zeros((n,), np.float32)
        cat_to_ind = {self._class_to_coco_cat_id[c]: self._class_to_ind[c]
                      for c in self._classes[1:]}
        for ix, (obj, bb) in enumerate(valid):
            cls = cat_to_ind[obj['category_id']]
            boxes[ix] = np.asarray(bb, np.float64).astype(np.uint16)
            gt_classes[ix] = cls
            seg_areas[ix] = obj.get('area', 0.0)
            if obj.get('iscrowd', 0):
                overlaps[ix, :] = -1.0
            else:
                overlaps[ix, cls] = 1.0
        return {'width': width, 'height': height, 'boxes': boxes,
                'gt_classes': gt_classes, 'gt_overlaps': overlaps,
                'flipped': False, 'seg_areas': seg_areas}

    # ---------------- evaluation ----------------
    def _results_one_category(self, boxes, cat_id):
        results = []
        for im_ind, index in enumerate(self._image_index):
            dets = boxes[im_ind]
            if dets is None or len(dets) == 0:
                continue
            dets = np.asarray(dets, np.float64)
            for k in range(dets.shape[0]):
                x1, y1, x2, y2, score = dets[k, :5]
                results.append({
                    'image_id': int(index), 'category_id': int(cat_id),
                    'bbox': [float(x1), float(y1),
                             float(x2 - x1 + 1), float(y2 - y1 + 1)],
                    'score': float(score)})
        return results

    def write_coco_results_file(self, all_boxes, res_file):
        results = []
        for cls_ind, cls in enumerate(self._classes):
            if cls == '__background__':
                continue
            results.extend(self._results_one_category(
                all_boxes[cls_ind], self._class_to_coco_cat_id[cls]))
        with open(res_file, 'w') as f:
            json.dump(results, f)
        return results

    def evaluate_detections(self, all_boxes, output_dir='.'):
        os.makedirs(output_dir, exist_ok=True)
        res_file = osp.join(output_dir,
                            f'detections_{self._name}_results.json')
        self.write_coco_results_file(all_boxes, res_file)
        coco_dt = self._COCO.loadRes(res_file)
        result = ce.evaluate_detections(self._COCO, coco_dt)
        # per-class AP @[.5:.95] printout (coco_split.py:272-283)
        print('~~~~ Mean and per-category AP @ IoU=[0.50,0.95] ~~~~')
        aps = [v for v in result['per_class_ap'].values()
               if not np.isnan(v)]
        print('{:.1f}'.format(100 * float(np.mean(aps)) if aps else -1))
        for cid, ap in result['per_class_ap'].items():
            print('{:.1f}'.format(100 * ap))
        print('~~~~ Summary metrics ~~~~')
        ce.print_summary(result)
        if self.config['cleanup']:
            os.remove(res_file)
        return result


def _coco_image_name(split):
    def fn(idx, info):
        if info.get('file_name'):
            return info['file_name']
        return f'COCO_{split}_{str(idx).zfill(12)}.jpg'
    return fn


def coco_split(image_set: str, year: str, data_dir: str = 'data'):
    """The reference FSOD splits.  `image_set` in {'60','20','3way','5way',
    'vis','shot'}, `year` = set tag ('set1'..'set4', '3way1', 'shot30'...)
    (coco_split.py:68-82); `data_dir` is the config's DATA_DIR."""
    data_dir = osp.join(data_dir, 'coco')
    ann_dirs = {'60': 'coco60_train', '20': 'coco20_evaluate',
                '3way': 'coco20_3way', '5way': 'coco20_5way',
                'vis': 'coco20_vis'}
    if image_set == 'shot':
        ann = osp.join(data_dir, 'annotations', 'ft', 'instances_shot30.json')
    else:
        ann = osp.join(data_dir, 'annotations', ann_dirs[image_set],
                       f'instances_{year}.json')
    img_split = 'train2014' if image_set in ('60', 'vis', 'shot') \
        else 'val2014'
    return CocoFormatDataset(
        f'coco_{year}_{image_set}', ann,
        osp.join(data_dir, 'images', img_split),
        _coco_image_name(img_split))
