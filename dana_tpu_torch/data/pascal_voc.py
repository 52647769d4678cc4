"""Pascal VOC: the XML annotation parser and the in-memory VOC evaluation,
ported from the JAX package's `data/pascal_voc.py` (reference
pascal_voc.py and voc_eval.py).

Layout under DATA_DIR:
    VOCdevkit<year>/VOC<year>/ImageSets/Main/<image_set>.txt
    VOCdevkit<year>/VOC<year>/Annotations/<index>.xml
    VOCdevkit<year>/VOC<year>/JPEGImages/<index>.jpg

Boxes become 0-based.  Difficult objects stay out of the training boxes
but are kept beside them (`difficult_boxes`, `difficult_classes`): the
evaluation ignores a detection that matches one.
"""

from __future__ import annotations

import os.path as osp
import xml.etree.ElementTree as ET

import numpy as np

from dana_tpu_torch.data.imdb import imdb

VOC_CLASSES = ('__background__',
               'aeroplane', 'bicycle', 'bird', 'boat', 'bottle', 'bus',
               'car', 'cat', 'chair', 'cow', 'diningtable', 'dog', 'horse',
               'motorbike', 'person', 'pottedplant', 'sheep', 'sofa',
               'train', 'tvmonitor')


class pascal_voc(imdb):
    def __init__(self, image_set, year, devkit_path=None, data_dir='data'):
        super().__init__(f'voc_{year}_{image_set}', list(VOC_CLASSES))
        self._year = year
        self._image_set = image_set
        self._devkit_path = devkit_path or osp.join(data_dir,
                                                    f'VOCdevkit{year}')
        self._data_path = osp.join(self._devkit_path, f'VOC{year}')
        self._class_to_ind = dict(zip(self._classes,
                                      range(self.num_classes)))
        split_file = osp.join(self._data_path, 'ImageSets', 'Main',
                              image_set + '.txt')
        with open(split_file) as f:
            self._image_index = [x.strip() for x in f]

    def image_path_at(self, i):
        return osp.join(self._data_path, 'JPEGImages',
                        self._image_index[i] + '.jpg')

    def gt_roidb(self):
        return [self._load_annotation(idx) for idx in self._image_index]

    def _load_annotation(self, index):
        tree = ET.parse(osp.join(self._data_path, 'Annotations',
                                 index + '.xml'))
        size = tree.find('size')
        width = int(size.find('width').text)
        height = int(size.find('height').text)
        all_objs = tree.findall('object')
        objs = [o for o in all_objs if int(o.find('difficult').text) == 0]
        diff_objs = [o for o in all_objs
                     if int(o.find('difficult').text) != 0]

        def parse(objs_):
            boxes = np.zeros((len(objs_), 4), np.float32)
            classes = np.zeros((len(objs_),), np.int32)
            for ix, obj in enumerate(objs_):
                bb = obj.find('bndbox')
                # VOC pixel indexes are 1-based
                boxes[ix] = [float(bb.find(k).text) - 1
                             for k in ('xmin', 'ymin', 'xmax', 'ymax')]
                classes[ix] = self._class_to_ind[
                    obj.find('name').text.lower().strip()]
            return boxes, classes

        boxes, gt_classes = parse(objs)
        diff_boxes, diff_classes = parse(diff_objs)
        overlaps = np.zeros((len(objs), self.num_classes), np.float32)
        overlaps[np.arange(len(objs)), gt_classes] = 1.0
        return {'width': width, 'height': height, 'boxes': boxes,
                'gt_classes': gt_classes, 'gt_overlaps': overlaps,
                'difficult_boxes': diff_boxes,
                'difficult_classes': diff_classes,
                'flipped': False,
                'seg_areas': (boxes[:, 2] - boxes[:, 0] + 1)
                * (boxes[:, 3] - boxes[:, 1] + 1)}

    def evaluate_detections(self, all_boxes, output_dir='.'):
        """Per-class VOC AP at IoU 0.5 over the gt roidb, the 11-point
        metric for VOC 2007 and the area metric else; -> {'ap': {class:
        AP}, 'map': their mean}."""
        aps = {}
        for cls_ind, cls in enumerate(self._classes):
            if cls == '__background__':
                continue
            ap = self._eval_class(all_boxes[cls_ind], cls_ind,
                                  use_07=(self._year == '2007'))
            aps[cls] = ap
            print(f'AP for {cls} = {ap:.4f}')
        mean_ap = float(np.mean(list(aps.values()))) if aps else 0.0
        print(f'Mean AP = {mean_ap:.4f}')
        return {'ap': aps, 'map': mean_ap}

    def _eval_class(self, boxes_per_img, cls_ind, iou_thr=0.5,
                    use_07=False):
        recs, dets = {}, []
        npos = 0
        for i, entry in enumerate(self.roidb):
            mask = entry['gt_classes'] == cls_ind
            easy = entry['boxes'][mask]
            dmask = entry.get('difficult_classes',
                              np.zeros(0, np.int32)) == cls_ind
            diff = entry.get('difficult_boxes',
                             np.zeros((0, 4), np.float32))[dmask]
            # difficult gt take part in the matching after the countable
            # ones, flagged to be ignored
            recs[i] = {'bbox': np.concatenate([easy, diff], 0),
                       'difficult': np.concatenate(
                           [np.zeros(len(easy), bool),
                            np.ones(len(diff), bool)]),
                       'det': np.zeros(len(easy) + len(diff), bool)}
            npos += int(mask.sum())
            d = boxes_per_img[i]
            if d is not None and len(d):
                for k in range(len(d)):
                    dets.append((i, d[k][4], d[k][:4]))
        if npos == 0 or not dets:
            return 0.0
        dets.sort(key=lambda x: -x[1])
        tp = np.zeros(len(dets))
        fp = np.zeros(len(dets))
        for di, (img, _, bb) in enumerate(dets):
            gt = recs[img]['bbox']
            if not len(gt):
                fp[di] = 1
                continue
            ixmin = np.maximum(gt[:, 0], bb[0])
            iymin = np.maximum(gt[:, 1], bb[1])
            ixmax = np.minimum(gt[:, 2], bb[2])
            iymax = np.minimum(gt[:, 3], bb[3])
            iw = np.maximum(ixmax - ixmin + 1, 0)
            ih = np.maximum(iymax - iymin + 1, 0)
            inter = iw * ih
            union = ((bb[2] - bb[0] + 1) * (bb[3] - bb[1] + 1)
                     + (gt[:, 2] - gt[:, 0] + 1)
                     * (gt[:, 3] - gt[:, 1] + 1) - inter)
            ious = inter / union
            jmax = int(np.argmax(ious))
            if not ious[jmax] > iou_thr:
                fp[di] = 1
            elif not recs[img]['difficult'][jmax]:
                if not recs[img]['det'][jmax]:
                    tp[di] = 1
                    recs[img]['det'][jmax] = True
                else:
                    fp[di] = 1
            # a match with a difficult gt is neither tp nor fp
        fp = np.cumsum(fp)
        tp = np.cumsum(tp)
        rec = tp / npos
        prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
        return voc_ap(rec, prec, use_07)


def voc_ap(rec, prec, use_07_metric=False):
    """AP from recall and precision: the VOC 2007 11-point metric, or the
    area under the monotone precision envelope (voc_eval.py:31-58)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1]))
