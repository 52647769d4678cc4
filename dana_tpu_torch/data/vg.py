"""Visual Genome: the native scene-graph XML parser and its VOC-style
evaluation, ported from the JAX package's `data/vg.py` (reference vg.py
and vg_eval.py).

Layout under DATA_DIR:
    genome/<version>/objects_vocab.txt      one class a line, comma-
    genome/<version>/attributes_vocab.txt   separated synonyms, the first
    genome/<version>/relations_vocab.txt    name canonical
    genome/<split>.txt           lines "<dir>/<img>.jpg xml/<id>.xml"
    genome/xml/<id>.xml          the scene graph of one image
    vg/<dir>/<id>.jpg            the images

Boxes are clamped to the image, a degenerate box becomes the whole frame,
an object keeps at most 16 attributes and relation triples are
deduplicated.  An XML without <size> takes the image's size from its
file's header (`blob.image_size`: PPM or JPEG), where the JAX package
opens the image with PIL.
"""

from __future__ import annotations

import os.path as osp
import xml.etree.ElementTree as ET

import numpy as np

from dana_tpu_torch.data import blob
from dana_tpu_torch.data.imdb import imdb
from dana_tpu_torch.data.pascal_voc import voc_ap

MAX_ATTRIBUTES = 16   # reference vg.py:219

# split -> (backing txt, row cap) (reference vg.py:126-154)
SPLIT_FILES = {
    'minitrain': ('train', 1000), 'smalltrain': ('train', 20000),
    'minival': ('val', 100), 'smallval': ('val', 2000),
}


def _load_vocab(path):
    """Vocab file -> (canonical names, name -> index).  Every line, blank
    ones included, takes the next index (0 is the background slot), so the
    indices stay those of a reference-trained checkpoint."""
    names, to_ind = [], {}
    with open(path) as f:
        for line in f:
            syns = [n.lower().strip() for n in line.split(',')]
            idx = len(names) + 1
            names.append(syns[0])
            for n in syns:
                to_ind[n] = idx
    return names, to_ind


class vg(imdb):
    """Scene-graph detection dataset (reference vg.py class `vg`)."""

    def __init__(self, version, image_set, data_path=None, img_path=None,
                 data_dir='data'):
        self._version = version
        self._image_set = image_set
        self._data_path = data_path or osp.join(data_dir, 'genome')
        self._img_path = img_path or osp.join(data_dir, 'vg')

        vdir = osp.join(self._data_path, version)
        obj_names, self._class_to_ind = _load_vocab(
            osp.join(vdir, 'objects_vocab.txt'))
        super().__init__(f'vg_{version}_{image_set}',
                         ['__background__'] + obj_names)
        self._attributes, self._attribute_to_ind = _load_vocab(
            osp.join(vdir, 'attributes_vocab.txt'))
        self._attributes = ['__no_attribute__'] + self._attributes
        self._relations, self._relation_to_ind = _load_vocab(
            osp.join(vdir, 'relations_vocab.txt'))
        self._relations = ['__no_relation__'] + self._relations

        self._image_index, self._id_to_dir = self._load_image_set_index()

    def _load_image_set_index(self):
        """Split txt -> (image ids, id -> image subdirectory); images whose
        XML is missing or holds no in-vocab object are skipped."""
        base, cap = SPLIT_FILES.get(self._image_set, (self._image_set, None))
        with open(osp.join(self._data_path, base + '.txt')) as f:
            rows = f.readlines()
        if cap:
            rows = rows[:cap]
        index, id_to_dir = [], {}
        for line in rows:
            parts = line.split()
            if len(parts) < 2:
                continue
            im_file, ann_file = parts[0], parts[1]
            image_id = int(osp.splitext(osp.basename(ann_file))[0])
            xml_path = self._annotation_path(image_id)
            if osp.exists(xml_path) and self._has_in_vocab_object(xml_path):
                index.append(image_id)
                id_to_dir[image_id] = im_file.split('/')[0]
        return index, id_to_dir

    def _has_in_vocab_object(self, xml_path):
        """Stream the XML and stop at the first in-vocab object."""
        for _, elem in ET.iterparse(xml_path, events=('end',)):
            if elem.tag == 'object':
                name = (elem.findtext('name') or '').lower().strip()
                if name in self._class_to_ind:
                    return True
                elem.clear()
        return False

    def _annotation_path(self, image_id):
        return osp.join(self._data_path, 'xml', f'{image_id}.xml')

    def image_path_at(self, i):
        image_id = self._image_index[i]
        return osp.join(self._img_path, self._id_to_dir[image_id],
                        f'{image_id}.jpg')

    def gt_roidb(self):
        return [self._load_vg_annotation(i) for i in self._image_index]

    def _image_size(self, image_id, tree):
        """(width, height) from the XML, else from the image's header."""
        size = tree.find('size')
        if size is not None:
            return (int(size.findtext('width')),
                    int(size.findtext('height')))
        return blob.image_size(osp.join(self._img_path,
                                        self._id_to_dir[image_id],
                                        f'{image_id}.jpg'))

    def _load_vg_annotation(self, image_id):
        tree = ET.parse(self._annotation_path(image_id))
        width, height = self._image_size(image_id, tree)

        boxes, classes, attrs = [], [], []
        obj_id_to_ix = {}
        for obj in tree.findall('object'):
            name = obj.findtext('name', '').lower().strip()
            if name not in self._class_to_ind:
                continue
            bb = obj.find('bndbox')
            x1 = max(0.0, float(bb.findtext('xmin')))
            y1 = max(0.0, float(bb.findtext('ymin')))
            x2 = min(width - 1.0, float(bb.findtext('xmax')))
            y2 = min(height - 1.0, float(bb.findtext('ymax')))
            if x2 < x1 or y2 < y1:
                # a degenerate annotation becomes the whole frame
                x1 = y1 = 0.0
                x2, y2 = width - 1.0, height - 1.0
            a = np.zeros(MAX_ATTRIBUTES, np.int32)
            n = 0
            for att in obj.findall('attribute'):
                att_name = (att.text or '').lower().strip()
                if att_name in self._attribute_to_ind:
                    a[n] = self._attribute_to_ind[att_name]
                    n += 1
                if n >= MAX_ATTRIBUTES:
                    break
            oid = obj.findtext('object_id')
            if oid is not None:
                obj_id_to_ix[oid] = len(boxes)
            boxes.append([x1, y1, x2, y2])
            classes.append(self._class_to_ind[name])
            attrs.append(a)

        n = len(boxes)
        boxes = np.asarray(boxes, np.float32).reshape(n, 4)
        gt_classes = np.asarray(classes, np.int32)
        overlaps = np.zeros((n, self.num_classes), np.float32)
        overlaps[np.arange(n), gt_classes] = 1.0

        # relation triples (subject_ix, predicate, object_ix), deduplicated;
        # those touching an out-of-vocab object dropped
        rels = set()
        for rel in tree.findall('relation'):
            pred = (rel.findtext('predicate') or '').lower().strip()
            if pred not in self._relation_to_ind:
                continue
            sub = rel.findtext('subject_id')
            obj = rel.findtext('object_id')
            if sub in obj_id_to_ix and obj in obj_id_to_ix:
                rels.add((obj_id_to_ix[sub], self._relation_to_ind[pred],
                          obj_id_to_ix[obj]))
        gt_relations = np.asarray(sorted(rels), np.int32).reshape(-1, 3)

        return {'width': width, 'height': height, 'boxes': boxes,
                'gt_classes': gt_classes,
                'gt_attributes': np.stack(attrs) if n else
                np.zeros((0, MAX_ATTRIBUTES), np.int32),
                'gt_relations': gt_relations,
                'gt_overlaps': overlaps, 'flipped': False,
                'seg_areas': (boxes[:, 2] - boxes[:, 0] + 1)
                * (boxes[:, 3] - boxes[:, 1] + 1)}

    def evaluate_detections(self, all_boxes, output_dir='.'):
        """Per-class AP at IoU 0.5 (the area metric); every foreground
        class counts toward the mean, one with no detections as 0."""
        aps = {cls: self._eval_class(all_boxes[cls_ind], cls_ind)
               for cls_ind, cls in enumerate(self._classes)
               if cls != '__background__'}
        mean_ap = float(np.mean(list(aps.values()))) if aps else 0.0
        print(f'VG mean AP = {mean_ap:.4f} over {len(aps)} classes')
        return {'ap': aps, 'map': mean_ap}

    def _eval_class(self, boxes_per_img, cls_ind, iou_thr=0.5):
        recs, dets = {}, []
        npos = 0
        for i, entry in enumerate(self.roidb):
            mask = entry['gt_classes'] == cls_ind
            recs[i] = {'bbox': entry['boxes'][mask],
                       'det': np.zeros(int(mask.sum()), bool)}
            npos += int(mask.sum())
            d = boxes_per_img[i]
            if d is not None and len(d):
                for k in range(len(d)):
                    dets.append((i, float(d[k][4]), np.asarray(d[k][:4])))
        if npos == 0 or not dets:
            return 0.0
        dets.sort(key=lambda x: -x[1])
        tp = np.zeros(len(dets))
        fp = np.zeros(len(dets))
        for di, (img, _, bb) in enumerate(dets):
            gt = recs[img]['bbox']
            matched = False
            if len(gt):
                iw = np.maximum(np.minimum(gt[:, 2], bb[2])
                                - np.maximum(gt[:, 0], bb[0]) + 1, 0)
                ih = np.maximum(np.minimum(gt[:, 3], bb[3])
                                - np.maximum(gt[:, 1], bb[1]) + 1, 0)
                inter = iw * ih
                union = ((bb[2] - bb[0] + 1) * (bb[3] - bb[1] + 1)
                         + (gt[:, 2] - gt[:, 0] + 1)
                         * (gt[:, 3] - gt[:, 1] + 1) - inter)
                ious = inter / union
                jmax = int(np.argmax(ious))
                if ious[jmax] > iou_thr and not recs[img]['det'][jmax]:
                    matched = True
                    recs[img]['det'][jmax] = True
            tp[di] = matched
            fp[di] = not matched
        fp, tp = np.cumsum(fp), np.cumsum(tp)
        rec = tp / npos
        prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
        return voc_ap(rec, prec, use_07_metric=False)
