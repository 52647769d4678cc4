"""Minimal COCO annotation API (a pycocotools.COCO stand-in), copied from
the JAX package's `data/coco_json.py`: getCatIds, getImgIds, loadImgs,
loadAnns, getAnnIds, loadCats and loadRes over the annotation JSON.
"""

from __future__ import annotations

import json
from collections import defaultdict


class COCO:
    def __init__(self, annotation_file: str | None = None, dataset=None):
        self.dataset = dataset if dataset is not None else {}
        if annotation_file is not None:
            with open(annotation_file) as f:
                self.dataset = json.load(f)
        self._index()

    def _index(self):
        self.anns, self.imgs, self.cats = {}, {}, {}
        self.img_to_anns = defaultdict(list)
        self.cat_to_imgs = defaultdict(set)
        for ann in self.dataset.get('annotations', []):
            self.anns[ann['id']] = ann
            self.img_to_anns[ann['image_id']].append(ann)
            self.cat_to_imgs[ann['category_id']].add(ann['image_id'])
        for img in self.dataset.get('images', []):
            self.imgs[img['id']] = img
        for cat in self.dataset.get('categories', []):
            self.cats[cat['id']] = cat

    # -- pycocotools-compatible surface ------------------------------------
    def getCatIds(self, catNms=None, supNms=None, catIds=None):
        cats = list(self.cats.values())
        if catNms:
            cats = [c for c in cats if c['name'] in set(catNms)]
        if supNms:
            cats = [c for c in cats if c.get('supercategory') in set(supNms)]
        if catIds:
            cats = [c for c in cats if c['id'] in set(catIds)]
        return sorted(c['id'] for c in cats)

    def getImgIds(self, imgIds=None, catIds=None):
        if not catIds:
            ids = set(self.imgs.keys())
        else:
            ids = None
            for cid in catIds:
                s = self.cat_to_imgs.get(cid, set())
                ids = set(s) if ids is None else ids & s
            ids = ids or set()
        if imgIds:
            ids &= set(imgIds)
        return sorted(ids)

    def getAnnIds(self, imgIds=None, catIds=None, iscrowd=None):
        if imgIds is not None:
            imgIds = [imgIds] if not isinstance(imgIds, (list, tuple)) else imgIds
            anns = [a for i in imgIds for a in self.img_to_anns.get(i, [])]
        else:
            anns = list(self.anns.values())
        if catIds:
            cset = set(catIds if isinstance(catIds, (list, tuple)) else [catIds])
            anns = [a for a in anns if a['category_id'] in cset]
        if iscrowd is not None:
            anns = [a for a in anns if a.get('iscrowd', 0) == iscrowd]
        return [a['id'] for a in anns]

    def loadAnns(self, ids):
        if not isinstance(ids, (list, tuple)):
            ids = [ids]
        return [self.anns[i] for i in ids]

    def loadImgs(self, ids):
        if not isinstance(ids, (list, tuple)):
            ids = [ids]
        return [self.imgs[i] for i in ids]

    def loadCats(self, ids):
        if not isinstance(ids, (list, tuple)):
            ids = [ids]
        return [self.cats[i] for i in ids]

    def loadRes(self, results):
        """Detection results (list of dicts or json path) -> result COCO."""
        if isinstance(results, str):
            with open(results) as f:
                results = json.load(f)
        res = {'images': list(self.imgs.values()),
               'categories': list(self.cats.values())}
        anns = []
        for i, det in enumerate(results):
            a = dict(det)
            a['id'] = i + 1
            x, y, w, h = a['bbox']
            a.setdefault('area', w * h)
            a.setdefault('iscrowd', 0)
            anns.append(a)
        res['annotations'] = anns
        return COCO(dataset=res)
