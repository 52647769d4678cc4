"""Pure-numpy COCO detection evaluation (a pycocotools.COCOeval stand-in),
copied from the JAX package's `eval/coco_eval.py`, which is numpy only.

The standard COCOeval bbox protocol: greedy per-category matching at IoU
thresholds 0.5:0.95:0.05, crowd / ignore handling, area ranges, maxDets,
101-point interpolated precision, and the 12-number summarize() table plus
the per-class AP the reference's COCO split prints.
"""

from __future__ import annotations

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    'all': (0.0, 1e10),
    'small': (0.0, 32.0 ** 2),
    'medium': (32.0 ** 2, 96.0 ** 2),
    'large': (96.0 ** 2, 1e10),
}


def box_iou_xywh(dets: np.ndarray, gts: np.ndarray, iscrowd) -> np.ndarray:
    """IoU of [D,4] x [G,4] xywh boxes; for crowd gt, IoU = intersection /
    det area (pycocotools maskUtils.iou semantics)."""
    d_area = dets[:, 2] * dets[:, 3]
    g_area = gts[:, 2] * gts[:, 3]
    lt = np.maximum(dets[:, None, :2], gts[None, :, :2])
    rb = np.minimum(dets[:, None, :2] + dets[:, None, 2:4],
                    gts[None, :, :2] + gts[None, :, 2:4])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = d_area[:, None] + g_area[None, :] - inter
    crowd = np.asarray(iscrowd, bool)
    union = np.where(crowd[None, :], d_area[:, None], union)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _prep_img(dets, gts, max_dets):
    """Parse one (image, category)'s annotation dicts into arrays and
    compute the IoU matrix ONCE, shared across the 4 area ranges
    (pycocotools computes IoU per (img, cat) in evaluate(), never per
    area)."""
    g_boxes = np.array([g['bbox'] for g in gts], np.float64).reshape(-1, 4)
    g_crowd = np.array([g.get('iscrowd', 0) for g in gts], bool)
    g_area = np.array([g.get('area', b[2] * b[3])
                       for g, b in zip(gts, g_boxes)], np.float64)
    g_ignore_base = np.array([g.get('ignore', 0) for g in gts], bool) \
        | g_crowd

    d_scores = np.array([d['score'] for d in dets], np.float64)
    d_order = np.argsort(-d_scores, kind='stable')[:max_dets]
    d_boxes = np.array([dets[i]['bbox'] for i in d_order],
                       np.float64).reshape(-1, 4)
    d_scores = d_scores[d_order]
    nd, ng = len(d_boxes), len(g_boxes)
    ious = box_iou_xywh(d_boxes, g_boxes, g_crowd) if nd and ng else \
        np.zeros((nd, ng))
    return {
        'g_boxes': g_boxes, 'g_crowd': g_crowd, 'g_area': g_area,
        'g_ignore_base': g_ignore_base, 'd_boxes': d_boxes,
        'd_scores': d_scores, 'd_area': d_boxes[:, 2] * d_boxes[:, 3],
        'ious': ious,
        # matching depends on the ious + the g_ignore pattern ONLY (the
        # pattern fixes the stable sort order and the non-ignored-first
        # preference), so identical patterns across area ranges — common
        # when e.g. every gt is 'large' — reuse the greedy match verbatim
        'memo': {},
    }


def _greedy_match(ious, g_crowd, g_ignore):
    """Greedy T-threshold matching on gts already sorted non-ignored
    first.  Returns dt_m [T, D] (matched sorted-gt index or -1).

    Vectorized over the T thresholds (the det loop is inherently
    sequential).  Semantics of pycocotools evaluateImg:
      * a det first takes the best available non-ignored gt, else the
        best available ignored one (the `break` in the reference loop).
      * "available" = unmatched, or crowd (crowd absorbs many dets).
      * ties on IoU pick the LAST gt in sort order (the loop updates on
        iou >= current best).
    """
    t = len(IOU_THRS)
    nd, ng = ious.shape
    dt_m = np.zeros((t, nd), np.int64) - 1       # matched gt index or -1
    thr_eff = np.minimum(IOU_THRS, 1 - 1e-10)[:, None]       # [T,1]
    gt_taken = np.zeros((t, ng), bool)
    t_idx = np.arange(t)
    avail_base = g_crowd[None, :]                # crowd absorbs many dets
    # non-ignored gts outrank every ignored one regardless of IoU (the
    # two-stage prefix preference): a +2 bonus (IoU <= 1) encodes that in
    # ONE last-argmax instead of two per det; within each group the
    # reversed argmax keeps the exact last-max-tie semantics
    bonus_iou = ious + np.where(g_ignore, 0.0, 2.0)[None, :]

    # dets whose best IoU is below the lowest threshold can never take
    # any gt at any threshold: skipping them is exact and removes the
    # bulk of the sequential loop (most of the 100 dets are background)
    active = np.flatnonzero(ious.max(axis=1) >= float(thr_eff.min())) \
        if ng else np.arange(0)
    for di in active:
        ok = (avail_base | ~gt_taken) \
            & (ious[di][None, :] >= thr_eff)                  # [T,G]
        vals = np.where(ok, bonus_iou[di][None, :], -1.0)
        best = ng - 1 - np.argmax(vals[:, ::-1], axis=1)
        sel = vals[t_idx, best] > -1.0
        dt_m[sel, di] = best[sel]
        gt_taken[t_idx[sel], best[sel]] = True
    return dt_m


def _evaluate_img_prepped(p, area_rng):
    """Match one prepped (image, category) for one area range: returns
    (dt_matches [T,D], dt_ignore [T,D], gt_ignore [G], dt_scores [D])
    following COCOeval.evaluateImg."""
    t = len(IOU_THRS)
    nd = len(p['d_boxes'])
    ng = len(p['g_boxes'])
    g_ignore = (p['g_ignore_base']
                | (p['g_area'] < area_rng[0])
                | (p['g_area'] > area_rng[1]))
    # gts sorted: non-ignored first (stable)
    g_order = np.argsort(g_ignore, kind='stable')
    g_ignore_s = g_ignore[g_order]

    key = g_ignore.tobytes()
    dt_m = p['memo'].get(key)
    if dt_m is None:
        dt_m = _greedy_match(p['ious'][:, g_order],
                             p['g_crowd'][g_order], g_ignore_s)
        p['memo'][key] = dt_m

    d_out_of_range = (p['d_area'] < area_rng[0]) \
        | (p['d_area'] > area_rng[1])
    matched = dt_m >= 0                                       # [T,D]
    if ng:
        matched_ignored = matched & g_ignore_s[np.maximum(dt_m, 0)]
    else:
        matched_ignored = np.zeros((t, nd), bool)
    dt_ig = matched_ignored | (~matched & d_out_of_range[None, :])
    return matched, dt_ig, g_ignore_s, p['d_scores']


def _evaluate_img(dets, gts, area_rng, max_dets):
    """Match one (image, category): single-call convenience wrapper
    (tests exercise this; evaluate_detections preps once and reuses)."""
    return _evaluate_img_prepped(_prep_img(dets, gts, max_dets), area_rng)


class COCOEvalResult(dict):
    pass


def evaluate_detections(coco_gt, coco_dt, img_ids=None, cat_ids=None,
                        max_dets=(1, 10, 100)):
    """Full bbox evaluation.  Returns a dict with 'precision'
    [T, R, K, A, M], 'recall' [T, K, A, M], 'stats' (the 12 summary
    numbers), and 'per_class_ap' {cat_id: AP@[.5:.95]}."""
    img_ids = sorted(img_ids) if img_ids else coco_gt.getImgIds()
    cat_ids = sorted(cat_ids) if cat_ids else coco_gt.getCatIds()
    areas = list(AREA_RNG.values())
    t, r = len(IOU_THRS), len(REC_THRS)
    k, a, m = len(cat_ids), len(areas), len(max_dets)
    md = max(max_dets)

    # gather per (cat, area, img) match results at maxDet=md, then slice
    precision = -np.ones((t, r, k, a, m))
    recall = -np.ones((t, k, a, m))
    for ki, cid in enumerate(cat_ids):
        per_img_dets = [coco_dt.loadAnns(coco_dt.getAnnIds(imgIds=i,
                                                           catIds=[cid]))
                        for i in img_ids]
        per_img_gts = [coco_gt.loadAnns(coco_gt.getAnnIds(imgIds=i,
                                                          catIds=[cid]))
                       for i in img_ids]
        prepped = [_prep_img(d, g, md)
                   for d, g in zip(per_img_dets, per_img_gts)
                   if len(d) or len(g)]
        for ai, rng in enumerate(areas):
            results = [_evaluate_img_prepped(p, rng) for p in prepped]
            if not results:
                continue
            for mi, mdet in enumerate(max_dets):
                dtm = np.concatenate(
                    [x[0][:, :mdet] for x in results], axis=1)
                dtig = np.concatenate(
                    [x[1][:, :mdet] for x in results], axis=1)
                scores = np.concatenate([x[3][:mdet] for x in results])
                n_gt = int(sum((~x[2]).sum() for x in results))
                if n_gt == 0:
                    continue
                order = np.argsort(-scores, kind='mergesort')
                dtm, dtig = dtm[:, order], dtig[:, order]
                tps = dtm & ~dtig
                fps = ~dtm & ~dtig
                tp_cum = np.cumsum(tps, axis=1).astype(np.float64)
                fp_cum = np.cumsum(fps, axis=1).astype(np.float64)
                for ti in range(t):
                    tp, fp = tp_cum[ti], fp_cum[ti]
                    rc = tp / n_gt
                    pr = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
                    recall[ti, ki, ai, mi] = rc[-1] if len(rc) else 0.0
                    # precision envelope (monotone non-increasing):
                    # right-to-left running max, vectorized
                    if len(pr):
                        pr = np.maximum.accumulate(pr[::-1])[::-1]
                    inds = np.searchsorted(rc, REC_THRS, side='left')
                    q = np.zeros(r)
                    ok = inds < len(pr)
                    q[ok] = pr[inds[ok]]
                    precision[ti, :, ki, ai, mi] = q

    def _summ(ap=True, iou=None, area='all', mdet=100):
        ai = list(AREA_RNG.keys()).index(area)
        mi = max_dets.index(mdet)
        if ap:
            s = precision[:, :, :, ai, mi]
            if iou is not None:
                s = s[np.isclose(IOU_THRS, iou)]
        else:
            s = recall[:, :, ai, mi]
            if iou is not None:
                s = s[np.isclose(IOU_THRS, iou)]
        s = s[s > -1]
        return float(np.mean(s)) if s.size else -1.0

    stats = [
        _summ(True), _summ(True, 0.5), _summ(True, 0.75),
        _summ(True, area='small'), _summ(True, area='medium'),
        _summ(True, area='large'),
        _summ(False, mdet=max_dets[0]), _summ(False, mdet=max_dets[1]),
        _summ(False, mdet=max_dets[2]),
        _summ(False, area='small'), _summ(False, area='medium'),
        _summ(False, area='large'),
    ]
    per_class = {}
    ai = 0
    mi = max_dets.index(100) if 100 in max_dets else m - 1
    for ki, cid in enumerate(cat_ids):
        s = precision[:, :, ki, ai, mi]
        s = s[s > -1]
        per_class[cid] = float(np.mean(s)) if s.size else float('nan')
    return COCOEvalResult(precision=precision, recall=recall, stats=stats,
                          per_class_ap=per_class, iou_thrs=IOU_THRS)


def print_summary(result):
    names = [
        ('AP', '0.50:0.95', 'all', 100), ('AP', '0.50', 'all', 100),
        ('AP', '0.75', 'all', 100), ('AP', '0.50:0.95', 'small', 100),
        ('AP', '0.50:0.95', 'medium', 100), ('AP', '0.50:0.95', 'large', 100),
        ('AR', '0.50:0.95', 'all', 1), ('AR', '0.50:0.95', 'all', 10),
        ('AR', '0.50:0.95', 'all', 100), ('AR', '0.50:0.95', 'small', 100),
        ('AR', '0.50:0.95', 'medium', 100), ('AR', '0.50:0.95', 'large', 100),
    ]
    for (kind, iou, area, mdet), v in zip(names, result['stats']):
        word = 'Precision' if kind == 'AP' else 'Recall   '
        print(f' Average {word} ({kind}) @[ IoU={iou:9s} | '
              f'area={area:6s} | maxDets={mdet:3d} ] = {v:0.3f}')
