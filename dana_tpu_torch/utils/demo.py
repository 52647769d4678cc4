"""The demo helpers of the repo's root `utils.py` (lines 268-375; reference
utils.py:130-317) on the port: one (support, query) pair through the
detector, multi-shot pseudo-labels, and a COCO annotation writer.

`c` is the config tree (utils/config.py `default_cfg()` when None): its
PIXEL_MEANS, TRAIN.SCALES / MAX_SIZE, TPU.EXACT_QUERY_SCALE, TEST.NMS and
TRAIN.BBOX_NORMALIZE_* are the JAX package's global cfg's.  Images are read
with the port's reader (data/blob.py `imread_bgr`: PPM and `.npy` in numpy,
other formats through cv2 when it imports), not PIL.  `run_detection` and
`generate_pseudo_label` run on the card unless `device='cpu'` is passed.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from dana_tpu_torch import native
from dana_tpu_torch.data import blob
from dana_tpu_torch.utils import config as config_lib


def _tree(c):
    return config_lib.default_cfg() if c is None else c


def NMS(boxes, scores, c=None):
    """Class-agnostic greedy NMS at TEST.NMS (+1 IoU, stable descending
    sort) on the host, through the native library (dana_tpu_torch/native
    `nms`, as the root utils.py's goes through the JAX package's) -> the
    kept indices, score-descending (int64 numpy)."""
    return native.nms(boxes, scores, _tree(c).TEST.NMS)


def support_im_preprocess(im, c=None, support_size=320, n_of_shot=1):
    """A whole BGR image -> its mean-subtracted 320 px support canvas,
    repeated `n_of_shot` times [n, 320, 320, 3]."""
    sup = blob.support_blob_whole(im, _tree(c).PIXEL_MEANS, support_size)
    return np.tile(sup[None], (n_of_shot, 1, 1, 1))


def query_im_preprocess(im, c=None):
    """A BGR image -> (query canvas [H, W, 3], im_info (h, w, scale)) at
    TRAIN.SCALES[0] (capped by TRAIN.MAX_SIZE unless
    TPU.EXACT_QUERY_SCALE)."""
    c = _tree(c)
    max_size = None if c.TPU.EXACT_QUERY_SCALE else c.TRAIN.MAX_SIZE
    return blob.query_blob(im, c.PIXEL_MEANS, c.TRAIN.SCALES[0], max_size)


def run_detection(support_im, query_im, config, params, thresh=0.5, c=None,
                  device='cuda'):
    """One (support, query) pair of BGR images through the detector
    `config` (params: a JAX-layout tree or the built module) and the
    detection postprocess -> its detections [N, 5] (x1, y1, x2, y2, score)
    in query pixels with score >= thresh."""
    from dana_tpu_torch.engine.postprocess import postprocess_batch
    from dana_tpu_torch.models import frameworks
    from dana_tpu_torch.utils.device import resolve_device
    from dana_tpu_torch.utils.weights import from_jax_params
    c = _tree(c)
    dev = resolve_device(device)
    model = params if isinstance(params, torch.nn.Module) \
        else from_jax_params(params, config)
    model = model.to(dev)
    sup = support_im_preprocess(support_im, c, n_of_shot=config.n_shot)[None]
    q, info = query_im_preprocess(query_im, c)
    info = torch.as_tensor(info[None], device=dev)
    with torch.inference_mode():
        out = frameworks.forward(
            model, config, torch.as_tensor(q[None], device=dev), info,
            support_ims=torch.as_tensor(sup, device=dev))
        dets, valid = postprocess_batch(
            out['rois'], out['cls_prob'].float(), out['bbox_pred'].float(),
            info, bbox_stds=tuple(c.TRAIN.BBOX_NORMALIZE_STDS),
            bbox_means=tuple(c.TRAIN.BBOX_NORMALIZE_MEANS),
            **config_lib.postprocess_kwargs(c))
    dets = dets[0][valid[0]].cpu().numpy()
    return dets[dets[:, 4] >= thresh]


def generate_pseudo_label(output_dir, sp_dir, q_im_path, config, params,
                          num_shot, c=None, device='cuda'):
    """The union of the detections of each shot <sp_dir>/shot_<i>.jpg
    (i = 1..num_shot) on the query image, NMS'd when there are several
    shots -> [N, 5].  Creates `output_dir`."""
    os.makedirs(output_dir, exist_ok=True)
    q_im = blob.imread_bgr(q_im_path).astype(np.float32)
    dets = []
    for i in range(num_shot):
        sp = blob.imread_bgr(os.path.join(sp_dir, f'shot_{i + 1}.jpg'))
        dets.append(run_detection(sp.astype(np.float32), q_im, config,
                                  params, c=c, device=device))
    dets = np.concatenate(dets, axis=0)
    if num_shot > 1 and len(dets):
        dets = dets[np.argsort(-dets[:, 4])]
        dets = dets[NMS(dets[:, :4], dets[:, 4], c)]
    return dets


def create_annotation(nd_dir, cls_names, cls_im_inds, dump_path,
                      class_ids=None, im_hw=(256, 256)):
    """A COCO-format annotation file from per-image `.npy` box dumps
    <nd_dir>/<index:06d>.npy ([N, >=4] boxes); class ids from `class_ids`
    (default 1.. in `cls_names` order)."""
    class_ids = class_ids or {n: i + 1 for i, n in enumerate(cls_names)}
    categories = [{'supercategory': 'None', 'id': class_ids[n], 'name': n}
                  for n in cls_names]
    images, annotations = [], []
    for cls, inds in zip(cls_names, cls_im_inds):
        for ind in inds:
            images.append({'license': 1,
                           'file_name': str(ind).zfill(6) + '.jpg',
                           'height': im_hw[0], 'width': im_hw[1],
                           'id': int(ind)})
            boxes = np.load(os.path.join(nd_dir, str(ind).zfill(6) + '.npy'),
                            allow_pickle=True)
            for j, box in enumerate(np.asarray(boxes)):
                annotations.append({
                    'segmentation': [], 'area': float(
                        (box[2] - box[0]) * (box[3] - box[1])),
                    'iscrowd': 0, 'image_id': int(ind),
                    'bbox': [int(box[0]), int(box[1]),
                             int(box[2]) - int(box[0]),
                             int(box[3]) - int(box[1])],
                    'category_id': class_ids[cls],
                    'id': int(str(ind) + str(j))})
    with open(dump_path, 'w') as f:
        json.dump({'info': {}, 'licenses': [], 'images': images,
                   'annotations': annotations,
                   'categories': categories}, f)
