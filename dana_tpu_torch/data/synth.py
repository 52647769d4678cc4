"""Synthetic COCO-format dataset for tests and runs without image data,
ported from the JAX package's `data/synth.py`.

The same seeded scenes: a noise background and, per box, a filled
rectangle in its class's colour with a darker disc at its centre, and the
same annotation JSON.  They are drawn with numpy and written losslessly as
binary PPM (the port has no JPEG encoder, and needs no cv2), so a set
written here is read identically by this package and, through cv2, by the
JAX package.
The disc's rim is not cv2.circle's rasterisation: a pixel is inside when
its centre lies within the radius.  The default root differs from the JAX
package's (`~/.dana_synth_torch`), so that a JPEG set it wrote is never
read here by mistake; `DANA_SYNTH_ROOT` overrides both.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import zlib

import numpy as np

from dana_tpu_torch.data.blob import write_ppm
from dana_tpu_torch.data.coco_split import CocoFormatDataset

_CLASS_COLORS = {
    'red': (40, 40, 200), 'green': (40, 200, 40), 'blue': (200, 40, 40),
    'yellow': (40, 200, 200), 'magenta': (200, 40, 200),
    'cyan': (200, 200, 40), 'white': (230, 230, 230), 'gray': (120, 120, 120),
}


def _draw(im, x1, y1, bw, bh, c):
    """cv2.rectangle(filled, corners inclusive) and a filled disc of
    radius min(bw, bh) // 4 in half the colour at the box centre."""
    im[y1:y1 + bh + 1, x1:x1 + bw + 1] = c
    cx, cy, r = x1 + bw // 2, y1 + bh // 2, min(bw, bh) // 4
    ys, xs = np.ogrid[:im.shape[0], :im.shape[1]]
    disc = (xs - cx) ** 2 + (ys - cy) ** 2 <= r * r
    im[disc] = [v // 2 for v in c]


def generate_synth_dataset(root: str, split: str = 'train',
                           num_images: int = 60, seed: int = 0,
                           img_hw=(480, 640), max_boxes: int = 4):
    """Write images and annotations; idempotent per (root, split).  The
    annotation file is renamed into place last, so its presence means the
    split is complete."""
    ann_file = osp.join(root, f'annotations_{split}.json')
    img_dir = osp.join(root, f'images_{split}')
    if osp.exists(ann_file):
        return ann_file, img_dir
    os.makedirs(img_dir, exist_ok=True)
    # per-split stream (crc32 is stable across processes)
    rng = np.random.default_rng([seed, zlib.crc32(split.encode())])
    names = list(_CLASS_COLORS)
    images, annotations = [], []
    ann_id = 1
    h, w = img_hw
    for i in range(num_images):
        im = rng.integers(0, 60, (h, w, 3), dtype=np.uint8)
        n_box = int(rng.integers(1, max_boxes + 1))
        for _ in range(n_box):
            cls = int(rng.integers(0, len(names)))
            bw = int(rng.integers(80, 240))
            bh = int(rng.integers(80, 240))
            x1 = int(rng.integers(0, w - bw))
            y1 = int(rng.integers(0, h - bh))
            color = _CLASS_COLORS[names[cls]]
            jitter = rng.integers(-25, 25, 3)
            c = tuple(int(np.clip(cc + jj, 0, 255))
                      for cc, jj in zip(color, jitter))
            _draw(im, x1, y1, bw, bh, c)
            annotations.append({
                'id': ann_id, 'image_id': i + 1, 'category_id': cls + 1,
                'bbox': [float(x1), float(y1), float(bw), float(bh)],
                'area': float(bw * bh), 'iscrowd': 0})
            ann_id += 1
        fname = f'synth_{split}_{i + 1:06d}.ppm'
        write_ppm(osp.join(img_dir, fname), im)
        images.append({'id': i + 1, 'file_name': fname,
                       'width': w, 'height': h})
    categories = [{'id': k + 1, 'name': n, 'supercategory': 'synth'}
                  for k, n in enumerate(names)]
    tmp = f'{ann_file}.{os.getpid()}.tmp'
    with open(tmp, 'w') as f:
        json.dump({'images': images, 'annotations': annotations,
                   'categories': categories}, f)
    os.replace(tmp, ann_file)
    return ann_file, img_dir


def synth_fsod(split: str = 'train', root: str | None = None,
               num_images: int = 60):
    root = root or os.environ.get(
        'DANA_SYNTH_ROOT', osp.join(osp.expanduser('~'), '.dana_synth_torch'))
    ann_file, img_dir = generate_synth_dataset(root, split, num_images)
    return CocoFormatDataset(f'synth_{split}', ann_file, img_dir)
