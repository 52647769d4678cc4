"""The loggers, ported from the JAX package's `utils/fsod_logger.py`
(reference fsod_logger.py:8-131).

`FSODLogger.write` records the epoch's mean loss scalars and, with
`save_im`, the first episode's query (its gt boxes drawn, and predicted
boxes in red when given) and supports as images; the training CLI uses it.
`FSODInferenceLogger` records eval images, and with `write_attention` the
RPN site's attention relevance (models/viz.py) over a query.  Both write
through `torch.utils.tensorboard` when that imports and keep the records in
memory as well (`scalars`, `images`), so nothing depends on TensorBoard
being there.
"""

from __future__ import annotations

import numpy as np

from dana_tpu_torch.data.blob import s2d_unpack
from dana_tpu_torch.utils.config import PIXEL_MEANS


def _to_uint8(im_bgr_meansub, pixel_means):
    """A mean-subtracted BGR canvas (or its space-to-depth packing) ->
    RGB uint8."""
    im = np.asarray(im_bgr_meansub, np.float32)
    if im.shape[-1] == 12:
        im = s2d_unpack(im)
    im = im \
        + np.asarray(pixel_means, np.float32).ravel()[:3]
    return np.clip(im[..., ::-1], 0, 255).astype(np.uint8)  # BGR -> RGB


def draw_boxes(im_rgb, boxes, color=(0, 255, 0), width=2):
    """A copy of an HWC uint8 image with the [N, >=4] boxes drawn."""
    im = im_rgb.copy()
    h, w = im.shape[:2]
    for b in np.asarray(boxes):
        x1, y1, x2, y2 = [int(round(v)) for v in b[:4]]
        if x2 <= x1 or y2 <= y1:
            continue
        x1, x2 = np.clip([x1, x2], 0, w - 1)
        y1, y2 = np.clip([y1, y2], 0, h - 1)
        for dx in range(width):
            im[np.clip(y1 + dx, 0, h - 1), x1:x2 + 1] = color
            im[np.clip(y2 - dx, 0, h - 1), x1:x2 + 1] = color
            im[y1:y2 + 1, np.clip(x1 + dx, 0, w - 1)] = color
            im[y1:y2 + 1, np.clip(x2 - dx, 0, w - 1)] = color
    return im


class FSODLogger:
    def __init__(self, log_dir, pixel_means=PIXEL_MEANS):
        self.pixel_means = pixel_means
        self.scalars = []            # (step, tag, value)
        self.images = []             # (step, tag, HWC uint8 RGB)
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._tb = None
        else:
            self._tb = SummaryWriter(log_dir)

    def write(self, step, losses: dict, batch=None, save_im=False,
              predictions=None):
        """losses: {name: scalar}; batch: numpy im_data and, when present,
        gt_boxes and support_ims of a batch, for the images with
        `save_im`; predictions [N, >=4] boxes of the first query, drawn in
        red."""
        records = [('scalar', k, float(v)) for k, v in losses.items()]
        if save_im and batch is not None:
            im = _to_uint8(batch['im_data'][0], self.pixel_means)
            gt = batch.get('gt_boxes')
            records.append(('image', 'query', draw_boxes(
                im, np.zeros((0, 4)) if gt is None else gt[0])))
            sups = batch.get('support_ims')
            records += [('image', f'support/{i}',
                         _to_uint8(s, self.pixel_means))
                        for i, s in enumerate(
                            [] if sups is None else sups[0])]
            if predictions is not None:
                records.append(('image', 'predictions', draw_boxes(
                    im, predictions, color=(255, 0, 0))))
        for kind, tag, value in records:
            (self.scalars if kind == 'scalar' else self.images).append(
                (step, tag, value))
            if self._tb is None:
                continue
            if kind == 'scalar':
                self._tb.add_scalar(tag, value, step)
            else:
                self._tb.add_image(tag, value, step, dataformats='HWC')
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()


class FSODInferenceLogger(FSODLogger):
    """The eval logger: query images with their predicted boxes, and the
    RPN site's attention relevance over a query."""

    def write(self, step, batch=None, predictions=None, save_im=True):
        super().write(step, {}, batch=batch, save_im=save_im,
                      predictions=predictions)

    def write_attention(self, step, model, config, batch, tag='attention'):
        """The relevance of batch['support_ims'][0] [n, sh, sw, 3] over
        batch['im_data'][0] [H, W, 3] (mean-subtracted; models/viz.py),
        overlaid on the query -> the RGB uint8 image it records."""
        from dana_tpu_torch.models.viz import (overlay_heatmap,
                                               rpn_attention_relevance)
        q = np.asarray(batch['im_data'][0])
        heat = rpn_attention_relevance(model, config, q,
                                       np.asarray(batch['support_ims'][0]))
        im = overlay_heatmap(_to_uint8(q, self.pixel_means), heat)
        self.images.append((step, tag, im))
        if self._tb is not None:
            self._tb.add_image(tag, im, step, dataformats='HWC')
            self._tb.flush()
        return im
