"""The reference's legacy `Logger` (port of
dana_tpu/utils/legacy_logger.py; reference lib/model/utils/logger.py
:11-71): `scalar_summary`, `image_summary` and `histo_summary`, the
tf.Summary API the reference's CLIs never import but a user may.  Writes
through torch.utils.tensorboard when it imports and keeps every event in
memory (`events`) either way; no TensorFlow.
"""

from __future__ import annotations

import numpy as np


class Logger:
    """Drop-in for the reference Logger (same three methods)."""

    def __init__(self, log_dir):
        self.events = []          # (step, kind, tag, payload) fallback
        try:
            from torch.utils.tensorboard import SummaryWriter
            self.writer = SummaryWriter(log_dir)
        except Exception:
            self.writer = None

    def scalar_summary(self, tag, value, step):
        """Log a scalar variable (logger.py:17-20)."""
        self.events.append((step, 'scalar', tag, float(value)))
        if self.writer is not None:
            self.writer.add_scalar(tag, float(value), step)
            self.writer.flush()

    def image_summary(self, tag, images, step):
        """Log a list of HWC (or HW) images (logger.py:22-43); tags are
        '<tag>/<i>' like the reference."""
        for i, img in enumerate(images):
            img = np.asarray(img)
            if img.dtype != np.uint8:
                lo, hi = float(img.min()), float(img.max())
                img = ((img - lo) / (hi - lo or 1.0) * 255).astype(
                    np.uint8)
            self.events.append((step, 'image', f'{tag}/{i}', img.shape))
            if self.writer is not None:
                fmt = 'HWC' if img.ndim == 3 else 'HW'
                self.writer.add_image(f'{tag}/{i}', img, step,
                                      dataformats=fmt)
        if self.writer is not None:
            self.writer.flush()

    def histo_summary(self, tag, values, step, bins=1000):
        """Log a histogram of values (logger.py:45-71)."""
        values = np.asarray(values)
        counts, bin_edges = np.histogram(values, bins=bins)
        self.events.append((step, 'histogram', tag,
                            (counts, bin_edges)))
        if self.writer is not None:
            self.writer.add_histogram(tag, values, step, bins=bins)
            self.writer.flush()
