"""Reads what the program's timed path produces at each stage, for the
comparison with the reference, without changing what it computes.

The recorder wraps a few module-level functions of the program while it
is installed (`with Recorder(...)`): each wrapper calls the original and,
only while a slot is armed, copies the stage's tensors into that slot's
host buffers (pinned on the card, copied without blocking, so the
program's device memory is freed as usual and the request pays one
device-to-host copy of its stages).  A probe run first learns the
stages' shapes, so that the buffers are allocated during set-up.

Stages (NHWC maps, as the program holds them):
  feat       the queries' base features (models/dana.py query_features)
  attn       DAnA: the RPN site's attended supports (the second half of
             rpn_attention's concat); FSOD: the correlation map
  support    FSOD: the shot-mean support kernels
  probs, deltas, rois, mask   the proposal layer's inputs and outputs
  pooled     the first `keep_rois` rois' pooled features of each image
  cls_prob, bbox_pred         the R-CNN head's outputs, as the postprocess
                              takes them
  mining     training: the hard-mined loss's inputs (the positive and the
             negative branch's score margins and the labels)
"""

from __future__ import annotations

import torch


class Recorder:
    def __init__(self, device, keep_rois=16, stages=None):
        self.device = torch.device(device)
        self.keep_rois = keep_rois
        self.stages = stages          # None: every stage
        self.slot = None              # the armed slot, or 'probe'
        self.shapes = {}
        self.buffers = []
        self._saved = []

    # -- installation
    def __enter__(self):
        from dana_tpu_torch.engine import predict
        from dana_tpu_torch.models import dana, frameworks
        from dana_tpu_torch.models import rpn

        def outputs(fn, take):
            def wrapper(*args, **kwargs):
                out = fn(*args, **kwargs)
                if self.slot is not None:
                    for k, v in take(args, kwargs, out).items():
                        self._put(k, v)
                return out
            return wrapper

        keep = self.keep_rois
        targets = [
            (dana, 'query_features', lambda a, k, o: {'feat': o}),
            (dana, 'rpn_attention',
             lambda a, k, o: {'attn': o[..., a[2].shape[-1]:]}),
            (frameworks, 'fsod_correlation',
             lambda a, k, o: {'attn': o, 'support': a[1]}),
            (rpn, 'proposal_layer',
             lambda a, k, o: {'probs': a[0], 'deltas': a[1], 'rois': o[0],
                              'mask': o[2]}),
            (dana, 'pool_rois',
             lambda a, k, o: {} if k.get('training') or len(a) > 3
             else {'pooled': o[:, :keep]}),
            (predict, 'postprocess_batch',
             lambda a, k, o: {'cls_prob': a[1], 'bbox_pred': a[2]}),
            (dana, 'hard_mined_pair_ce',
             lambda a, k, o: {'mining': torch.stack(
                 [a[0][..., 1] - a[0][..., 0], a[2][..., 1] - a[2][..., 0],
                  a[1].to(a[0].dtype)])}),
        ]
        for mod, name, take in targets:
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))
            setattr(mod, name, outputs(fn, take))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved.clear()

    # -- slots
    def _put(self, key, t):
        if self.stages is not None and key not in self.stages:
            return
        t = t.detach()
        if self.slot == 'probe':
            self.shapes[key] = (tuple(t.shape), t.dtype)
            return
        buf = self.buffers[self.slot]
        if key not in buf:          # a stage the probe did not see
            buf[key] = t.to('cpu')
        else:
            buf[key].copy_(t, non_blocking=True)

    def allocate(self, n):
        """n slots of host buffers in the probed shapes."""
        pin = self.device.type == 'cuda'
        self.buffers = [{k: torch.empty(s, dtype=d, pin_memory=pin)
                         for k, (s, d) in self.shapes.items()}
                        for _ in range(n)]

    def arm(self, slot):
        self.slot = slot

    def disarm(self):
        self.slot = None
