"""Write and read reference-format PyTorch checkpoints (port of the export
half of dana_tpu/utils/torch_import.py; utils/checkpoint.py `read_pth`
and utils/weights.py `load_reference_state_dict` are the import half).

  * `export_dana_state_dict(model)`: a detector module -> the flat
    reference-named state dict (numpy arrays) the reference's train.py
    saves: `backbone.conv1` / `bn1` / `layer1..3` under `RCNN_base.N`,
    `layer4` under `RCNN_top.0`, a `num_batches_tracked` beside every
    BatchNorm's running statistics, and FGN's `RCNN_cls_score` weight back
    in the reference's (c, h, w) input order.  It equals the JAX package's
    `export_dana_state_dict` of the same weights' tree.
  * `save_reference_pth(path, model, ...)`: the `{'model', 'epoch',
    'optimizer', 'pooling_mode'}` payload of reference train.py:183-189,
    which the JAX package's `load_dana_checkpoint` and the port's
    `read_pth` both read.
  * `load_caffe_resnet(path)`: a trunk-only checkpoint
    (data/pretrained_model/resnet50_caffe.pth) -> the trunk's tree in the
    JAX layout, which `init_params(config, backbone_params=)` takes.
"""

from __future__ import annotations

import numpy as np
import torch

from dana_tpu_torch.utils.weights import _BASE_MAP, _FGN_CLS_IN

_INV_BASE_MAP = {v: k for k, v in _BASE_MAP.items()}


def export_dana_state_dict(model: torch.nn.Module) -> dict:
    """A detector module (float, not int8) -> its reference-format state
    dict of numpy arrays."""
    out = {}
    for name, t in model.state_dict().items():
        v = t.detach().cpu().numpy()
        for src, dst in _INV_BASE_MAP.items():
            if name.startswith(src + '.'):
                name = dst + name[len(src):]
                break
        if name == 'RCNN_cls_score.weight' and \
                v.shape[1] == int(np.prod(_FGN_CLS_IN)):
            c, h, w = _FGN_CLS_IN        # (h, w, c) flat -> (c, h, w) flat
            v = v.reshape(-1, h, w, c).transpose(0, 3, 1, 2) \
                .reshape(v.shape[0], -1)
        out[name] = np.ascontiguousarray(v)
        if name.endswith('running_var'):
            out[name[:-len('running_var')] + 'num_batches_tracked'] = \
                np.asarray(0, np.int64)
    return out


def save_reference_pth(path: str, model: torch.nn.Module, epoch: int = 4,
                       pooling_mode: str = 'align', lr=None) -> str:
    """Write `model` as a reference-format checkpoint; -> path."""
    sd = {k: torch.from_numpy(v)
          for k, v in export_dana_state_dict(model).items()}
    payload = {'model': sd, 'epoch': epoch, 'optimizer': {},
               'pooling_mode': pooling_mode}
    if lr is not None:
        payload['lr'] = lr
    torch.save(payload, path)
    return path


def load_caffe_resnet(path: str) -> dict:
    """A ResNet trunk's torch state dict (`conv1.weight`, `layer1.0...`;
    `fc.*` and `num_batches_tracked` dropped) -> its nested tree in the
    JAX layout (HWIO convs, float32)."""
    from dana_tpu_torch.utils.checkpoint import read_pth
    state = read_pth(path)['model']
    out = {}
    for key, v in state.items():
        if key.startswith('fc.') or key.endswith('num_batches_tracked'):
            continue
        if v.ndim == 4:
            v = v.transpose(2, 3, 1, 0)
        *path_, leaf = key.split('.')
        node = out
        for p in path_:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(v, np.float32)
    return out
