"""Carry weights into the port's modules.

`from_jax_params` takes the JAX package's param tree (nested dicts of
numpy arrays: HWIO convs, [in, out] linears) and `load_reference_state_dict`
a reference-format state dict (`RCNN_base.*`, `RCNN_top.*`, OIHW convs,
[out, in] linears), as a released `.pth` holds it.  Both fill a `DAnA`
module with a strict load, so every weight is consumed and none missing.
"""

from __future__ import annotations

import numpy as np
import torch

from dana_tpu_torch.models.dana import DAnA, DanaConfig

# reference module prefix -> the port's (and the JAX tree's) prefix
_BASE_MAP = {
    'RCNN_base.0': 'backbone.conv1',
    'RCNN_base.1': 'backbone.bn1',
    'RCNN_base.4': 'backbone.layer1',
    'RCNN_base.5': 'backbone.layer2',
    'RCNN_base.6': 'backbone.layer3',
    'RCNN_top.0': 'backbone.layer4',
}


def _flatten(tree, prefix=''):
    for k, v in tree.items():
        name = f'{prefix}.{k}' if prefix else k
        if isinstance(v, dict):
            yield from _flatten(v, name)
        else:
            yield name, v


def _load(config: DanaConfig, state: dict) -> DAnA:
    model = DAnA(config)
    model.load_state_dict(state, strict=True)
    return model.eval().requires_grad_(False)


def from_jax_params(tree: dict, config: DanaConfig) -> DAnA:
    """JAX param tree (numpy leaves) -> DAnA module on the CPU."""
    state = {}
    for name, v in _flatten(tree):
        v = np.asarray(v, np.float32)
        if v.ndim == 4:                          # HWIO -> OIHW
            v = v.transpose(3, 2, 0, 1)
        elif v.ndim == 2:                        # [in, out] -> [out, in]
            v = v.T
        state[name] = torch.from_numpy(np.ascontiguousarray(v))
    return _load(config, state)


def load_reference_state_dict(sd: dict, config: DanaConfig) -> DAnA:
    """Reference-format state dict (tensors or numpy arrays) -> DAnA
    module on the CPU.  num_batches_tracked buffers and the positional
    encoding tables (`pe*`) are skipped."""
    state = {}
    for key, v in sd.items():
        if key.endswith('num_batches_tracked') or key.startswith('pe'):
            continue
        for src, dst in _BASE_MAP.items():
            if key.startswith(src + '.'):
                key = dst + key[len(src):]
                break
        state[key] = torch.as_tensor(np.asarray(v, np.float32))
    return _load(config, state)

