"""Carry weights into and out of the port's modules.

`from_jax_params` takes the JAX package's param tree (nested dicts of
numpy arrays: HWIO convs, [in, out] linears) and `load_reference_state_dict`
a reference-format state dict (`RCNN_base.*`, `RCNN_top.*`, OIHW convs,
[out, in] linears), as a released `.pth` holds it.  Both fill the module of
`config.framework` (models/frameworks.py `build`) with a strict load, so
every weight is consumed and none missing.
A tree quantized for int8 serving (`quantize_params` of either package)
keeps its int8 weights int8 both ways.
`to_jax_params` turns a module back into the JAX param tree, and
`velocity_to_jax` / `velocity_from_jax` carry SGD momentum buffers to and
from the JAX package's velocity tree, in the same layout.  Every trunk
crosses by name: a ResNet's `backbone.layerN.*` (any depth; the reference's
`RCNN_base.*` / `RCNN_top.*` prefixes map onto them) and VGG16's
`backbone.features.N.*` / `backbone.classifier.{0,3}.*`.
`torchvision_vgg16_params` takes a torchvision VGG16 state dict to the
JAX-layout trunk tree that `init_params(..., backbone_params=)` takes.
"""

from __future__ import annotations

import numpy as np
import torch

from dana_tpu_torch.models.dana import DanaConfig
from dana_tpu_torch.models.frameworks import build

# reference module prefix -> the port's (and the JAX tree's) prefix
_BASE_MAP = {
    'RCNN_base.0': 'backbone.conv1',
    'RCNN_base.1': 'backbone.bn1',
    'RCNN_base.4': 'backbone.layer1',
    'RCNN_base.5': 'backbone.layer2',
    'RCNN_base.6': 'backbone.layer3',
    'RCNN_top.0': 'backbone.layer4',
}
# FGN's RCNN_cls_score takes the flattened [128, 3, 3] score map: the
# reference flattens it in (c, h, w) order, the port (as the JAX package)
# in (h, w, c) order
_FGN_CLS_IN = (128, 3, 3)


def _flatten(tree, prefix=''):
    for k, v in tree.items():
        name = f'{prefix}.{k}' if prefix else k
        if isinstance(v, dict):
            yield from _flatten(v, name)
        else:
            yield name, v


def _load(config: DanaConfig, state: dict) -> torch.nn.Module:
    model = build(config)
    model.load_state_dict(state, strict=True)
    return model.eval().requires_grad_(False)


def _from_jax_layout(v) -> torch.Tensor:
    """A JAX leaf -> the port's layout: HWIO -> OIHW, [in, out] -> [out,
    in]; float32, but int8 (a quantized conv's `w_int8`) stays int8."""
    v = np.asarray(v)
    v = v if v.dtype == np.int8 else v.astype(np.float32)
    if v.ndim == 4:
        v = v.transpose(3, 2, 0, 1)
    elif v.ndim == 2:
        v = v.T
    return torch.from_numpy(np.ascontiguousarray(v))


def _to_jax_layout(t: torch.Tensor) -> np.ndarray:
    """The port's tensor -> a JAX leaf: OIHW -> HWIO, [out, in] -> [in,
    out], float32 numpy (int8 stays int8)."""
    v = t.detach().cpu().numpy()
    if v.ndim == 4:
        v = v.transpose(2, 3, 1, 0)
    elif v.ndim == 2:
        v = v.T
    return np.ascontiguousarray(
        v, np.int8 if v.dtype == np.int8 else np.float32)


def _unflatten(items) -> dict:
    tree = {}
    for name, v in items:
        *path, leaf = name.split('.')
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def load_jax_tree(module: torch.nn.Module, tree: dict) -> torch.nn.Module:
    """A strict load of a JAX-layout tree into `module`; -> module."""
    module.load_state_dict({name: _from_jax_layout(v)
                            for name, v in _flatten(tree)}, strict=True)
    return module


def from_jax_params(tree: dict, config: DanaConfig) -> torch.nn.Module:
    """JAX param tree (numpy leaves) -> config.framework's module on the
    CPU.  A tree quantized by `quant.quantize_params` (the JAX package's or
    the port's) gives the int8 module: its quantized convs become
    `QuantConv2d`s."""
    from dana_tpu_torch.quant import swap_int8_convs
    model = build(config)
    swap_int8_convs(model, tree)
    return load_jax_tree(model, tree).eval().requires_grad_(False)


def to_jax_params(model: torch.nn.Module) -> dict:
    """A detector module -> the JAX param tree (numpy float32 leaves, HWIO
    convs, [in, out] linears), every parameter and buffer."""
    return _unflatten((name, _to_jax_layout(t))
                      for name, t in model.state_dict().items())


def velocity_to_jax(model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer) -> dict:
    """The SGD momentum buffers as the JAX package's velocity tree: the
    layout and every leaf of `to_jax_params`, zero where a parameter has no
    buffer (frozen, or before its first step) and for the buffers, as the
    JAX package's `sgd_init` makes them."""
    params = dict(model.named_parameters())
    items = []
    for name, t in model.state_dict().items():
        p = params.get(name)
        buf = optimizer.state.get(p, {}).get('momentum_buffer') \
            if p is not None else None
        if buf is None:
            shape = tuple(t.shape)
            shape = shape[2:] + shape[1::-1] if len(shape) == 4 \
                else shape[::-1]
            items.append((name, np.zeros(shape, np.float32)))
        else:
            items.append((name, _to_jax_layout(buf)))
    return _unflatten(items)


def velocity_from_jax(tree: dict, model: torch.nn.Module) -> dict:
    """A JAX velocity tree -> {parameter of `model`: its momentum, a CPU
    tensor in the parameter's layout}; the tree's leaves for buffers are
    not read.  The tree must hold every parameter."""
    flat = dict(_flatten(tree))
    return {p: _from_jax_layout(flat[name])
            for name, p in model.named_parameters()}


def torchvision_vgg16_params(state_dict: dict) -> dict:
    """A torchvision vgg16 state dict (tensors or numpy arrays) -> the
    VGG16 trunk's tree in the JAX layout (HWIO convs, [in, out] linears);
    the 1000-way classifier.6 is dropped."""
    return _unflatten(
        (key, _to_jax_layout(torch.as_tensor(np.asarray(v, np.float32))))
        for key, v in state_dict.items()
        if not key.startswith('classifier.6.'))


def load_reference_state_dict(sd: dict, config: DanaConfig
                              ) -> torch.nn.Module:
    """Reference-format state dict (tensors or numpy arrays) ->
    config.framework's module on the CPU.  num_batches_tracked buffers and
    the positional encoding tables (`pe*`) are skipped; FGN's
    RCNN_cls_score weight is permuted from the reference's (c, h, w) input
    order to the port's (h, w, c)."""
    state = {}
    for key, v in sd.items():
        if key.endswith('num_batches_tracked') or key.startswith('pe'):
            continue
        for src, dst in _BASE_MAP.items():
            if key.startswith(src + '.'):
                key = dst + key[len(src):]
                break
        v = np.asarray(v, np.float32)
        if config.framework == 'fgn' and key == 'RCNN_cls_score.weight':
            v = v.reshape(-1, *_FGN_CLS_IN).transpose(0, 2, 3, 1) \
                .reshape(v.shape[0], -1)
        state[key] = torch.from_numpy(np.ascontiguousarray(v))
    return _load(config, state)

