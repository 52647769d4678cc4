"""Post-training int8 quantization of the trunk for serving (port of
dana_tpu/quant.py).

The scheme of the JAX package, on host numpy arrays in its layout (HWIO
convs), bit for bit:
  * each frozen BatchNorm folds into the conv before it (`_fold_bn`),
    and its entries become an exact identity (`_identity_bn`: var = 1 -
    eps, so rsqrt(var + eps) is 1);
  * the folded weights are quantized symmetric per output channel
    (`quantize_conv`: scale = max(amax, 1e-12) / 127, round half to even,
    clip to +-127), the folded bias stays float32;
  * activations are quantized per tensor at run time
    (models/layers.py `dynamic_int8_conv`).

Scope 'tail' (the default) quantizes layer4, the RoI tail; 'all' also the
stem and layer1..layer3.  On VGG16, 'all' quantizes the thirteen biased
`features` convs and 'tail' nothing.  Only the trunk (`backbone`) is
touched: the siblings' own convs (FSOD's correlation, FGN's head) stay
float.

`quantize_params` transforms a param tree (the JAX package's function);
`quantize_model` transforms a module in place, swapping each quantized
conv for a `layers.QuantConv2d` under the same name and loading the
identity BatchNorms, so the state dict keeps the reference names and
`utils/weights.py to_jax_params` gives back `quantize_params`'s tree.
Serving only: `engine/train.py Trainer` refuses a quantized model.
"""

from __future__ import annotations

import numpy as np
import torch.nn as nn

from dana_tpu_torch.models import layers as L

SCOPES = ('tail', 'all')
_BN_EPS = 1e-5


def _identity_bn(n):
    """Frozen-BN entries that are an exact no-op: var = 1 - eps makes
    rsqrt(var + eps) == 1."""
    return {
        'weight': np.ones(n, np.float32),
        'bias': np.zeros(n, np.float32),
        'running_mean': np.zeros(n, np.float32),
        'running_var': np.full(n, 1.0 - _BN_EPS, np.float32),
    }


def _fold_bn(conv, bn, eps=_BN_EPS):
    """(conv(x, w) + b) * s + o == conv(x, w * s) + (b * s + o), with
    s = g / sqrt(var + eps), o = beta - mean * s (HWIO: s broadcasts on
    O)."""
    w = np.asarray(conv['weight'], np.float32)
    s = np.asarray(bn['weight'], np.float32) / np.sqrt(
        np.asarray(bn['running_var'], np.float32) + eps)
    o = np.asarray(bn['bias'], np.float32) \
        - np.asarray(bn['running_mean'], np.float32) * s
    out = {'weight': w * s}
    b = np.asarray(conv['bias'], np.float32) if 'bias' in conv else 0.0
    out['bias'] = b * s + o
    return out


def quantize_conv(conv):
    """A float conv {'weight' HWIO, ('bias')} -> {'w_int8' HWIO int8,
    'w_scale' [O] float32, ('bias' float32)}: symmetric, per output
    channel."""
    w = np.asarray(conv['weight'], np.float32)
    amax = np.abs(w).reshape(-1, w.shape[-1]).max(0)
    scale = np.maximum(amax, 1e-12) / 127.0
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    out = {'w_int8': q, 'w_scale': scale.astype(np.float32)}
    if 'bias' in conv:
        out['bias'] = np.asarray(conv['bias'], np.float32)
    return out


def _quantize_block(blk):
    out = {}
    for i in (1, 2, 3):
        ck, bk = f'conv{i}', f'bn{i}'
        if ck not in blk:
            continue
        out[ck] = quantize_conv(_fold_bn(blk[ck], blk[bk]))
        out[bk] = _identity_bn(len(blk[bk]['weight']))
    if 'downsample' in blk:
        ds = blk['downsample']
        out['downsample'] = {
            '0': quantize_conv(_fold_bn(ds['0'], ds['1'])),
            '1': _identity_bn(len(ds['1']['weight'])),
        }
    return out


def quantize_backbone(bb, scope='all'):
    """A ResNet trunk tree (conv1 / bn1, layer1..layer4 of blocks) or a
    VGG16 one ('features' of bare biased convs) -> its quantized tree at
    `scope` ('all' or 'tail'); other leaves pass through."""
    if 'features' in bb:                                   # vgg16
        out = dict(bb)
        if scope == 'all':
            out['features'] = {k: quantize_conv(v)
                               for k, v in bb['features'].items()}
        return out
    out = {}
    for key, val in bb.items():
        if key == 'conv1' and scope == 'all':
            out['conv1'] = quantize_conv(_fold_bn(bb['conv1'], bb['bn1']))
        elif key == 'bn1' and scope == 'all':
            out['bn1'] = _identity_bn(len(bb['bn1']['weight']))
        elif key.startswith('layer') and (
                scope == 'all' or (scope == 'tail' and key == 'layer4')):
            out[key] = {bi: _quantize_block(blk)
                        for bi, blk in val.items()}
        else:
            out[key] = val
    return out


def count_int8(tree):
    """The int8 convs of a param tree or a module (0: the transform was a
    no-op, e.g. VGG16 at scope 'tail')."""
    if isinstance(tree, nn.Module):
        return sum(isinstance(m, L.QuantConv2d) for m in tree.modules())
    if not isinstance(tree, dict):
        return 0
    return int('w_int8' in tree) + sum(count_int8(v) for v in tree.values())


def _host(tree):
    return {k: _host(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def quantize_params(params, scope='tail'):
    """A detector's param tree -> the tree with its 'backbone' quantized
    at `scope` (numpy leaves)."""
    if scope not in SCOPES:
        raise ValueError(f'quantization scope {scope!r} is not one of '
                         f'{SCOPES}')
    out = _host(params)
    out['backbone'] = quantize_backbone(out['backbone'], scope=scope)
    return out


def _int8_paths(tree, prefix=''):
    """The dotted paths of the int8 convs of a tree."""
    if 'w_int8' in tree:
        yield prefix
        return
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _int8_paths(v, f'{prefix}.{k}' if prefix else k)


def swap_int8_convs(module, tree):
    """Replace each conv of `module` that `tree` (its quantized param tree)
    holds as int8 with a `QuantConv2d` of the same geometry, under the same
    name and on the same device; -> module."""
    for path in _int8_paths(tree):
        owner, _, name = path.rpartition('.')
        owner = module.get_submodule(owner)
        conv = getattr(owner, name)
        setattr(owner, name, L.QuantConv2d(
            conv.in_channels, conv.out_channels, conv.kernel_size[0],
            conv.stride[0], conv.padding[0]).to(conv.weight.device))
    return module


def quantize_model(model, scope='tail'):
    """Quantize `model.backbone` in place at `scope`, bit for bit as
    `quantize_params` quantizes the same weights; -> model."""
    from dana_tpu_torch.utils.weights import load_jax_tree, to_jax_params
    if scope not in SCOPES:
        raise ValueError(f'quantization scope {scope!r} is not one of '
                         f'{SCOPES}')
    if count_int8(model):
        raise ValueError('the model is quantized already')
    tree = quantize_backbone(to_jax_params(model.backbone), scope=scope)
    load_jax_tree(swap_int8_convs(model.backbone, tree), tree)
    return model
