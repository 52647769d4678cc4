"""Read the checkpoints the JAX package and the reference write (the read
side of the JAX package's `utils/checkpoint.py` `load_checkpoint`).

  * `.pth`: a reference-format payload {'model': state dict, 'epoch',
    'optimizer', 'pooling_mode'} (or a bare state dict), read by
    `torch.load(weights_only=True)` into `utils/weights.py
    load_reference_state_dict`.
  * `.dkpt`: the JAX package's pickle {'format', 'epoch', 'step', 'model':
    numpy param tree, 'optimizer', 'lr', 'pooling_mode', 'extra'}, whose
    'model' tree goes through `from_jax_params`.  Its 'optimizer' entry may
    hold pickled optimizer-state classes of the JAX package or optax; they
    are read as opaque `PickledObject`s, so neither package is imported,
    and nothing but numpy's array and dtype constructors is ever called.

A checkpoint whose `pooling_mode` is not 'align' is refused: the port pools
with RoIAlign only.
"""

from __future__ import annotations

import os.path as osp
import pickle

import numpy as np
import torch

from dana_tpu_torch.utils.weights import (from_jax_params,
                                          load_reference_state_dict)

# the globals a pickled numpy tree needs (numpy 1 and numpy 2 names)
_NUMPY_GLOBALS = {
    (f'numpy.{core}.{mod}', name)
    for core in ('core', '_core')
    for mod, name in (('multiarray', '_reconstruct'),
                      ('multiarray', 'scalar'), ('numeric', '_frombuffer'))
} | {('numpy', 'ndarray'), ('numpy', 'dtype')}


class PickledObject:
    """Stand-in for an object of a class the reader does not import: keeps
    the class's module and name, and the arguments and state it was
    pickled with."""

    module = name = ''

    def __new__(cls, *args, **kwargs):
        obj = object.__new__(cls)
        obj.args = args
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state

    def __repr__(self):
        return f'PickledObject({self.module}.{self.name})'


class _Reader(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _NUMPY_GLOBALS:
            return super().find_class(module, name)
        if module.split('.')[0] == 'numpy':
            raise pickle.UnpicklingError(
                f'checkpoint names {module}.{name}, which a numpy param '
                'tree never holds')
        return type(name, (PickledObject,), {'module': module, 'name': name})


def read_dkpt(path):
    """The JAX package's pickled checkpoint -> its payload dict, with
    classes outside numpy as `PickledObject`s."""
    with open(path, 'rb') as f:
        payload = _Reader(f).load()
    if not isinstance(payload, dict) or 'model' not in payload:
        raise ValueError(f'{path}: not a checkpoint of the JAX package '
                         '(no "model" entry)')
    return payload


def read_pth(path):
    """A reference-format `.pth` -> payload dict with 'model' the flat state
    dict of numpy arrays."""
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    if isinstance(ckpt, dict) and 'model' in ckpt:
        payload = dict(ckpt)
    else:
        payload = {'model': ckpt}
    payload['model'] = {
        k: v.detach().numpy() if isinstance(v, torch.Tensor)
        else np.asarray(v) for k, v in payload['model'].items()}
    payload.setdefault('format', 'torch')
    return payload


def load_checkpoint(path, config):
    """`.pth` or `.dkpt` -> (DAnA module on the CPU, payload without its
    'model' entry).  Refuses a pooling mode other than 'align'."""
    if path.endswith('.pth'):
        payload = read_pth(path)
        build = load_reference_state_dict
    elif path.endswith('.dkpt') or osp.isfile(path):
        payload = read_dkpt(path)
        build = from_jax_params
    else:
        raise FileNotFoundError(
            f'{path}: no checkpoint (an Orbax directory is not read by the '
            'port)')
    mode = payload.get('pooling_mode') or 'align'
    if mode != 'align':
        raise ValueError(f'{path}: pooling_mode {mode!r}; the port pools '
                         'with RoIAlign only')
    model = build(payload.pop('model'), config)
    return model, payload


def checkpoint_path(save_dir, epoch, step, suffix='dkpt'):
    return osp.join(save_dir, 'train', 'checkpoints',
                    f'model_{epoch}_{step}.{suffix}')
