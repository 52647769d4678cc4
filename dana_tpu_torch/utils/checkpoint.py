"""Read the checkpoints the JAX package and the reference write, and write
the JAX package's (its `utils/checkpoint.py`).

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

Both formats carry the `pooling_mode` the detector trained with; the
CLIs take it from the payload into their config, as the JAX CLIs do.  A
checkpoint whose `extra['framework']` (the port's writer records the
detector there) names another detector than the config's is refused.

`save_checkpoint` writes the `.dkpt` pickle with plain dicts, floats, ints,
strings and numpy arrays only, so that both the JAX package's
`load_checkpoint` and this module's restricted reader take it; its
'optimizer' is {'velocity': tree, 'lr': float}, which the JAX package's
`restore_optimizer` reads.  `optimizer_velocity` reads the velocity from
either writer's payload.  Orbax directories are neither read nor written.
"""

from __future__ import annotations

import dataclasses
import os
import os.path as osp
import pickle

import numpy as np
import torch

from dana_tpu_torch.utils.weights import (from_jax_params,
                                          load_reference_state_dict,
                                          to_jax_params)

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


def read_checkpoint(path):
    """`.pth` or `.dkpt` -> its payload ('model' a flat state dict or a
    param tree)."""
    if path.endswith('.pth'):
        return read_pth(path)
    if path.endswith('.dkpt') or osp.isfile(path):
        return read_dkpt(path)
    raise FileNotFoundError(
        f'{path}: no checkpoint (an Orbax directory is not read by the '
        'port)')


def load_checkpoint(path, config, payload=None):
    """`.pth` or `.dkpt` (or its `payload`, read already) ->
    (config.framework's module on the CPU, payload without its 'model'
    entry).  Refuses a checkpoint that records another detector."""
    if payload is None:
        payload = read_checkpoint(path)
    written = (payload.get('extra') or {}).get('framework')
    if written not in (None, config.framework):
        raise ValueError(f'{path}: a {written} checkpoint, not '
                         f'{config.framework}')
    build = load_reference_state_dict if path.endswith('.pth') \
        else from_jax_params
    model = build(payload.pop('model'), config)
    return model, payload


def take_pooling_mode(payload, c, config):
    """A checkpoint's pooling mode (when it records one) into the config
    tree `c` and the detector's `config`, as the root `inference.py`
    does.  -> the config to run."""
    c.POOLING_MODE = payload.get('pooling_mode') or c.POOLING_MODE
    if config.pooling_mode != c.POOLING_MODE:
        config = dataclasses.replace(config, pooling_mode=c.POOLING_MODE)
    return config


def save_checkpoint(path, model, velocity=None, epoch=0, step=0, lr=None,
                    pooling_mode='align', extra=None):
    """Write the JAX package's `.dkpt` at `path`: the `to_jax_params` tree of
    `model`, the optimizer {'velocity': `velocity` (a JAX velocity tree),
    'lr'} when a velocity is given, and `extra` (numpy arrays and plain
    values).  -> path."""
    os.makedirs(osp.dirname(path) or '.', exist_ok=True)
    payload = {
        'format': 'dana_tpu_v1',
        'epoch': int(epoch),
        'step': int(step),
        'model': to_jax_params(model),
        'optimizer': None if velocity is None else {
            'velocity': velocity, 'lr': float(lr)},
        'lr': None if lr is None else float(lr),
        'pooling_mode': pooling_mode,
        'extra': dict(extra or {}),
    }
    tmp = f'{path}.{os.getpid()}.tmp'
    with open(tmp, 'wb') as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)
    return path


def optimizer_velocity(payload):
    """The momentum velocity tree of a payload's 'optimizer', or None: this
    module's dict, or the JAX package's pickled `SGDState(velocity, lr)`,
    which the reader keeps as a `PickledObject` whose first argument is the
    velocity.  A reference `.pth`'s torch optimizer state is not read (the
    JAX package drops it too)."""
    opt = payload.get('optimizer')
    if opt is None or payload.get('format') == 'torch':
        return None
    if isinstance(opt, dict):
        return opt['velocity']
    if isinstance(opt, PickledObject) and opt.name == 'SGDState':
        return opt.args[0]
    raise ValueError(f'optimizer state {opt!r}: not an SGD velocity')


def checkpoint_path(save_dir, epoch, step, suffix='dkpt'):
    return osp.join(save_dir, 'train', 'checkpoints',
                    f'model_{epoch}_{step}.{suffix}')
