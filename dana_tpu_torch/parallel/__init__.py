"""Device grids and placement: data, tensor and spatial parallelism (port
of dana_tpu/parallel/__init__.py).

PyTorch has no mesh that partitions a program, so the JAX meshes become
explicit device grids (`Grid`: a numpy array of torch.device and its axis
names) and the partitioning is written out:
  * data: a request's or batch's rows split over the grid's 'data' axis
    (`shard_batch`), a model replica on each device (`replicate`); the
    training step's data parallelism is one process per device
    (parallel/distributed.py);
  * tensor ('model' axis, `shard_params_tp`): the wide projections and the
    RPN conv split by output channel over the row's devices
    (`ColumnParallel`: the input goes to each device, the outputs are
    concatenated on the lead device; autograd crosses the devices);
  * spatial ('model' axis, `shard_query_spatial` and parallel/spatial.py):
    the query's H split over the row's devices through the trunk, with
    halo rows exchanged before every convolution and pool.

Every function takes an explicit device list, and a list may name one
device more than once (['cpu', 'cpu'] in the CPU tests, ['cuda:0',
'cuda:0'] on one card), which drives all of the sharding code on one
device.  The CLIs take their list from `local_devices()`.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
import torch.nn as nn

from dana_tpu_torch.parallel.distributed import local_rows
from dana_tpu_torch.utils.device import resolve_device

# the layers tensor parallelism splits by output channel (the JAX
# package's `_tp_spec` names)
TP_COLUMNS = ('rpn_adapt_q_layer', 'rpn_adapt_k_layer', 'rcnn_adapt_q_layer',
              'rcnn_adapt_k_layer', 'RPN_Conv', 'linear1')


def local_devices(device='cuda') -> list:
    """The devices this process drives: every visible card, or the CPU
    when `device` is 'cpu'; raises when cards are asked for and there are
    none."""
    if resolve_device(device).type != 'cuda':
        return [torch.device('cpu')]
    return [torch.device('cuda', i) for i in range(torch.cuda.device_count())]


class Grid:
    """An explicit device grid: `devices`, an object array of
    torch.device, and its `axis_names`; `shape` maps each name to its
    extent, as a JAX mesh's does."""

    def __init__(self, devices, axis_names):
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self):
        return f'Grid({self.shape})'


def _grid(devices, shape, names) -> Grid:
    devs = [torch.device(d) for d in devices]
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Grid(arr.reshape(shape), names)


def make_mesh(devices=None, axis: str = 'data') -> Grid:
    devices = list(devices if devices is not None else local_devices())
    return _grid(devices, (len(devices),), (axis,))


def make_mesh_2d(devices=None, data: int = 0, model: int = 0) -> Grid:
    """2-D (data, model) grid for combined data + tensor (or spatial)
    parallelism; `data` / `model` give the extents (0 = infer from the
    device count)."""
    devices = list(devices if devices is not None else local_devices())
    n = len(devices)
    if not model:
        model = n // data if data else (2 if n % 2 == 0 and n >= 4 else 1)
    if not data:
        data = n // model
    if data * model != n or data < 1:
        raise ValueError(
            f'mesh axes (data={data}, model={model}) do not tile the '
            f'{n} available devices — the model/tp extent must divide '
            f'the device count')
    return _grid(devices, (data, model), ('data', 'model'))


def make_mesh_dcn(slices: int, devices=None) -> Grid:
    """Two-level data-parallel grid ('slice', 'data'): the batch splits
    over both axes, flattened slice-major (`shard_batch`)."""
    devices = list(devices if devices is not None else local_devices())
    n = len(devices)
    if slices < 1 or n % slices:
        raise ValueError(f'{slices} slices do not tile {n} devices')
    return _grid(devices, (slices, n // slices), ('slice', 'data'))


def shard_batch(batch, grid: Grid):
    """A host batch (dict of [B, ...] arrays or tensors) -> one dict per
    batch device (the grid's devices over its batch axes, 'slice' x
    'data' flattened, the first of each 'model' row): its contiguous row
    block, on that device.  B must divide over the blocks (`local_rows`'
    ValueError)."""
    devs = grid.devices
    if 'model' in grid.axis_names:
        devs = devs[..., 0]
    devs = list(devs.reshape(-1))
    out = []
    for i, d in enumerate(devs):
        blk = {}
        for k, v in batch.items():
            v = torch.as_tensor(v)
            blk[k] = v[local_rows(v.shape[0], i, len(devs))].to(d)
        out.append(blk)
    return out


def replicate(model: nn.Module, grid_or_devices) -> list:
    """One replica of `model` per device (flattened grid order): the
    model itself, moved to the first device, and a copy on every other
    device; a device named again shares its replica."""
    devs = list(grid_or_devices.devices.reshape(-1)) \
        if isinstance(grid_or_devices, Grid) else \
        [torch.device(d) for d in grid_or_devices]
    by_dev = {}
    for d in devs:
        if d not in by_dev:
            by_dev[d] = model.to(d) if not by_dev else \
                copy.deepcopy(model).to(d)
    return [by_dev[d] for d in devs]


class ColumnParallel(nn.Module):
    """A Linear or Conv2d split by output channel over `devices`: shard i
    holds rows [i o/n, (i+1) o/n) of the weight and bias on devices[i].
    The input goes to every device and the outputs are concatenated on the
    input's device, so the module computes the whole layer.  Moving the
    module (`.to()`) leaves every shard on its device."""

    def __init__(self, layer: nn.Module, devices):
        super().__init__()
        self.devices = [torch.device(d) for d in devices]
        n = len(self.devices)
        per = layer.weight.shape[0] // n
        self.dim = -1 if isinstance(layer, nn.Linear) else 1
        shards = []
        for i, d in enumerate(self.devices):
            s = copy.deepcopy(layer)
            rows = slice(i * per, (i + 1) * per)
            for name in ('weight', 'bias'):
                p = getattr(layer, name)
                if p is not None:
                    setattr(s, name, nn.Parameter(
                        p.detach()[rows].clone().to(d),
                        requires_grad=p.requires_grad))
            if isinstance(s, nn.Linear):
                s.out_features = per
            else:
                s.out_channels = per
            shards.append(s)
        self.shards = nn.ModuleList(shards)

    def forward(self, x):
        outs = [s(x.to(d)) for s, d in zip(self.shards, self.devices)]
        return torch.cat([o.to(x.device) for o in outs], dim=self.dim)

    def _apply(self, fn, recurse=True):
        return self


def _tp_spec(name: str, weight, model_size: int = 2):
    """The dimension tensor parallelism splits a parameter along: 0 (the
    output features of PyTorch's [out, in] and [out, in, kh, kw] layouts)
    for the weights of TP_COLUMNS whose output divides the 'model'
    extent, else None (replicated)."""
    if any(part in TP_COLUMNS for part in name.split('.')) \
            and name.endswith('weight') and weight.dim() >= 2 \
            and model_size > 0 and weight.shape[0] % model_size == 0:
        return 0
    return None


def _tp_layers(model: nn.Module, model_size: int):
    """(parent, attribute, layer) of every layer `_tp_spec` splits."""
    out = []
    for name, mod in model.named_modules():
        if isinstance(mod, ColumnParallel):
            continue
        w = getattr(mod, 'weight', None)
        if isinstance(w, torch.Tensor) and isinstance(mod, (nn.Linear,
                                                            nn.Conv2d)) \
                and _tp_spec(f'{name}.weight', w, model_size) == 0:
            parent_name, _, attr = name.rpartition('.')
            out.append((model.get_submodule(parent_name), attr, mod))
    return out


def shard_params_tp(model: nn.Module, devices) -> nn.Module:
    """Tensor parallelism over `devices` (one 'model' row of a grid): each
    TP_COLUMNS layer whose output divides len(devices) becomes a
    ColumnParallel over them, in place; everything else stays where it is
    (devices[0]).  -> the model."""
    devices = [torch.device(d) for d in devices]
    for parent, attr, layer in _tp_layers(model, len(devices)):
        setattr(parent, attr, ColumnParallel(layer, devices))
    return model


def shard_state_tp(trainer, devices):
    """A Trainer's state under tensor parallelism over `devices`: its
    model's TP layers split (`shard_params_tp`) with their momentum
    buffers split alike, the optimizer rebuilt over the shards.  -> the
    trainer."""
    devices = [torch.device(d) for d in devices]
    model = trainer.model
    old = {id(p): trainer.optimizer.state.get(p, {}).get('momentum_buffer')
           for p in model.parameters()}
    layers = _tp_layers(model, len(devices))
    split = {}
    for parent, attr, layer in layers:
        col = ColumnParallel(layer, devices)
        setattr(parent, attr, col)
        for name in ('weight', 'bias'):
            p = getattr(layer, name)
            buf = old.get(id(p)) if p is not None else None
            if buf is not None:
                per = buf.shape[0] // len(devices)
                for i, s in enumerate(col.shards):
                    split[id(getattr(s, name))] = \
                        buf[i * per:(i + 1) * per].clone().to(devices[i])
    trainer.rebuild_optimizer()
    for p in trainer.params:
        buf = split.get(id(p), old.get(id(p)))
        if buf is not None:
            trainer.optimizer.state[p]['momentum_buffer'] = buf
    return trainer


def shard_query_spatial(im, devices) -> list:
    """Spatial partitioning: the query [B, H, W, C]'s H split into
    len(devices) equal row blocks, block i on devices[i]."""
    n = len(devices)
    if im.shape[-1] == 12:
        raise ValueError(
            'spatial sharding takes 3-channel queries, not a space-to-depth '
            'packing (12 channels, H/2+3 rows) — use the direct 3-channel '
            'stem under --sp')
    if im.shape[1] % n:
        raise ValueError(
            f'spatial sharding needs H % {n} == 0, got H={im.shape[1]} '
            f'(s2d-packed queries have odd H=H/2+3 and cannot SP-shard — '
            f'use the direct 3-channel stem under --sp)')
    h = im.shape[1] // n
    return [im[:, i * h:(i + 1) * h].to(torch.device(d))
            for i, d in enumerate(devices)]


__all__ = ['local_devices', 'Grid', 'make_mesh', 'make_mesh_2d',
           'make_mesh_dcn', 'shard_batch', 'replicate', 'ColumnParallel',
           'shard_params_tp', 'shard_state_tp', 'shard_query_spatial',
           'TP_COLUMNS']
