"""Serving export: ahead-of-time traced inference artifacts
(port of dana_tpu/serve.py, on `torch.export`).

A deployment should not need the model code or a Python trace of it at
process start.  `export_predictor` traces the whole predict step (the
DAnA eval forward, box decode and the NMS postprocess) with
`torch.export`, one program per static query bucket, plus the support
encoder, and saves each with `torch.export.save`; `load` reads them back
and returns a `Predictor` that calls them.  The parameters travel as
ARGUMENTS, the port's state dict (`model.state_dict()`, utils/weights.py),
and are not kept in the artifact, so one artifact serves any checkpoint
of the same architecture and stays far below the weights' size.

The hand kernels are registered ops with fake implementations (K1
`dana_torch::cisa_shots`, K2 `dana_torch::roi_align`, NMS
`dana_torch::nms_sorted`), and so is the int8 product
(`dana_torch::int8_mm`, `torch._int_mm` on the card), so a program holds
each as one call: on the card it launches the kernel and counts the
launch, on the CPU it runs the plain version.  This module imports those
ops and never the model code; loading an artifact needs nothing else.

JAX's `platforms` becomes `device`: the device the artifact serves on, the
card unless the caller asks for the CPU.  Every program is traced on the
CPU, through the ops' fake implementations, and then placed on its device
by `_retarget`, which rewrites the devices the graph names and builds its
tensors' metadata anew on the target; it moves no tensor.  The forward
builds every table it needs (positional encodings, anchors, the
postprocess's and the pixel means) on its input's device, so a program
holds no tensor constant, and the export refuses one that does.  A host
without a card (no CUDA, no nvcc) therefore exports for the card, float
and int8 alike, as the JAX package's `platforms=('tpu',)` exports from a
CPU build host.  `s2d` exports for the space-to-depth stem
(TPU.STEM_S2D): the programs take host-packed queries and supports
(data/blob.py `s2d_pack`), and `Predictor` maps a packed query's shape
back to its bucket.

Artifact layout (directory):
    meta.json                      config, buckets, weights' key order
    predict_<H>x<W>.pt2            the predict step for each bucket
    encode_supports.pt2            the support encoder
"""

from __future__ import annotations

import json
import os

import torch
import torch.nn as nn
import torch.utils._pytree as pytree
from torch.func import functional_call

# the ops the artifacts call, registered on import
from dana_tpu_torch.ops import (cisa_attention, int8_mm,  # noqa: F401
                                nms, roi_align)
from dana_tpu_torch.utils import trace
from dana_tpu_torch.utils.device import resolve_device, use_full_f32

BUCKETS = ((608, 1024), (1024, 608), (704, 704), (608, 1216), (1216, 608))


def s2d_hw(h, w):
    """A canvas (H, W)'s space-to-depth packing's (H/2+3, W/2+3)."""
    return h // 2 + 3, w // 2 + 3


def canvas_hw(h, w):
    """A space-to-depth packing's (H', W') -> its canvas's (H, W)."""
    return (h - 3) * 2, (w - 3) * 2


class _Encode(nn.Module):
    def __init__(self, model, config):
        super().__init__()
        self.model, self.config = model, config

    def forward(self, sup):
        from dana_tpu_torch.models import dana
        return dana.extract_support_feats(self.model, self.config, sup)


class _Predict(nn.Module):
    def __init__(self, model, config, pp_kwargs):
        super().__init__()
        self.model, self.config, self.pp_kwargs = model, config, pp_kwargs

    def forward(self, im_data, im_info, sup_feat, sup_pooled):
        from dana_tpu_torch.engine.postprocess import postprocess_batch
        from dana_tpu_torch.models import frameworks
        c = self.config
        out = frameworks.forward(self.model, c, im_data, im_info,
                                 support_feats=(sup_feat, sup_pooled))
        return postprocess_batch(
            out['rois'], out['cls_prob'].float(), out['bbox_pred'].float(),
            im_info, bbox_stds=c.bbox_normalize_stds,
            bbox_means=c.bbox_normalize_means, **self.pp_kwargs)


class _WeightsAsArguments(nn.Module):
    """Runs `fn` (whose weights are `fn.model`'s) on the weights it is
    given: `fn` is held outside the module tree, so no weight of it is
    lifted into the traced program."""

    def __init__(self, fn):
        super().__init__()
        self.__dict__['fn'] = fn

    def forward(self, params, *args):
        return functional_call(self.fn, {f'model.{k}': v
                                         for k, v in params.items()}, args,
                               strict=True)


def _retarget(ep, target):
    """Place the program traced on the CPU on `target`, in place: every
    device in a node's arguments becomes `target`, and every tensor of a
    node's metadata a fake tensor of the same shape, strides and dtype on
    `target`, made in the program's own fake mode.  No tensor is moved, so
    no card is needed; a program that holds a tensor constant is refused
    (moving it would need the card)."""
    consts = [k for k, t in ep.constants.items()
              if isinstance(t, torch.Tensor)]
    if consts:
        raise RuntimeError(f'the program holds tensor constants {consts[:5]}:'
                           ' build them on the input\'s device in the forward')

    def device(v):
        return target if isinstance(v, torch.device) else v

    def fake(v):
        if not isinstance(v, torch.Tensor):
            return v
        with v.fake_mode:
            return torch.empty_strided(v.shape, v.stride(), dtype=v.dtype,
                                       device=target)
    for m in ep.graph_module.modules():
        if isinstance(m, torch.fx.GraphModule):
            for n in m.graph.nodes:
                n.args = pytree.tree_map(device, n.args)
                n.kwargs = pytree.tree_map(device, n.kwargs)
                if 'val' in n.meta:
                    n.meta['val'] = pytree.tree_map(fake, n.meta['val'])
    ep.validate()


def program_devices(ep) -> set:
    """Every device a program names: its nodes' tensor metadata, its
    nodes' device arguments and its tensor constants."""
    found = {str(v.device) for n in ep.graph.nodes
             for v in pytree.tree_leaves(n.meta.get('val'))
             if isinstance(v, torch.Tensor)}
    found |= {str(v) for n in ep.graph.nodes
              for v in pytree.tree_leaves((n.args, n.kwargs))
              if isinstance(v, torch.device)}
    return found | {str(t.device) for t in ep.constants.values()
                    if isinstance(t, torch.Tensor)}


def _export(fn, params, args, path, target):
    """Trace `fn` on the CPU with the weights as its first argument, place
    it on `target` (`_retarget`) and save it without its example inputs
    (the weights among them).  -> its outputs' (shape, dtype)."""
    with torch.no_grad():
        ep = torch.export.export(_WeightsAsArguments(fn), (params, *args),
                                 strict=False)
    outs = [(v.shape, v.dtype) for v in pytree.tree_leaves(
        [n.meta.get('val') for n in ep.graph.find_nodes(op='output')[0]
         .args[0]])]
    if target.type != 'cpu':
        _retarget(ep, target)
    ep.example_inputs = None
    torch.export.save(ep, path)
    return outs


def _indexed(device) -> torch.device:
    """The device, a card with its index (as its tensors report it)."""
    dev = resolve_device(device)
    if dev.type == 'cuda' and dev.index is None:
        return torch.device('cuda', torch.cuda.current_device())
    return dev


def _target(device) -> torch.device:
    """The device an export is for, a card with its index: the current
    card, or on a host without one cuda:0 (the card a serving process
    takes first)."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        return torch.device('cuda', dev.index or 0)
    return _indexed(dev)


def _is_quantized(model) -> bool:
    from dana_tpu_torch.models import layers
    return any(isinstance(m, layers.QuantConv2d) for m in model.modules())


def export_predictor(params, config, out_dir, buckets=BUCKETS, batch_size=8,
                     sup_size=320, s2d=False, device='cuda', pp_kwargs=None):
    """Save the predict step for each (H, W) of `buckets` and the support
    encoder under `out_dir`; -> the meta dict (meta.json).

    params: the JAX package's param tree (numpy leaves; float or quantized
    by quant.quantize_params) or the built module (an int8 one from
    quant.quantize_model included); meta.json records whether it is
    quantized.  config: its DanaConfig (DAnA or cisa: the detectors that
    serve from encoded supports).  The artifacts serve on `device` (the
    card unless 'cpu' is asked for; a host without a card exports for it
    too) and are traced on the CPU.  The predict step takes (params, im_data
    [batch_size, H, W, 3] float32 mean-subtracted, im_info [batch_size, 3],
    sup_feat, sup_pooled as the encoder gives them, one row per query) ->
    (dets [batch_size, 100, 5], valid [batch_size, 100]); the encoder takes
    (params, support images [1, n_way * n_shot, sup_size, sup_size, 3]
    float32 mean-subtracted) -> (feat, pooled).  With `s2d` (a ResNet
    trunk; even buckets and sup_size) both take the space-to-depth
    packing instead: im_data [batch_size, H/2+3, W/2+3, 12], supports [1,
    n_way * n_shot, sup_size/2+3, sup_size/2+3, 12].  `pp_kwargs` are the
    postprocess's keywords (utils.config.postprocess_kwargs; the built-in
    tree's when None)."""
    from dana_tpu_torch.models import dana
    from dana_tpu_torch.utils import config as cfg
    from dana_tpu_torch.utils.weights import from_jax_params
    if s2d and (config.arch == 'vgg16' or sup_size % 2
                or any(h % 2 or w % 2 for h, w in buckets)):
        raise ValueError('a space-to-depth export needs a ResNet trunk and '
                         'even buckets and support size (got '
                         f'{config.arch}, {list(buckets)}, {sup_size})')
    if config.framework not in dana.CACHED_SUPPORTS:
        raise ValueError(f'{config.framework} takes each request\'s support '
                         'images: only DAnA and cisa serve from encoded '
                         'supports')
    target = _target(device)
    counted = trace.counts()
    model = params if isinstance(params, nn.Module) \
        else from_jax_params(params, config)
    quantized = _is_quantized(model)
    # the trace reads only these tensors (functional_call), on the CPU: the
    # caller's module stays where it is
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    pp_kwargs = dict(cfg.postprocess_kwargs() if pp_kwargs is None
                     else pp_kwargs)
    os.makedirs(out_dir, exist_ok=True)
    b, n_sup = batch_size, config.n_way * config.n_shot

    sup = torch.zeros(1, n_sup, *s2d_hw(sup_size, sup_size), 12) if s2d \
        else torch.zeros(1, n_sup, sup_size, sup_size, 3)
    (feat, fdt), (pooled, pdt) = _export(
        _Encode(model, config), state, (sup,),
        os.path.join(out_dir, 'encode_supports.pt2'), target)
    sup_feat = torch.zeros(b, *feat[1:], dtype=fdt)
    sup_pooled = torch.zeros(b, *pooled[1:], dtype=pdt)

    predict = _Predict(model, config, pp_kwargs)
    table = []
    for h, w in buckets:
        im = torch.zeros(b, *s2d_hw(h, w), 12) if s2d \
            else torch.zeros(b, h, w, 3)
        info = torch.tensor([[h, w, 1.0]] * b)
        name = f'predict_{h}x{w}.pt2'
        _export(predict, state, (im, info, sup_feat, sup_pooled),
                os.path.join(out_dir, name), target)
        table.append({'bucket': [h, w], 'file': name})

    meta = {
        'batch_size': b, 'n_way': config.n_way, 'n_shot': config.n_shot,
        'arch': config.arch, 's2d': bool(s2d), 'sup_size': sup_size,
        'buckets': table, 'postprocess': pp_kwargs, 'quantized': quantized,
        'device': str(target), 'framework': config.framework,
        'weights': list(state),
    }
    with open(os.path.join(out_dir, 'meta.json'), 'w') as f:
        json.dump(meta, f, indent=1)
    _uncount_trace(counted)
    return meta


def _uncount_trace(counted):
    """Counters that a trace bumps once (the int8 work's) count no run:
    take back what the export added since `counted`."""
    now = trace.counts()
    for name in ('dynamic_int8_conv.runs', 'roi_align_int8.runs'):
        trace.count(name, counted[name] - now[name])


class Predictor:
    """The deserialized serving bundle: picks the artifact for a bucket (a
    space-to-depth artifact's by the canvas its packed query stands for)
    and calls it.  `encode(params, sup_ims)` -> (feat, pooled) support
    features; `__call__(params, im, info, sup_feat, sup_pooled)` -> (dets,
    valid).  `params` is the port's state dict in any mapping type (taken
    in meta.json's key order; tensors elsewhere are moved to the
    artifact's device)."""

    def __init__(self, out_dir, device=None):
        with open(os.path.join(out_dir, 'meta.json')) as f:
            self.meta = json.load(f)
        self.device = _indexed(device or self.meta['device'])
        if self.device.type != torch.device(self.meta['device']).type:
            raise ValueError(f'the artifacts were exported for '
                             f'{self.meta["device"]}, not {self.device}')
        if self.device.type == 'cuda':
            use_full_f32()
        self._encode = _load(os.path.join(out_dir, 'encode_supports.pt2'))
        self._predict = {tuple(row['bucket']): _load(
            os.path.join(out_dir, row['file']))
            for row in self.meta['buckets']}

    def weights(self, params) -> dict:
        """`params` as the programs take them: a dict in meta.json's key
        order, on the artifact's device."""
        return {k: torch.as_tensor(params[k], device=self.device)
                for k in self.meta['weights']}

    @torch.inference_mode()
    def encode(self, params, sup_ims):
        return self._encode(self.weights(params), torch.as_tensor(
            sup_ims, device=self.device))

    def buckets(self):
        return sorted(self._predict)

    @torch.inference_mode()
    def __call__(self, params, im_data, im_info, sup_feat, sup_pooled):
        hw = tuple(im_data.shape[1:3])
        fn = self._predict[canvas_hw(*hw) if self.meta['s2d'] else hw]
        dev = self.device
        return fn(self.weights(params), torch.as_tensor(im_data, device=dev),
                  torch.as_tensor(im_info, device=dev),
                  torch.as_tensor(sup_feat, device=dev),
                  torch.as_tensor(sup_pooled, device=dev))


def _load(path):
    return torch.export.load(path).module()


def load(out_dir, device=None) -> Predictor:
    return Predictor(out_dir, device)
