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
`dana_torch::nms_sorted`), so a program holds each as one call: on the
card it launches the kernel and counts the launch, on the CPU it runs the
plain version.  This module imports those ops and never the model code;
loading an artifact needs nothing else.

JAX's `platforms` becomes `device`: the device the artifact serves on, the
card unless the caller asks for the CPU.  An artifact can be traced on
another device (`trace_device`, e.g. on the CPU for the card); it is then
moved by torch.export's move-to-device pass, and the export raises if any
tensor of the program stays behind.  That pass moves the program's
constants with `.to`, so an export for the card needs the card on the
exporting host, whatever the trace device.  An int8 model is exported on
the device it serves on: its int8 products take each device's own branch
at trace time (layers.int8_matmul).  `s2d` is refused: the port has no
space-to-depth stem (utils/args.py `load_cfg`, TPU.STEM_S2D).

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
from torch.func import functional_call

# the ops the artifacts call, registered on import
from dana_tpu_torch.ops import cisa_attention, nms, roi_align  # noqa: F401
from dana_tpu_torch.utils.device import resolve_device, use_full_f32

BUCKETS = ((608, 1024), (1024, 608), (704, 704), (608, 1216), (1216, 608))
# the reason utils/args.py `load_cfg` gives for refusing TPU.STEM_S2D
S2D_REFUSED = ('the port has no space-to-depth stem (TPU.STEM_S2D, a TPU '
               'lane-tile layout of conv1); it serves the direct 7x7/2 conv '
               'on NHWC queries')


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


def _export(fn, params, args, path, target):
    """Trace `fn` with the weights as its first argument, move it to
    `target` if it was traced elsewhere, and save it without its example
    inputs (the weights among them).  -> its outputs' (shape, dtype)."""
    with torch.no_grad():
        ep = torch.export.export(_WeightsAsArguments(fn), (params, *args),
                                 strict=False)
    outs = [(v.shape, v.dtype) for v in torch.utils._pytree.tree_leaves(
        [n.meta.get('val') for n in ep.graph.find_nodes(op='output')[0]
         .args[0]])]
    if args[0].device != target:
        from torch.export.passes import move_to_device_pass
        ep = move_to_device_pass(ep, target)
        left = [k for k, t in ep.constants.items()
                if isinstance(t, torch.Tensor) and t.device != target]
        left += [n.name for n in ep.graph.nodes
                 for v in torch.utils._pytree.tree_leaves(n.meta.get('val'))
                 if isinstance(v, torch.Tensor) and v.device != target]
        if left:
            raise RuntimeError(
                f'the move-to-device pass left {left[:5]} of the program '
                f'traced for {args[0].device} off {target}: export on '
                f'{target} itself')
    ep.example_inputs = None
    torch.export.save(ep, path)
    return outs


def _indexed(device) -> torch.device:
    """The device, a card with its index (as its tensors report it)."""
    dev = resolve_device(device)
    if dev.type == 'cuda' and dev.index is None:
        return torch.device('cuda', torch.cuda.current_device())
    return dev


def _is_quantized(model) -> bool:
    from dana_tpu_torch.models import layers
    return any(isinstance(m, layers.QuantConv2d) for m in model.modules())


def export_predictor(params, config, out_dir, buckets=BUCKETS, batch_size=8,
                     sup_size=320, s2d=False, device='cuda',
                     trace_device=None, pp_kwargs=None):
    """Save the predict step for each (H, W) of `buckets` and the support
    encoder under `out_dir`; -> the meta dict (meta.json).

    params: the JAX package's param tree (numpy leaves; float or quantized
    by quant.quantize_params) or the built module (an int8 one from
    quant.quantize_model included); meta.json records whether it is
    quantized.  config: its DanaConfig (DAnA or cisa: the detectors that
    serve from encoded supports).  The artifacts serve on `device` (the
    card unless 'cpu' is asked for) and are traced on `trace_device`
    (default: `device`).  The predict step takes (params, im_data
    [batch_size, H, W, 3] float32 mean-subtracted, im_info [batch_size, 3],
    sup_feat, sup_pooled as the encoder gives them, one row per query) ->
    (dets [batch_size, 100, 5], valid [batch_size, 100]); the encoder takes
    (params, support images [1, n_way * n_shot, sup_size, sup_size, 3]
    float32 mean-subtracted) -> (feat, pooled).  `pp_kwargs` are the
    postprocess's keywords (utils.config.postprocess_kwargs; the built-in
    tree's when None)."""
    from dana_tpu_torch.models import dana
    from dana_tpu_torch.utils import config as cfg
    from dana_tpu_torch.utils.weights import from_jax_params
    if s2d:
        raise ValueError(f's2d export: {S2D_REFUSED}')
    if config.framework not in dana.CACHED_SUPPORTS:
        raise ValueError(f'{config.framework} takes each request\'s support '
                         'images: only DAnA and cisa serve from encoded '
                         'supports')
    if torch.device(device).type == 'cuda' \
            and not torch.cuda.is_available():
        raise RuntimeError(
            f'export for {device}: no card on this host, and the program '
            'is moved to its device with `.to` (torch.export\'s '
            'move-to-device pass), which needs one; export on a host with '
            'the card, or for device="cpu"')
    target = _indexed(device)
    here = _indexed(trace_device or device)
    model = params if isinstance(params, nn.Module) \
        else from_jax_params(params, config)
    quantized = _is_quantized(model)
    if quantized and here != target:
        raise ValueError(
            f'an int8 model is exported on the device it serves on '
            f'({target}), not traced on {here}: its int8 products take '
            'each device\'s own branch at trace time')
    if target.type == 'cuda':
        use_full_f32()
    # the trace reads only these tensors (functional_call): the caller's
    # module stays where it is
    state = {k: v.detach().to(here) for k, v in model.state_dict().items()}
    pp_kwargs = dict(cfg.postprocess_kwargs() if pp_kwargs is None
                     else pp_kwargs)
    os.makedirs(out_dir, exist_ok=True)
    b, n_sup = batch_size, config.n_way * config.n_shot

    sup = torch.zeros(1, n_sup, sup_size, sup_size, 3, device=here)
    (feat, fdt), (pooled, pdt) = _export(
        _Encode(model, config), state, (sup,),
        os.path.join(out_dir, 'encode_supports.pt2'), target)
    sup_feat = torch.zeros(b, *feat[1:], dtype=fdt, device=here)
    sup_pooled = torch.zeros(b, *pooled[1:], dtype=pdt, device=here)

    predict = _Predict(model, config, pp_kwargs)
    table = []
    for h, w in buckets:
        im = torch.zeros(b, h, w, 3, device=here)
        info = torch.tensor([[h, w, 1.0]] * b, device=here)
        name = f'predict_{h}x{w}.pt2'
        _export(predict, state, (im, info, sup_feat, sup_pooled),
                os.path.join(out_dir, name), target)
        table.append({'bucket': [h, w], 'file': name})

    meta = {
        'batch_size': b, 'n_way': config.n_way, 'n_shot': config.n_shot,
        'arch': config.arch, 's2d': False, 'sup_size': sup_size,
        'buckets': table, 'postprocess': pp_kwargs, 'quantized': quantized,
        'device': str(target), 'framework': config.framework,
        'weights': list(state),
    }
    with open(os.path.join(out_dir, 'meta.json'), 'w') as f:
        json.dump(meta, f, indent=1)
    _zero_trace_counters()
    return meta


def _zero_trace_counters():
    """Python counters that a trace bumps once (the int8 work's) count no
    run: zero them after an export."""
    from dana_tpu_torch.models import layers
    layers.dynamic_int8_conv.runs = 0
    layers.int8_matmul.launches = 0
    roi_align.roi_align_int8.runs = 0


class Predictor:
    """The deserialized serving bundle: picks the artifact for a bucket and
    calls it.  `encode(params, sup_ims)` -> (feat, pooled) support
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
        fn = self._predict[(im_data.shape[1], im_data.shape[2])]
        dev = self.device
        return fn(self.weights(params), torch.as_tensor(im_data, device=dev),
                  torch.as_tensor(im_info, device=dev),
                  torch.as_tensor(sup_feat, device=dev),
                  torch.as_tensor(sup_pooled, device=dev))


def _load(path):
    return torch.export.load(path).module()


def load(out_dir, device=None) -> Predictor:
    return Predictor(out_dir, device)
