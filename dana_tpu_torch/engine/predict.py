"""The serving entry point: a predictor that answers detection requests
(port of the JAX package's eval loop, inference.py `encode_supports` /
`predict`, and engine/train.py `predict_step`).  DAnA and cisa encode
each class's supports once and serve from that cache; FSOD, Meta R-CNN
and FGN take each request's support images and encode them with it, as
the JAX CLI does.  Faster R-CNN is refused: its class-specific deltas
[B, R, 8] meet the postprocess's 4 bbox stds, which the JAX package's
postprocess cannot broadcast either.

With a list of `devices` it serves on a (data, model) grid
(`parallel.make_mesh_2d(devices, model=max(tp, sp))`), as the JAX CLI's
--mGPUs, --tp and --sp do: each request's rows split over the data rows
of the grid; on each row, tensor parallelism splits the wide projections
and the RPN conv over the row's devices (`parallel.shard_params_tp`), or
spatial parallelism splits the queries' H over them through the trunk
(`parallel/spatial.py`), and the rest of the forward runs on the row's
first device; the detections are concatenated on the first device.  The
rows of a float model run one after another from this thread, so a
request over several cards takes longer than on one (the dataset CLI's
--dist runs one process per card instead).  An int8 model's rows run
together, a thread each: every quantized conv takes one activation scale,
the max over all rows' inputs (`layers.ScaleGroup`), as the JAX package's
conv forms it over the global batch."""

from __future__ import annotations

import copy
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn as nn
from torch.profiler import record_function

from dana_tpu_torch import parallel
from dana_tpu_torch.engine.postprocess import postprocess_batch
from dana_tpu_torch.models import dana, frameworks
from dana_tpu_torch.models import layers as L
from dana_tpu_torch.parallel.spatial import shard_trunk_spatial
from dana_tpu_torch.utils import config as cfg
from dana_tpu_torch.utils import trace
from dana_tpu_torch.utils.device import resolve_device, use_full_f32
from dana_tpu_torch.utils.weights import from_jax_params


class _Row:
    """One data row of the serving grid: its devices, the model replica
    on its first device (its wide layers split over the row under tp, its
    trunk over the row under sp) and its support cache."""

    def __init__(self, devices, model):
        self.devices, self.model = devices, model
        self.lead = devices[0]
        self.cache = {}


class Predictor:
    """Predictor(params, config, device='cuda', postprocess=None,
    devices=None, tp=1, sp=1).

    params: the JAX package's param tree (numpy leaves) of
    config.framework's detector, or its built module.  The device defaults
    to the card and the constructor raises without CUDA unless
    device='cpu' is passed; on the card float32 math runs without TF32
    (utils.device.use_full_f32).  The detector computes in the config's
    precision recipe (compute_dtype, attention_dt, head_dt); the support
    cache holds compute_dtype features, and the postprocess takes
    float32.
    `postprocess` is the detection postprocess's keywords
    (`utils.config.postprocess_kwargs` of the CLI's tree; the built-in
    tree's when None).
    `devices` (default [device]) with `tp` or `sp` > 1 serve on a grid
    (module docstring): one replica and one support cache per device,
    a request's B rows split over the grid's data rows (B % rows == 0).
    An int8 model (dana_tpu_torch/quant.py) serves on any grid: its data
    rows run in threads of a `layers.ScaleGroup` and its spatial blocks
    share one scale (`spatial.halo_int8_conv`), so each quantized conv
    takes the activation scale of the whole tensor, as the JAX package's
    does on its mesh.
    """

    def __init__(self, params, config: dana.DanaConfig, device='cuda',
                 postprocess=None, devices=None, tp=1, sp=1):
        devices = [resolve_device(d) for d in (devices or [device])]
        self.device = devices[0]
        if tp > 1 and sp > 1:
            raise ValueError('--tp and --sp both shard the mesh "model" '
                             'axis — pick one latency mode')
        if config.framework == 'frcnn':
            raise ValueError(
                'frcnn has no serving path: its class-specific deltas [B, R, '
                '8] meet the postprocess\'s 4 bbox stds, which the JAX '
                'package\'s postprocess (engine/postprocess.py:38) cannot '
                'broadcast either')
        if self.device.type == 'cuda':
            use_full_f32()
        model = params if isinstance(params, nn.Module) \
            else from_jax_params(params, config)
        self.int8 = any(isinstance(m, L.QuantConv2d)
                        for m in model.modules())
        self._row_threads = None
        self.config = config
        self.postprocess = postprocess or cfg.postprocess_kwargs()
        self.grid = parallel.make_mesh_2d(devices, model=max(tp, sp, 1))
        replicas = dict(zip(devices, parallel.replicate(model, devices)))
        self.rows = []
        for row in self.grid.devices:
            row = list(row)
            m = replicas[row[0]]
            if tp > 1:
                m = parallel.shard_params_tp(copy.deepcopy(m), row)
            if sp > 1:
                m = shard_trunk_spatial(copy.deepcopy(m), row,
                                        [replicas[d].backbone for d in row])
            self.rows.append(_Row(row, m))
        self.model = self.rows[0].model
        self._sup_cache = self.rows[0].cache

    @property
    def caches_supports(self):
        """True for DAnA and cisa (encode_supports, then predict by
        class); False for the siblings (predict with support_ims)."""
        return self.config.framework in dana.CACHED_SUPPORTS

    @torch.inference_mode()
    def encode_supports(self, cls, support_ims):
        """Encode one class's supports [n_shot, H, W, 3] (float, mean-
        subtracted; or their space-to-depth packing [n_shot, H/2+3,
        W/2+3, 12], data/blob.py `s2d_pack`) once and cache them under
        `cls` (DAnA and cisa)."""
        if not self.caches_supports:
            raise ValueError(f'{self.config.framework} keeps no support '
                             'cache: pass each request\'s support_ims')
        for row in self.rows:
            ims = torch.as_tensor(support_ims, device=row.lead)[None]
            row.cache[int(cls)] = dana.extract_support_feats(
                row.model, self.config, ims)
        return self._sup_cache[int(cls)]

    def has_supports(self, cls):
        return int(cls) in self._sup_cache

    def batch_support_feats(self, classes, cache=None):
        """Cached (feat [B,n,h,w,C], pooled [B,n,7,7,C]) for the query
        batch's target classes (from the first data row's cache, or
        `cache`)."""
        cache = self._sup_cache if cache is None else cache
        fs = [cache[int(c)] for c in classes]
        return (torch.cat([f[0] for f in fs]), torch.cat([f[1] for f in fs]))

    @torch.inference_mode()
    def predict(self, im_data, im_info, classes=None, support_ims=None):
        """im_data [B,H,W,3] uint8 BGR or float mean-subtracted (on a
        ResNet trunk also their space-to-depth packing [B, H/2+3, W/2+3,
        12], the stem's other input; not under sp), im_info [B,3] (height,
        width, scale of the canvas), and for DAnA and cisa classes [B]
        whose supports were encoded, for the siblings support_ims [B,
        n_shot, H, W, 3] float mean-subtracted (or packed) -> (dets
        [B,100,5], valid [B,100]) on the device.  Host arrays or tensors;
        a tensor in pinned memory is copied without blocking the host.  On
        a grid the rows split over its data rows and the detections come
        back on the first device.  One unit of utils/trace.py: the range
        `dana.entry.predict` and a record of the request."""
        with trace.unit('predict'):
            if len(self.rows) == 1:
                return self._predict_row(self.rows[0], im_data, im_info,
                                         classes, support_ims)
            outs = self._each_row(self._predict_row, im_data, im_info,
                                  classes, support_ims)
            return tuple(torch.cat([o[j].to(self.device) for o in outs])
                         for j in range(2))

    @torch.inference_mode()
    def forward(self, im_data, im_info, classes=None, support_ims=None):
        """The detector's eval outputs before the postprocess (rois,
        cls_prob, bbox_pred, cls_score, roi_mask), taken as `predict`
        takes its request and gathered on the first device; each roi's
        batch index is its row in the request."""
        outs = self._each_row(lambda *a: self._forward_row(*a)[0], im_data,
                              im_info, classes, support_ims)
        per = len(im_data) // len(self.rows)
        for i, out in enumerate(outs):
            out['rois'] = out['rois'].clone()
            out['rois'][..., 0] += i * per
        return {k: torch.cat([o[k].to(self.device) for o in outs])
                for k in outs[0]}

    def _each_row(self, fn, *request):
        """fn(row, *its slice of the request) for every data row -> the
        results in row order.  A float model's rows run one after another;
        an int8 model's run together, a thread each in one
        `layers.ScaleGroup`, so that each quantized conv takes the max over
        every row's input."""
        parts = list(self._split(*request))
        if not self.int8 or len(parts) == 1:
            return [fn(row, *args) for row, args in parts]
        group = L.ScaleGroup(len(parts), self.device)

        def run(i, row, args):
            with torch.inference_mode(), group.join(i):
                return fn(row, *args)
        if self._row_threads is None:
            # kept for the predictor's life: a fresh thread per request
            # would set up the CPU's per-thread conv state again each time
            self._row_threads = ThreadPoolExecutor(
                len(parts), thread_name_prefix='dana-row')
        futures = [self._row_threads.submit(run, i, row, args)
                   for i, (row, args) in enumerate(parts)]
        return [f.result() for f in futures]

    def _split(self, im_data, im_info, classes, support_ims):
        """(row, its slice of the request) for every data row."""
        b, n = len(im_data), len(self.rows)
        if b % n:
            raise ValueError(f'a request of {b} rows does not split over '
                             f'the {n} data rows of the grid')
        for i, row in enumerate(self.rows):
            rs = slice(i * b // n, (i + 1) * b // n)
            yield row, (im_data[rs], im_info[rs],
                        None if classes is None else classes[rs],
                        None if support_ims is None else support_ims[rs])

    def _forward_row(self, row, im_data, im_info, classes, support_ims):
        with record_function('dana.upload'):
            im_data = trace.upload(im_data, row.lead, non_blocking=True)
            im_info = trace.upload(im_info, row.lead,
                                   non_blocking=True).float()
            if self.caches_supports:
                kw = dict(support_feats=self.batch_support_feats(
                    classes, row.cache))
            else:
                kw = dict(support_ims=trace.upload(
                    support_ims, row.lead, non_blocking=True).float())
        out = frameworks.forward(row.model, self.config, im_data, im_info,
                                 **kw)
        return out, im_info

    def _predict_row(self, row, im_data, im_info, classes, support_ims):
        out, im_info = self._forward_row(row, im_data, im_info, classes,
                                         support_ims)
        with record_function('dana.postprocess'):
            return postprocess_batch(
                out['rois'], out['cls_prob'].float(),
                out['bbox_pred'].float(), im_info,
                bbox_stds=self.config.bbox_normalize_stds,
                bbox_means=self.config.bbox_normalize_means,
                **self.postprocess)
