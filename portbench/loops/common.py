"""What the serving and the training loops share: the program's detector
built on the device with the benchmark's weights, the traced stretch, and
the per-layer metrics read from it."""

from __future__ import annotations

import dataclasses
import importlib
import os
import tempfile

import torch

from portbench import harness, tracing
from portbench.reference import detector as RD


def reference_module(cfg):
    """reference/<framework>.py of the configuration."""
    name = {'DAnA': 'dana', 'fsod': 'fsod'}[cfg['model']['framework']]
    return importlib.import_module(f'portbench.reference.{name}')


def weights(cfg, seed, device):
    """The detector's weights from the seed (the reference's spec: the
    benchmark makes them and hands the same to both sides)."""
    return RD.make_weights(reference_module(cfg).spec(cfg), seed, device)


def dana_config(cfg):
    """The program's DanaConfig of the configuration's `model` settings."""
    from dana_tpu_torch.models import dana
    fields = {f.name for f in dataclasses.fields(dana.DanaConfig)}
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in cfg['model'].items() if k in fields}
    if cfg['model']['precision'] != 'float32':
        raise ValueError('only float32 configurations are defined')
    return dana.DanaConfig(**kw)


def build_program(cfg, seed, device):
    """The program's detector module on `device`, loaded with the seed's
    weights (strictly: every name and shape must match the reference's)."""
    from dana_tpu_torch.models import frameworks
    config = dana_config(cfg)
    with torch.device(device):
        model = frameworks.build(config)
    model.load_state_dict(weights(cfg, seed, device), strict=True)
    return model, config


def build_kernels(device):
    """Build every hand kernel of the program before the first call (the
    first run of a checkout compiles here; later runs find them built)."""
    if device.type == 'cuda':
        from dana_tpu_torch.ops import build
        build.build_all()


def sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Run:
    """What a run hands its per-layer metric readers."""
    kind: str
    cfg: dict
    traffic: dict
    device: torch.device
    host_ms: list            # the entry call's host ms, per request / step
    service_s: list          # per request / step, start of work to done
    peak_bytes: int
    trace: tracing.Trace | None = None


class Profiled:
    """The traced stretch: `units` requests or steps starting at unit
    `start` of the window run under torch.profiler; each unit's service is
    wrapped in the `bench.request` / `bench.step` range by the loop.  The
    trace goes to a temporary file (under TMPDIR), which is read and
    removed."""

    def __init__(self, enabled, start, units, device):
        self.enabled, self.start, self.units = enabled, start, units
        self.device = device
        self.prof = None
        self.trace = None

    def __enter__(self):
        if not self.enabled:
            return self
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == 'cuda':
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        sched = torch.profiler.schedule(wait=max(self.start - 1, 0),
                                        warmup=1 if self.start else 0,
                                        active=self.units, repeat=1)
        self.prof = torch.profiler.profile(activities=acts, schedule=sched,
                                           on_trace_ready=self._ready)
        self.prof.__enter__()
        return self

    def step(self):
        if self.prof is not None:
            self.prof.step()

    def _ready(self, prof):
        fd, path = tempfile.mkstemp(suffix='.json')
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            self.trace = tracing.Trace(path)
        finally:
            os.remove(path)

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False


def per_layer_metrics(cell_name, run):
    """{metric: {value, unit}} of the cell's per-layer metrics that find
    something to read in `run`."""
    entries = harness.per_layer(cell_name)
    readers = harness.metric_readers([m['name'] for m in entries])
    out = {}
    for m in entries:
        v = readers[m['name']](run)
        if v is not None:
            out[m['name']] = {'value': float(v), 'unit': m['unit']}
    return out


def breakdown(trace):
    if trace is None or not trace.device:
        return None
    return {'device_ops': trace.top_device_ops(),
            'idle_gaps': trace.longest_gaps()}


def trace_device(trace):
    """The traced stretch's busy and window seconds (a card's device
    entry)."""
    return {'busy_s': trace.busy_s(), 'window_s': trace.window_s()}


def free(device):
    import gc
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()
