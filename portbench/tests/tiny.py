"""A cell of BENCHMARK.json at a size the CPU runs in seconds: the same
files, with the canvas, the proposal counts, the batch and the window cut
(the widths stay)."""

import copy
import time

import torch

from portbench import harness
from portbench.run import Context


def tiny(workload, seconds=0.5, trace=False, seed=123456789012,
         device='cpu', **kw):
    cell, cfg, traffic = harness.workload(workload)
    cfg, traffic = copy.deepcopy(cfg), copy.deepcopy(traffic)
    cfg['canvas'] = [256, 320]
    cfg['model'].update(test_pre_nms=600, test_post_nms=40,
                        train_pre_nms=600, train_post_nms=80,
                        rois_per_image=16)
    traffic.update(batch=2, pool=3, trace_start=1, trace_units=2)
    if traffic['kind'] == 'serve':
        traffic.update(rate_per_s=4.0, warmup=1, checked=1)
    return Context(cell, cfg, traffic, seed, seconds, trace,
                   torch.device(device), time.perf_counter(), **kw)
