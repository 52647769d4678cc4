"""The readings that set a cell's limits, besides the program's own: the
control (the reference put in the program's place, computed in TF32, the
precision below the configuration's float32 with TF32 off) and, for a
training cell, the fault of half the batch left out (the step's means
taken over the rest), each judged exactly as the program is.

A state left unchanged reads 1 on change_gap by construction (the
program's change is 0) and needs no run.  `altered_proposals` plants an
answer altered where it is produced (a proposal box) in the program
itself."""

from __future__ import annotations

import contextlib

import torch

from portbench import judge
from portbench.loops import serve, train


def serve_control(ctx, requests=2):
    """Worst numbers over `requests` of the seed's pool, the TF32
    reference's records judged against the float32 reference on their
    rois."""
    pool, sup, info, _ = serve.make_inputs(ctx.cfg, ctx.traffic, ctx.seed,
                                           ctx.device)
    worst = {k: 0.0 for k in judge.SERVE_NUMBERS}
    for q, cls, ims in pool[:requests]:
        ctl = serve.reference_record(ctx, sup, info, q, cls, ims, tf32=True)
        prog = {k: (v.cpu() if torch.is_tensor(v) else v)
                for k, v in ctl.items() if k != 'support'}
        cached = ctx.cfg['model']['framework'] in ('DAnA', 'cisa')
        if cached:
            program_support = {c: tuple(t.cpu() for t in fp)
                               for c, fp in ctl['support'].items()}
        else:
            prog['support'] = ctl['support'].cpu()
            program_support = None
        nums = serve.judge_request(ctx, prog, sup, info, q, cls, ims,
                                   program_support)
        worst = {k: max(worst[k], v) for k, v in nums.items()}
    return worst


def train_control(ctx):
    pool = train.make_inputs(ctx.cfg, ctx.traffic, ctx.seed, ctx.device)
    episodes = pool[:ctx.traffic['checked']]
    ctl = train.reference_steps(ctx.cfg, ctx.seed, ctx.device, episodes,
                                tf32=True)
    ref = train.reference_steps(ctx.cfg, ctx.seed, ctx.device, episodes,
                                follow=ctl['rois'], replay=ctl['rpn'])
    return judge.train_numbers(ctl, ref)


def train_half_batch(ctx):
    pool = train.make_inputs(ctx.cfg, ctx.traffic, ctx.seed, ctx.device)
    episodes = pool[:ctx.traffic['checked']]
    half = train.reference_steps(ctx.cfg, ctx.seed, ctx.device, episodes,
                                 rows=ctx.traffic['batch'] // 2)
    ref = train.reference_steps(ctx.cfg, ctx.seed, ctx.device, episodes,
                                replay=half['rpn'])
    return judge.train_numbers(half, ref)


@contextlib.contextmanager
def plain_attention():
    """A second witness for the look at a training seed: the program with
    its CISA kernel (K1, 3xTF32 on the tensor cores) replaced by the
    program's own plain float32 version."""
    from dana_tpu_torch.models import dana
    from dana_tpu_torch.ops.cisa_attention import cisa_attention_shots_plain
    real = dana.cisa_attention_shots
    dana.cisa_attention_shots = cisa_attention_shots_plain
    try:
        yield
    finally:
        dana.cisa_attention_shots = real


@contextlib.contextmanager
def altered_proposals():
    """A fault planted in the program: the proposal layer's first box of
    each call moved by one pixel where it is produced."""
    from dana_tpu_torch.models import rpn
    real = rpn.proposal_layer

    def layer(*args, **kwargs):
        rois, scores, mask = real(*args, **kwargs)
        rois = rois.clone()
        rois[0, 0, 1:] += 1.0
        return rois, scores, mask
    rpn.proposal_layer = layer
    try:
        yield
    finally:
        rpn.proposal_layer = real
