"""The training traffic: `Trainer.step` on episodes back to back, and the
comparison of its first three steps with the reference.

Traffic file keys (traffic/<mix>.json, kind "train"):
  batch         episodes a step: a uint8 BGR query on the configuration's
                canvas with gt_per_image boxes of its class (max_gt slots,
                zero rows pad) and n_way x n_shot mean-subtracted supports
                of support_px, the first n_shot positive
  gt_per_image  [least, most] gt boxes a query, drawn from the seed
  max_gt        gt slots a query
  pool          distinct steps' episodes and target-layer draws made from
                the seed at set-up and cycled (the first `checked` all
                differ)
  checked       the first steps, run in set-up through the window's own
                call and feed, that the reference follows
  trace_start, trace_units    the traced stretch of a --trace 1 run

The step takes its uniform draws from the pool (`step(batch, draws=...)`),
so the reference samples the same anchors and rois.
"""

from __future__ import annotations

import time

import torch

from portbench import harness, judge
from portbench.loops import common
from portbench.recorder import Recorder
from portbench.reference import detector as RD


def make_inputs(cfg, traffic, seed, device):
    """Host episodes and draws from the seed: [(batch dict, draws dict)] of
    numpy arrays."""
    m = cfg['model']
    b, (h, w), p = traffic['batch'], cfg['canvas'], cfg['support_px']
    g, (lo, hi) = traffic['max_gt'], traffic['gt_per_image']
    from portbench.work.conv import map_size
    fh, fw = map_size(h, w)
    n = fh * fw * len(m['anchor_scales']) * len(m['anchor_ratios'])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    means = torch.tensor(m['pixel_means'], device=device)
    size = torch.tensor([w, h], device=device, dtype=torch.float32)

    def u(*shape):
        return torch.rand(shape, generator=gen, device=device)
    pool = []
    for _ in range(traffic['pool']):
        wh = u(b, g, 2) * (size * 0.5 - 32) + 32
        xy = u(b, g, 2) * (size - wh)
        filled = torch.arange(g, device=device)[None] < torch.randint(
            lo, hi + 1, (b, 1), generator=gen, device=device)
        gt = torch.cat([xy, xy + wh - 1, torch.ones(b, g, 1, device=device)],
                       -1)
        batch = dict(
            im_data=torch.randint(0, 256, (b, h, w, 3), generator=gen,
                                  device=device, dtype=torch.uint8),
            im_info=torch.tensor([[h, w, 1.0]] * b, device=device),
            gt_boxes=torch.where(filled[..., None], gt, 0.0),
            support_ims=torch.randint(
                0, 256, (b, m['n_way'] * m['n_shot'], p, p, 3), generator=gen,
                device=device).float() - means)
        draws = dict(anchor_fg=u(b, n), anchor_bg=u(b, n),
                     roi_fg_rank=u(b, m['train_post_nms'] + g),
                     roi_fg=u(b, m['rois_per_image']),
                     roi_bg=u(b, m['rois_per_image']))
        pool.append(({k: v.cpu().numpy() for k, v in batch.items()},
                     {k: v.cpu().numpy() for k, v in draws.items()}))
    return pool


def run(ctx):
    from dana_tpu_torch.engine.train import LOSSES, Trainer
    cfg, traffic, dev = ctx.cfg, ctx.traffic, ctx.device
    opt = cfg['optimizer']
    common.build_kernels(dev)
    ctx.mark('kernels')
    model, config = common.build_program(cfg, ctx.seed, dev)
    trainer = Trainer(model, config, device=dev, lr=opt['lr'],
                      momentum=opt['momentum'],
                      weight_decay=opt['weight_decay'],
                      double_bias=opt['double_bias'],
                      bias_decay=opt['bias_decay'],
                      fixed_blocks=cfg['fixed_blocks'])
    step = ctx.step_fault(trainer)
    ctx.mark('model')
    pool = make_inputs(cfg, traffic, ctx.seed, dev)
    ctx.mark('inputs')
    n_checked = traffic['checked']
    w0 = common.weights(cfg, ctx.seed, dev)
    names = {p: n for n, p in trainer.model.named_parameters()}
    prog = {'losses': [], 'rois': [], 'rpn': [], 'mining': []}
    with Recorder(dev, stages=('rois', 'mask', 'probs', 'deltas',
                               'mining')) as rec:
        rec.allocate(n_checked)
        for s in range(n_checked):
            rec.arm(s)
            out = step(*pool[s])
            rec.disarm()
            prog['losses'].append({k: float(out[k]) for k in LOSSES})
            buf = rec.buffers[s]
            prog['rois'].append((buf['rois'], buf['mask']))
            prog['rpn'].append((buf['probs'], buf['deltas']))
            prog['mining'].append(buf['mining'])
            if s == 0:
                prog['grad'] = first_gradient(trainer, names, w0, opt)
    prog['change'] = {names[p]: (p.detach() - w0[names[p]]).cpu()
                      for p in trainer.params}
    del w0
    ctx.mark('checked steps')
    host_ms, service = [], []
    failed = 0
    i = n_checked
    with common.Profiled(ctx.trace, traffic['trace_start'],
                         traffic['trace_units'], dev) as prof:
        if dev.type == 'cuda':
            torch.cuda.reset_peak_memory_stats(dev)
        ctx.setup_s = time.perf_counter() - ctx.t0
        start = time.perf_counter()
        while time.perf_counter() - start < ctx.seconds:
            try:
                with torch.profiler.record_function('bench.step'):
                    t0 = time.perf_counter()
                    out = step(*pool[i % len(pool)])
                    t1 = time.perf_counter()
                    failed += int(out['skipped'])
                host_ms.append((t1 - t0) * 1e3)
                service.append(time.perf_counter() - t0)
            except RuntimeError as err:
                failed += 1
                print(f'step {i} failed: {err}', flush=True)
            i += 1
            prof.step()
        common.sync(dev)
        end = time.perf_counter()
    steps = i - n_checked
    peak = harness.device_info(torch, dev, 1)['memory_peak_bytes']
    window = end - start
    metrics = {'train_eps_per_s': {
        'value': traffic['batch'] * (steps - failed) / window,
        'unit': 'episodes/s'}}
    run_view = common.Run('train', cfg, traffic, dev, host_ms, service, peak,
                          prof.trace)
    del trainer, model, step
    common.free(dev)
    ref = reference_steps(cfg, ctx.seed, dev, pool[:n_checked],
                          follow=prog['rois'], replay=prog['rpn'])
    numbers = judge.train_numbers(prog, ref)
    return dict(attempted=steps, failed=failed, metrics=metrics,
                run=run_view, numbers=numbers,
                details=judge.train_details(prog, ref))


def first_gradient(trainer, names, w0, opt):
    """The first step's gradient as the optimizer got it, from its state
    after that step: the momentum buffer less the weight decay term
    (biases take none); no buffer, no gradient."""
    out = {}
    for p in trainer.params:
        n = names[p]
        buf = trainer.optimizer.state.get(p, {}).get('momentum_buffer')
        if buf is None:
            out[n] = torch.zeros_like(p, device='cpu')
            continue
        decay = 0.0 if n.endswith('bias') and not opt['bias_decay'] \
            else opt['weight_decay']
        out[n] = (buf - decay * w0[n]).cpu()
    return out


def reference_steps(cfg, seed, device, episodes, follow=None, replay=None,
                    tf32=False, rows=None):
    """The reference's first steps on `episodes` ([(batch, draws)] of host
    arrays) from the seed's weights -> each step's losses, the first
    gradient, the change after the last step, and per step its own
    proposals (`rois`) and RPN outputs (`rpn`).  `follow` (per step
    (rois, mask)): the proposals the later stages take; `replay` (per step
    (probs, deltas)): the proposal layer is also run on these, alone
    (`replayed`); `tf32`: TF32 on, the control; `rows`: that many episodes
    of each batch kept (a fault: the rest of the batch left out)."""
    from portbench.loops.serve import tf32_mode
    ref = common.reference_module(cfg)
    opt = cfg['optimizer']
    w0 = common.weights(cfg, seed, device)
    w = dict(w0)
    train = [k for k in w if RD.trainable(k)]
    velocity = {}
    out = {'losses': [], 'rois': [], 'rpn': [], 'replayed': [],
           'mining': []}
    for s, (batch, draws) in enumerate(episodes):
        cut = slice(None, rows)
        bd = {k: torch.as_tensor(v, device=device)[cut]
              for k, v in batch.items()}
        dd = {k: torch.as_tensor(v, device=device)[cut]
              for k, v in draws.items()}
        leaves = {k: w[k].detach().requires_grad_(k in train) for k in w}
        fr = None if follow is None else follow[s][0].to(device)[cut]
        with tf32_mode(tf32):
            losses, extra = ref.train_losses(leaves, cfg, bd, dd,
                                             follow_rois=fr)
            grads = torch.autograd.grad(sum(losses.values()),
                                        [leaves[k] for k in train])
        grads = dict(zip(train, grads))
        out['losses'].append({k: float(v.detach())
                              for k, v in losses.items()})
        out['rois'].append((extra['own_rois'].cpu(),
                            extra['own_mask'].cpu()))
        out['rpn'].append((extra['probs'].cpu(), extra['deltas'].cpu()))
        out['mining'].append(extra['mining'].cpu())
        if replay is not None:
            probs, deltas = (t.to(device) for t in replay[s])
            rois, mask = ref.train_proposals(cfg, probs, deltas,
                                             bd['im_info'][:len(probs)],
                                             extra['map_hw'])
            out['replayed'].append((rois.cpu(), mask.cpu()))
        if s == 0:
            out['grad'] = {k: g.cpu() for k, g in grads.items()}
        with torch.no_grad():
            w = {k: v.detach() for k, v in w.items()}
            RD.sgd_step(w, grads, velocity, opt['lr'], opt['momentum'],
                        opt['weight_decay'])
        del leaves, grads, losses, extra
    out['change'] = {k: (w[k] - w0[k]).cpu() for k in train}
    return out
