"""The numbers that decide `correct`: what the program's timed path
produced against the plain reference (reference/), each number with its
own limit (limits/<workload>.json).

Maps and head outputs are compared by the relative gap of their norms'
difference, ||program - reference|| / ||reference||, over the whole
tensor: steady from seed to seed, where a maximum over millions of
entries is not.  Proposals and detections are compared as sets: the
share of boxes with no partner in the other side within a tolerance,
since a rounding difference may reorder near-equal scores.

Training follows the contract's measures: each of the first three
steps' losses; the first gradient as the optimizer got it and the
parameters' change after three steps, each by the worst leaf, as the gap
between the two sides' norms of that leaf over the larger of the
reference's norm of it and of the median leaf.  The reference takes the
program's proposals (12000 near-equal scores make NMS keep other boxes on
any rounding difference), so the proposal stage is checked by itself:
the RPN outputs that enter it (rpn_gap) and the reference's proposal
layer replayed on the program's own RPN outputs, which must give the
program's proposals exactly (proposal_exact).
"""

from __future__ import annotations


# px: a proposal has a partner when every coordinate lies this close
# (float32 runs move proposals by ~1e-4 px at most; TF32 by ~1e-2)
BOX_TOL = 2e-3
# px and score: a detection has a partner within these (float32 runs
# move detections by ~1e-5 px and ~1e-7 in score, TF32 by ~1e-3 px and
# ~1e-4)
DET_BOX_TOL = 1e-4
DET_SCORE_TOL = 2e-6
# the change comparison leaves out leaves whose reference gradient is
# under this share of the median leaf's: they move by round-off alone
ROUNDOFF_SHARE = 1e-3

SERVE_NUMBERS = ('feat_gap', 'support_gap', 'attn_gap', 'rpn_gap',
                 'proposal_miss', 'pooled_gap', 'head_gap', 'det_miss')
TRAIN_NUMBERS = ('loss_gap', 'grad_gap', 'change_gap', 'rpn_gap',
                 'proposal_exact')


def rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


def unmatched_share(a, b, tol, score_tol=None):
    """Symmetric set comparison of two lists of boxes [N, 4] (with a score
    column when score_tol is given): (boxes of a with no partner in b +
    those of b with none in a) / (N_a + N_b)."""
    a, b = a.double().cpu(), b.double().cpu()
    if len(a) + len(b) == 0:
        return 0.0
    if not len(a) or not len(b):
        return 1.0
    close = ((a[:, None, :4] - b[None, :, :4]).abs() <= tol).all(-1)
    if score_tol is not None:
        close &= (a[:, None, 4] - b[None, :, 4]).abs() <= score_tol
    miss = (~close.any(1)).sum() + (~close.any(0)).sum()
    return miss.item() / (len(a) + len(b))


def proposal_miss(prog_rois, prog_mask, own_rois, own_mask):
    """Worst image's unmatched share of the valid proposals."""
    return max(unmatched_share(prog_rois[i, prog_mask[i].bool(), 1:],
                               own_rois[i, own_mask[i].bool(), 1:], BOX_TOL)
               for i in range(prog_rois.shape[0]))


def det_miss(dets, valid, ref_dets, ref_valid):
    return max(unmatched_share(dets[i, valid[i].bool()],
                               ref_dets[i, ref_valid[i].bool()],
                               DET_BOX_TOL, DET_SCORE_TOL)
               for i in range(dets.shape[0]))


def serve_numbers(prog, ref, support_pairs):
    """prog: the program's record of a request (recorder.py stages, dets,
    valid); ref: the reference's record on the program's rois, with its own
    proposals in own_rois / own_mask; support_pairs: [(program,
    reference)] support features.  -> {number: value}."""
    mask = prog['mask'].bool()
    own = follow = ref
    return {
        'feat_gap': rel(prog['feat'], own['feat']),
        'support_gap': max(rel(p, r) for p, r in support_pairs),
        'attn_gap': rel(prog['attn'], own['attn']),
        'rpn_gap': max(rel(prog['probs'], own['probs']),
                       rel(prog['deltas'], own['deltas'])),
        'proposal_miss': proposal_miss(prog['rois'], prog['mask'],
                                       own['own_rois'], own['own_mask']),
        'pooled_gap': rel(prog['pooled'], follow['pooled']),
        'head_gap': max(rel(prog['cls_prob'][mask],
                            follow['cls_prob'].cpu()[mask]),
                        rel(prog['bbox_pred'][mask],
                            follow['bbox_pred'].cpu()[mask])),
        'det_miss': det_miss(prog['dets'], prog['valid'], follow['dets'],
                             follow['valid']),
    }


def leaf_gaps(prog, ref):
    """{leaf: |norm(prog) - norm(ref)| / max(norm(ref), the median leaf's
    norm(ref))} over the leaves of `ref` ({name: tensor})."""
    norms = {k: v.double().norm().item() for k, v in ref.items()}
    med = _median(list(norms.values()))
    return {k: abs(prog[k].double().norm().item() - n) / max(n, med, 1e-30)
            for k, n in norms.items()}


def _median(values):
    return sorted(values)[len(values) // 2]


def train_numbers(prog, ref):
    """prog / ref: {'losses': [per step {name: float}], 'grad': {leaf:
    tensor} (step 1, as the optimizer got it), 'change': {leaf: tensor}
    (after three steps), 'rpn': [per step (probs, deltas)], 'rois': [per
    step (rois, mask)]}; ref also has 'replayed': its proposal layer alone
    on the program's RPN outputs.  -> {number: value}."""
    loss_gap = max(abs(p[k] - r[k]) / max(abs(sum(r.values())), 1e-30)
                   for p, r in zip(prog['losses'], ref['losses']) for k in r)
    gnorm = {k: v.double().norm().item() for k, v in ref['grad'].items()}
    moved = {k for k, n in gnorm.items()
             if n >= ROUNDOFF_SHARE * _median(list(gnorm.values()))}
    grad = leaf_gaps(prog['grad'], ref['grad'])
    change = leaf_gaps(prog['change'], {k: v for k, v in ref['change'].items()
                                        if k in moved})
    return {
        'loss_gap': loss_gap,
        'grad_gap': max(grad.values()),
        'change_gap': max(change.values()),
        'rpn_gap': max(max(rel(pp, rp[:len(pp)]), rel(pd, rd[:len(pd)]))
                       for (pp, pd), (rp, rd) in zip(prog['rpn'], ref['rpn'])),
        'proposal_exact': max(slot_mismatch(pr, pm, rr, rm)
                              for (pr, pm), (rr, rm)
                              in zip(prog['rois'], ref['replayed'])),
    }


def train_details(prog, ref):
    """What the look at a training run's readings needs: the worst and the
    median leaf of the first gradient's and of the change's gaps, and per
    step how many rois the hard-mined loss picks on one side and not the
    other (its picks rank near-equal scores)."""
    from portbench.reference.detector import hard_mined_picks
    out = {}
    for key in ('grad', 'change'):
        gaps = leaf_gaps(prog[key], ref[key])
        out[key + '_worst_leaf'] = max(gaps, key=gaps.get)
        out[key + '_gap_median'] = _median(list(gaps.values()))
    flips = []
    for pm, rm in zip(prog.get('mining', ()), ref.get('mining', ())):
        pb, pn = hard_mined_picks(pm[0], pm[2], pm[1])
        rb, rn = hard_mined_picks(rm[0], rm[2], rm[1])
        if pb.numel() == rb.numel():
            flips.append(int((pb != rb).sum() + (pn != rn).sum()))
    out['pick_flips'] = flips
    return out


def slot_mismatch(rois, mask, ref_rois, ref_mask):
    """Worst image's share of proposal slots whose box or validity is not
    exactly the reference's."""
    diff = (rois != ref_rois).any(-1) | (mask.bool() != ref_mask.bool())
    return diff.double().mean(-1).max().item()
