"""Detection losses of the training step (port of the JAX package's
models/losses.py): the smooth-L1 box loss, the RPN's masked
cross-entropy and the 1:2:1 hard-mined pair cross-entropy of the R-CNN
head.

Each loss computes in float32 whatever the dtype of its predictions, as
every call site of the JAX package casts the logits, deltas and scores to
float32 before its loss (the precision recipe's bf16 heads); the gradient
flows back through that cast.

Ranks come from stable sorts, as `jnp.argsort` sorts: under saturated
random-init scores many probabilities tie exactly, and an unstable sort
would mine other background rois.

Under data parallelism (parallel/distributed.py `BatchGroup`, the group
the step entered) the two losses whose denominators or picks couple the
images see the global batch: the masked cross-entropy divides by the
global count, the hard mining ranks and counts over every rank's rois;
each returns its local numerator times W over the global count, so the
mean over the W ranks is the global batch's loss.  The smooth-L1 losses
are means over equal rows per rank and need nothing.  On one process the
group is the identity and nothing changes.
"""

from __future__ import annotations

import torch

from dana_tpu_torch.parallel.distributed import current_group


def smooth_l1_loss(pred, targets, inside_w, outside_w, sigma=1.0,
                   reduce_dims=None):
    """Huber loss with the py-faster-rcnn sigma transition.

    inside_w / outside_w broadcast against pred.  `reduce_dims` are
    summed (default: every axis but the first); the first is meaned."""
    sigma2 = sigma * sigma
    pred = pred.float()
    diff = inside_w * (pred - targets)
    adiff = diff.abs()
    flag = (adiff < 1.0 / sigma2).to(pred.dtype)
    loss = flag * 0.5 * sigma2 * diff * diff + \
        (1.0 - flag) * (adiff - 0.5 / sigma2)
    loss = outside_w * loss
    if reduce_dims is None:
        reduce_dims = tuple(range(1, loss.dim()))
    return loss.sum(dim=reduce_dims).mean()


def masked_cross_entropy(logits, labels, mask):
    """Mean cross-entropy over the mask-selected entries, flattened across
    the batch.  logits [..., K], labels [...] (negative labels read class
    0 and must be masked out), mask [...]."""
    logits = logits.float()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
    m = mask.to(logits.dtype)
    g = current_group()
    if not g.distributed:
        return (nll * m).sum() / m.sum().clamp(min=1.0)
    return (nll * m).sum() * g.size / g.all_sum(m.sum()).clamp(min=1.0)


def _desc_rank(x):
    """Rank (0 = largest) of each element along the last axis; equal
    values keep index order."""
    order = torch.argsort(-x, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True)


def hard_mined_pair_ce(cls_logits, labels, neg_logits):
    """The episodic frameworks' 1:2:1 hard-mining loss, over the whole
    flattened batch of M rois:
      * every fg roi of the positive branch contributes CE(label 1);
      * the clamp(2*n_fg, 1, M/2) highest-fg-prob bg rois of the positive
        branch contribute CE(label 0);
      * the clamp(n_fg, 1, that) highest-fg-prob rois of the negative-
        support branch contribute CE(label 0);
    mean over the selected rois.

    cls_logits [B,S,2] positive branch, labels [B,S] in {0,1}, neg_logits
    [B,S,2] negative branch (all labelled 0).  Across ranks the batch is
    every rank's rows in rank order: the picks are formed from the
    gathered probabilities and labels, and this rank keeps its own."""
    m = labels.numel()
    logits = cls_logits.float().reshape(m, 2)
    neg = neg_logits.float().reshape(m, 2)
    fg = labels.reshape(m) > 0
    g = current_group()

    with torch.no_grad():
        fg_prob = torch.softmax(logits, dim=-1)[:, 1]
        neg_prob = torch.softmax(neg, dim=-1)[:, 1]
        all_fg = g.gather(fg)
        n_fg = all_fg.sum()
        bg_num_0 = (2 * n_fg).clamp(1, int(2 * all_fg.numel() * 0.25))
        bg_num_1 = torch.minimum(n_fg.clamp(min=1), bg_num_0)
        bg_rank = _desc_rank(torch.where(all_fg, -torch.inf,
                                         g.gather(fg_prob)))
        bg_pick = ~all_fg & (bg_rank < bg_num_0)
        neg_pick = _desc_rank(g.gather(neg_prob)) < bg_num_1
        count = n_fg + bg_pick.sum() + neg_pick.sum()
        bg_pick, neg_pick = g.rows(bg_pick), g.rows(neg_pick)

    logp = torch.log_softmax(logits, dim=-1)
    neg_logp = torch.log_softmax(neg, dim=-1)
    total = ((-logp[:, 1] * fg).sum() + (-logp[:, 0] * bg_pick).sum()
             + (-neg_logp[:, 0] * neg_pick).sum())
    if not g.distributed:
        return total / count.clamp(min=1)
    return total * g.size / count.clamp(min=1)


def triplet_loss(anchor, positive, negative, margin=1.0, p=2):
    """The margin triplet loss, mean over the leading axes of [..., D]
    embeddings: max(|a - pos|_p - |a - neg|_p + margin, 0).  The
    reference's TripletLoss (lib/model/utils/losses.py:13) does not parse;
    this is what it attempts, as the JAX package has it (no framework
    calls it)."""
    def dist(a, b):
        return torch.sum(torch.abs(a - b) ** p, dim=-1) ** (1.0 / p)
    return torch.clamp(dist(anchor, positive) - dist(anchor, negative)
                       + margin, min=0.0).mean()
