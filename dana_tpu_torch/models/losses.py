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
"""

from __future__ import annotations

import torch


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
    return (nll * m).sum() / m.sum().clamp(min=1.0)


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
    [B,S,2] negative branch (all labelled 0)."""
    m = labels.numel()
    logits = cls_logits.float().reshape(m, 2)
    neg = neg_logits.float().reshape(m, 2)
    fg = labels.reshape(m) > 0
    n_fg = fg.sum()

    bg_num_0 = (2 * n_fg).clamp(1, int(2 * m * 0.25))
    bg_num_1 = torch.minimum(n_fg.clamp(min=1), bg_num_0)

    with torch.no_grad():
        fg_prob = torch.softmax(logits, dim=-1)[:, 1]
        bg_rank = _desc_rank(torch.where(fg, -torch.inf, fg_prob))
        bg_pick = ~fg & (bg_rank < bg_num_0)
        neg_pick = _desc_rank(torch.softmax(neg, dim=-1)[:, 1]) < bg_num_1

    logp = torch.log_softmax(logits, dim=-1)
    neg_logp = torch.log_softmax(neg, dim=-1)
    total = ((-logp[:, 1] * fg).sum() + (-logp[:, 0] * bg_pick).sum()
             + (-neg_logp[:, 0] * neg_pick).sum())
    count = n_fg + bg_pick.sum() + neg_pick.sum()
    return total / count.clamp(min=1)


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
