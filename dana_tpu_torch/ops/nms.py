"""Fixed-slot greedy NMS in plain PyTorch (port of dana_tpu/ops/nms.py).

Both functions give exact greedy NMS over a stable descending score sort
and return fixed output slots plus a mask, batched over a leading image
axis.  A box is suppressed by a kept higher-scored box when their IoU
(+1 convention) is strictly greater than the threshold.

The scan walks score-sorted boxes in tiles: each tile is suppressed by
the boxes already kept, then within itself by the fixed point of
keep <- live & ~any(M & keep), M the strictly-lower-triangular overlap
mask of the tile.  That fixed point is unique and equals the greedy
result; Jacobi iteration from `live` reaches it within the tile length.
The scan stops once every image has `max_output` boxes.

The data-dependent loop ends cost host synchronisations: one per tile
(all images full?) and one per nine fixed-point steps (converged?).
`HOST_SYNCS` counts them.  No kernel is written for NMS yet.
"""

from __future__ import annotations

import torch

from dana_tpu_torch.core.boxes import iou_matrix

HOST_SYNCS = 0
_UNROLL = 9     # odd: the update is antitone, so orbits have period <= 2


def _sync_flag(t: torch.Tensor) -> bool:
    global HOST_SYNCS
    HOST_SYNCS += 1
    return bool(t)


def _fixed_point(mask, live):
    """keep <- live & ~any(mask & keep) to its fixed point.
    mask [B,T,T] bool strictly lower triangular, live [B,T] bool."""
    keep = live
    for _ in range(0, mask.shape[-1] + _UNROLL, _UNROLL):
        prev = keep
        for _ in range(_UNROLL):
            keep = live & ~(mask & keep[:, None, :]).any(-1)
        if not _sync_flag((keep != prev).any()):
            break
    return keep


def _greedy_sorted(sboxes, svalid, iou_threshold, max_output, tile):
    """Greedy NMS over score-sorted boxes [B,N,4] with validity [B,N].
    -> (positions [B,M] into the sorted axis, mask [B,M])."""
    b, n = svalid.shape
    dev = sboxes.device
    pad = (-n) % tile
    if pad:
        sboxes = torch.cat([sboxes, sboxes.new_zeros(b, pad, 4)], 1)
        svalid = torch.cat([svalid, svalid.new_zeros(b, pad)], 1)
    m = max_output
    # one overflow slot at index m takes dropped writes
    kept_boxes = sboxes.new_zeros(b, m + 1, 4)
    kept_valid = torch.zeros(b, m + 1, dtype=torch.bool, device=dev)
    kept_pos = torch.zeros(b, m + 1, dtype=torch.long, device=dev)
    count = torch.zeros(b, dtype=torch.long, device=dev)
    tri = torch.ones(tile, tile, dtype=torch.bool, device=dev).tril(-1)
    rows = torch.arange(b, device=dev)[:, None]
    for lo in range(0, n + pad, tile):
        if lo and not _sync_flag((count < m).any()):
            break
        tb = sboxes[:, lo:lo + tile]
        sup0 = ((iou_matrix(tb, kept_boxes[:, :m]) > iou_threshold)
                & kept_valid[:, None, :m]).any(-1)
        mask = (iou_matrix(tb, tb) > iou_threshold) & tri
        keep = _fixed_point(mask, svalid[:, lo:lo + tile] & ~sup0)
        rank = keep.long().cumsum(1) - 1
        slot = torch.where(keep, count[:, None] + rank, m).clamp(max=m)
        kept_boxes[rows, slot] = tb
        kept_valid[rows, slot] = keep
        kept_pos[rows, slot] = torch.arange(lo, lo + tile, device=dev)
        count = (count + keep.sum(1)).clamp(max=m)
    out_mask = torch.arange(m, device=dev)[None, :] < count[:, None]
    return torch.where(out_mask, kept_pos[:, :m], 0), out_mask


def _nms(boxes, scores, iou_threshold, max_output, valid, tile):
    single = boxes.dim() == 2
    if single:
        boxes, scores = boxes[None], scores[None]
        valid = None if valid is None else valid[None]
    s = scores if valid is None else torch.where(
        valid, scores, torch.tensor(-torch.inf, dtype=scores.dtype,
                                    device=scores.device))
    s_sorted, order = torch.sort(s, dim=-1, descending=True, stable=True)
    svalid = (torch.isfinite(s_sorted) if valid is not None
              else torch.ones_like(s_sorted, dtype=torch.bool))
    sboxes = boxes.gather(1, order[..., None].expand(-1, -1, 4))
    pos, mask = _greedy_sorted(sboxes, svalid, iou_threshold, max_output,
                               tile or boxes.shape[1])
    idx = torch.where(mask, order.gather(1, pos), 0)
    if single:
        return idx[0], mask[0]
    return idx, mask


def nms_fixed(boxes, scores, iou_threshold, max_output: int, valid=None):
    """Greedy NMS, the whole candidate set as one tile (the detection
    postprocess: at most a few hundred boxes).

    boxes [(B,) N, 4], scores [(B,) N], valid optional [(B,) N] bool.
    -> (indices [(B,) max_output] int64 into the inputs, score-descending;
    keep_mask [(B,) max_output]; padded slots hold index 0 and False)."""
    return _nms(boxes, scores, iou_threshold, max_output, valid, None)


def nms_fixed_tiled(boxes, scores, iou_threshold, max_output: int,
                    valid=None, tile: int = 512):
    """The same result as nms_fixed, scanned in tiles of `tile` boxes with
    an early exit (the proposal layer: thousands of candidates)."""
    return _nms(boxes, scores, iou_threshold, max_output, valid, tile)
