"""Fixed-slot greedy NMS (port of dana_tpu/ops/nms.py).

Both public functions give exact greedy NMS over a stable descending score
sort and return fixed output slots plus a mask, batched over a leading
image axis.  A box is suppressed by a kept higher-scored box when their
IoU (+1 convention) is strictly greater than the threshold, compared in
float32.

The sort runs here, the same call on every device; the greedy walk over
the sorted boxes is one registered op, `dana_torch::nms_sorted`
(`nms_sorted`), with a fake implementation, so a traced or exported
program holds it as one call.  On CUDA tensors it launches the hand
kernel `csrc/nms.cu` (a suppression bitmask, then a walk per image, no
host synchronisation) and counts the launch in the counter table
(utils/trace.py) as `nms.float32`, also by device; on CPU tensors it runs
the plain version, `nms_sorted_plain`.

The plain version walks the sorted boxes in tiles: each tile is
suppressed by the boxes already kept, then within itself by the fixed
point of keep <- live & ~any(M & keep), M the strictly-lower-triangular
overlap mask of the tile.  That fixed point is unique and equals the
greedy result; Jacobi iteration from `live` reaches it within the tile
length.  The scan stops once every image has `max_output` boxes.  Its
data-dependent loop ends cost host synchronisations, one per tile (all
images full?) and one per nine fixed-point steps (converged?), each a
`trace.sync` at site `nms` (the table's `host_syncs`); the kernel costs
none.
"""

from __future__ import annotations

import ctypes

import torch

from dana_tpu_torch.core.boxes import iou_matrix
from dana_tpu_torch.ops import build
from dana_tpu_torch.utils import trace

_UNROLL = 9     # odd: the update is antitone, so orbits have period <= 2


def _sync_flag(t: torch.Tensor) -> bool:
    return trace.sync(t, 'nms')


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


def nms_sorted_plain(sboxes, svalid, iou_threshold, max_output, tile):
    """Greedy NMS over score-sorted boxes [B,N,4] with validity [B,N], on
    any device, in tiles of `tile` boxes.
    -> (positions [B,M] int64 into the sorted axis, mask [B,M] bool)."""
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


@torch.library.custom_op('dana_torch::nms_sorted', mutates_args=())
def nms_sorted(sboxes: torch.Tensor, svalid: torch.Tensor,
               iou_threshold: float, max_output: int,
               tile: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over score-sorted boxes [B,N,4] float32 with validity
    [B,N] bool -> (positions [B,M] int64 into the sorted axis, mask [B,M]
    bool; padded slots 0 and False).  CPU tensors: `nms_sorted_plain` in
    tiles of `tile`; CUDA tensors: the kernel, which ignores `tile`."""
    return nms_sorted_plain(sboxes, svalid, iou_threshold, max_output, tile)


@nms_sorted.register_fake
def _(sboxes, svalid, iou_threshold, max_output, tile):
    b = svalid.shape[0]
    return (svalid.new_empty(b, max_output, dtype=torch.long),
            svalid.new_empty(b, max_output, dtype=torch.bool))


def _lib():
    lib = build.load('nms')
    if lib.nms_sorted_f32.argtypes is None:
        lib.nms_sorted_f32.argtypes = ([ctypes.c_void_p] * 5
                                       + [ctypes.c_int] * 3
                                       + [ctypes.c_float, ctypes.c_void_p])
        lib.nms_sorted_f32.restype = ctypes.c_int
        lib.nms_sorted_max_boxes.restype = ctypes.c_int
    return lib


@nms_sorted.register_kernel('cuda')
def _(sboxes, svalid, iou_threshold, max_output, tile):
    if sboxes.device != svalid.device:
        raise ValueError('nms_sorted: boxes and validity must be on one '
                         f'device (got {sboxes.device}, {svalid.device})')
    if sboxes.dtype != torch.float32 or svalid.dtype != torch.bool:
        raise TypeError('nms_sorted kernel takes float32 boxes and bool '
                        f'validity (got {sboxes.dtype}, {svalid.dtype})')
    b, n = svalid.shape
    if sboxes.shape != (b, n, 4):
        raise ValueError(f'nms_sorted: boxes {tuple(sboxes.shape)} do not '
                         f'match validity {tuple(svalid.shape)}')
    if not (sboxes.is_contiguous() and svalid.is_contiguous()) \
            or sboxes.data_ptr() % 16:
        raise ValueError('nms_sorted kernel reads contiguous boxes as '
                         '16-byte float4 rows')
    dev = sboxes.device
    if b == 0 or n == 0 or max_output == 0:
        return (torch.zeros(b, max_output, dtype=torch.long, device=dev),
                torch.zeros(b, max_output, dtype=torch.bool, device=dev))
    lib = _lib()
    if n > lib.nms_sorted_max_boxes():
        raise ValueError(f'nms_sorted kernel takes at most '
                         f'{lib.nms_sorted_max_boxes()} boxes (got {n})')
    # the kernel writes every slot of pos and keep, and reads only the
    # words of the bitmask it wrote
    pos = torch.empty(b, max_output, dtype=torch.long, device=dev)
    keep = torch.empty(b, max_output, dtype=torch.bool, device=dev)
    mask = torch.empty(b, n, -(-n // 64), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = lib.nms_sorted_f32(
            sboxes.data_ptr(), svalid.data_ptr(), mask.data_ptr(),
            pos.data_ptr(), keep.data_ptr(), b, n, max_output,
            float(iou_threshold),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, 'nms_sorted')
    trace.launched('nms', dev, torch.float32)
    return pos, keep


def _nms(boxes, scores, iou_threshold, max_output, valid, tile):
    if boxes.device.type not in ('cpu', 'cuda'):
        raise ValueError('nms: boxes must be CPU or CUDA tensors (got '
                         f'{boxes.device})')
    single = boxes.dim() == 2
    if single:
        boxes, scores = boxes[None], scores[None]
        valid = None if valid is None else valid[None]
    s = scores if valid is None else torch.where(valid, scores, -torch.inf)
    s_sorted, order = torch.sort(s, dim=-1, descending=True, stable=True)
    svalid = (torch.isfinite(s_sorted) if valid is not None
              else torch.ones_like(s_sorted, dtype=torch.bool))
    sboxes = boxes.gather(1, order[..., None].expand(-1, -1, 4))
    pos, mask = greedy_sorted(sboxes, svalid, float(iou_threshold),
                              max_output, tile or boxes.shape[1])
    idx = torch.where(mask, order.gather(1, pos), 0)
    if single:
        return idx[0], mask[0]
    return idx, mask


# the greedy walk `_nms` calls: the registered op (chip_smoke.py routes its
# plain comparison path through `nms_sorted_plain` here)
greedy_sorted = nms_sorted


def nms_fixed(boxes, scores, iou_threshold, max_output: int, valid=None):
    """Greedy NMS, the whole candidate set as one tile of the plain version
    (the detection postprocess: at most a few hundred boxes).

    boxes [(B,) N, 4], scores [(B,) N], valid optional [(B,) N] bool.
    -> (indices [(B,) max_output] int64 into the inputs, score-descending;
    keep_mask [(B,) max_output]; padded slots hold index 0 and False)."""
    return _nms(boxes, scores, iou_threshold, max_output, valid, None)


def nms_fixed_tiled(boxes, scores, iou_threshold, max_output: int,
                    valid=None, tile: int = 512):
    """The same result as nms_fixed, the plain version scanning tiles of
    `tile` boxes with an early exit (the proposal layer: thousands of
    candidates).  The kernel ignores `tile`."""
    return _nms(boxes, scores, iou_threshold, max_output, valid, tile)
