"""The port's native host ops (host_ops.cpp), bound with ctypes.

The library is built from the source beside this file with the host C++
compiler (`CXX`, g++: `-O3 -shared -fPIC -std=c++17`) at first use, under
a lock, into `dana_tpu_torch/_build/` (git-ignored; the file name carries
a hash of the source, so an edited source is rebuilt).  A build that
fails raises with the compiler's output: no op falls back to numpy.  The
functions take and return numpy arrays; a ctypes call releases the
interpreter lock, so the loaders' assembly threads run them in parallel.

  * `bbox_overlaps(boxes, query)`: pairwise IoU [N, K] (+1 widths);
  * `nms(boxes, scores, thresh, max_keep=None)`: greedy NMS, the kept
    indices score-descending (stable sort, suppression at IoU > thresh);
  * `meansub(im, pixel_means)`: float32 im - means, one pass;
  * `pad_s2d(im, canvas_hw, pad3=None)`: one [h, w, 3] image onto its
    (ch, cw) canvas (top-left), with conv1's 3-pixel border, packed 2x2
    space-to-depth -> [(ch + 6) / 2, (cw + 6) / 2, 12], channels ordered
    (row phase, column phase, c); every position outside the image takes
    `pad3` (zeros by default; the raw-uint8 queries pass the rounded
    means).

The `*_plain` functions are the same ops in numpy, for the tests.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from dana_tpu_torch.ops.build import BUILD_DIR

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'host_ops.cpp')
CXX = 'g++'
CXX_FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17')

_LOCK = threading.Lock()
_LIB = {}           # library path -> the loaded library

_f32p = ctypes.POINTER(ctypes.c_float)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i64 = ctypes.c_int64
_SIGNATURES = {
    'bbox_overlaps': (None, [_f32p, _i64, _f32p, _i64, _f32p]),
    'greedy_nms': (_i64, [_f32p, _f32p, _i64, ctypes.c_float,
                          ctypes.POINTER(_i64), _i64]),
    'meansub_u8': (None, [_u8p, _i64, _f32p, _f32p]),
    'meansub_f32': (None, [_f32p, _i64, _f32p, _f32p]),
    'pad_s2d_f32': (None, [_f32p, _i64, _i64, _i64, _i64, _f32p, _f32p]),
    'pad_s2d_u8': (None, [_u8p, _i64, _i64, _i64, _i64, _u8p, _u8p]),
}


def lib_path(build_dir=None) -> str:
    """The library's path: its build directory and a hash of the source."""
    with open(SRC, 'rb') as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(build_dir or BUILD_DIR, f'libhost_ops-{digest}.so')


def _build(out):
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f'{out}.{os.getpid()}.{threading.get_ident()}.tmp'
    cmd = [CXX, *CXX_FLAGS, SRC, '-o', tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f'building {SRC} failed: {" ".join(cmd)}: '
                           f'{e}') from e
    if proc.returncode != 0:
        raise RuntimeError(f'building {SRC} failed ({" ".join(cmd)}):\n'
                           f'{proc.stdout}{proc.stderr}')
    os.replace(tmp, out)      # atomic: another process sees all or nothing


def load(build_dir=None) -> ctypes.CDLL:
    """The library, built at first use (raises if the build fails)."""
    path = lib_path(build_dir)
    lib = _LIB.get(path)
    if lib is None:
        with _LOCK:
            lib = _LIB.get(path)
            if lib is None:
                if not os.path.exists(path):
                    _build(path)
                lib = ctypes.CDLL(path)
                for name, (restype, argtypes) in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.restype, fn.argtypes = restype, argtypes
                _LIB[path] = lib
    return lib


def _ptr(a, kind=_f32p):
    return a.ctypes.data_as(kind)


def _boxes(a):
    return np.ascontiguousarray(np.asarray(a)[:, :4], np.float32)


def _means3(pixel_means):
    return np.ascontiguousarray(
        np.asarray(pixel_means, np.float32).ravel()[:3])


def _image3(im):
    im = np.asarray(im)
    if im.ndim != 3 or im.shape[2] != 3:
        raise ValueError(f'an image is [h, w, 3], not {im.shape}')
    return im


def bbox_overlaps(boxes, query) -> np.ndarray:
    """IoU of every box [N, 4+] with every query box [K, 4+] -> [N, K]
    float32 (+1 widths)."""
    boxes, query = _boxes(boxes), _boxes(query)
    out = np.empty((len(boxes), len(query)), np.float32)
    load().bbox_overlaps(_ptr(boxes), len(boxes), _ptr(query), len(query),
                         _ptr(out))
    return out


def nms(boxes, scores, thresh, max_keep=None) -> np.ndarray:
    """Greedy NMS -> the kept indices, score-descending (int64)."""
    boxes = _boxes(boxes)
    scores = np.ascontiguousarray(scores, np.float32)
    if scores.shape != (len(boxes),):
        raise ValueError(f'{len(boxes)} boxes and scores {scores.shape}')
    n = len(boxes)
    max_keep = n if max_keep is None else int(max_keep)
    keep = np.empty((max(max_keep, 0),), np.int64)
    kept = load().greedy_nms(_ptr(boxes), _ptr(scores), n,
                             ctypes.c_float(thresh),
                             keep.ctypes.data_as(ctypes.POINTER(_i64)),
                             max_keep)
    return keep[:kept]


def meansub(im, pixel_means) -> np.ndarray:
    """im [h, w, 3] (uint8, or any dtype taken as float32) minus the
    per-channel means in float32 -> a new float32 [h, w, 3]."""
    im = _image3(im)
    if im.dtype != np.uint8:
        im = im.astype(np.float32, copy=False)
    im = np.ascontiguousarray(im)
    means = _means3(pixel_means)
    out = np.empty(im.shape, np.float32)
    npix = im.shape[0] * im.shape[1]
    if im.dtype == np.uint8:
        load().meansub_u8(_ptr(im, _u8p), npix, _ptr(means), _ptr(out))
    else:
        load().meansub_f32(_ptr(im), npix, _ptr(means), _ptr(out))
    return out


def pad_s2d(im, canvas_hw, pad3=None) -> np.ndarray:
    """One image [h, w, 3] (float32 or uint8) on its (ch, cw) canvas (both
    even), with conv1's border, packed 2x2 space-to-depth -> [(ch + 6) /
    2, (cw + 6) / 2, 12] of im's dtype; the image is cut to the canvas, and
    every other position takes pad3 (zeros when None)."""
    im = _image3(im)
    ch, cw = int(canvas_hw[0]), int(canvas_hw[1])
    if ch % 2 or cw % 2:
        raise ValueError(f'space-to-depth needs an even canvas, not '
                         f'{ch}x{cw}')
    if im.dtype not in (np.float32, np.uint8):
        raise ValueError(f'pad_s2d packs float32 or uint8, not {im.dtype}')
    h, w = min(im.shape[0], ch), min(im.shape[1], cw)
    im = np.ascontiguousarray(im[:h, :w])
    kind = _f32p if im.dtype == np.float32 else _u8p
    pad = np.zeros(3, im.dtype) if pad3 is None \
        else np.ascontiguousarray(np.asarray(pad3).ravel()[:3], im.dtype)
    out = np.empty(((ch + 6) // 2, (cw + 6) // 2, 12), im.dtype)
    fn = load().pad_s2d_f32 if im.dtype == np.float32 else load().pad_s2d_u8
    fn(_ptr(im, kind), h, w, ch, cw, _ptr(pad, kind), _ptr(out, kind))
    return out


# ---------------------------------------------------------------- plain

def bbox_overlaps_plain(boxes, query) -> np.ndarray:
    boxes, query = _boxes(boxes), _boxes(query)
    area_b = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
    area_q = (query[:, 2] - query[:, 0] + 1) * (query[:, 3] - query[:, 1] + 1)
    lt = np.maximum(boxes[:, None, :2], query[None, :, :2])
    rb = np.minimum(boxes[:, None, 2:], query[None, :, 2:])
    wh = rb - lt + 1
    inter = wh[..., 0] * wh[..., 1]
    ua = (area_b[:, None] + area_q[None, :]) - inter
    iou = inter / np.where((wh > 0).all(-1), ua, np.float32(1))
    return np.where((wh > 0).all(-1), iou, np.float32(0)).astype(np.float32)


def nms_plain(boxes, scores, thresh, max_keep=None) -> np.ndarray:
    boxes = _boxes(boxes)
    scores = np.asarray(scores, np.float32)
    n = len(boxes)
    max_keep = n if max_keep is None else int(max_keep)
    order = np.argsort(-scores, kind='stable')
    areas = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
    thresh = np.float32(thresh)
    keep, suppressed = [], np.zeros(n, bool)
    for i in order:
        if len(keep) >= max_keep:
            break
        if suppressed[i]:
            continue
        keep.append(i)
        iw = np.minimum(boxes[i, 2], boxes[:, 2]) \
            - np.maximum(boxes[i, 0], boxes[:, 0]) + 1
        ih = np.minimum(boxes[i, 3], boxes[:, 3]) \
            - np.maximum(boxes[i, 1], boxes[:, 1]) + 1
        inter = iw * ih
        ovr = inter / ((areas[i] + areas) - inter)
        suppressed |= (iw > 0) & (ih > 0) & (ovr > thresh)
    return np.array(keep, np.int64)


def meansub_plain(im, pixel_means) -> np.ndarray:
    return _image3(im).astype(np.float32) - _means3(pixel_means)


def pad_s2d_plain(im, canvas_hw, pad3=None) -> np.ndarray:
    im = _image3(im)
    ch, cw = int(canvas_hw[0]), int(canvas_hw[1])
    xp = np.empty((ch + 6, cw + 6, 3), im.dtype)
    xp[:] = 0 if pad3 is None else np.asarray(pad3).ravel()[:3]
    h, w = min(im.shape[0], ch), min(im.shape[1], cw)
    xp[3:3 + h, 3:3 + w] = im[:h, :w]
    out = np.empty(((ch + 6) // 2, (cw + 6) // 2, 12), im.dtype)
    for i2 in range(2):
        for j2 in range(2):
            k = (i2 * 2 + j2) * 3
            out[..., k:k + 3] = xp[i2::2, j2::2]
    return out
