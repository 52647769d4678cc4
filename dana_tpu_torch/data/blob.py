"""Host-side image blobs, ported from the JAX package's `data/blob.py`
without cv2.

BGR channel order, Caffe pixel-mean subtraction, shortest-side scaling,
padded top-left onto a static bucket canvas (`pick_bucket`).  As in the
reference, the MAX_SIZE long-side cap is off unless `max_size` is given.

What cv2 did, and what stands in for it here:
  * decoding: `imread_bgr` reads binary PPM (P6) and `.npy`
    (an HxWx3 uint8 BGR array) with numpy.  Any other format is handed to
    cv2, imported only then; without cv2 that raises ImportError naming
    the file.  The format is told by the file's first bytes, whatever its
    extension, as cv2.imread tells it, so a `.jpg` that holds PPM data
    reads the same in both packages.  The port has no JPEG decoder of its
    own; `image_size` reads a PPM's or a JPEG's size from its header.
  * resizing: `resize_linear` reproduces cv2.resize INTER_LINEAR on
    float32 in numpy: cv2's source coordinates are computed in double and
    rounded to float32, as cv2 does (`aten.upsample_bilinear2d`, whose
    coordinates are float32, misses cv2 by up to 0.018 grey at 600 px).
    Given a scale factor (cv2's `fx=fy=s` form) the output side is
    round(side * s) and a destination pixel maps to (d + 0.5) / s - 0.5;
    given only a size (cv2's `dsize` form) it maps with in / out.
    Coordinates below 0 clamp to 0 and the last index repeats, as in cv2;
    along x such a pixel is taken whole.  The uint8 path
    (`query_blob_u8`) resizes in float32 and rounds, where cv2 rounds in
    11-bit fixed point: the two differ by at most one grey level.
  * mean subtraction: the port's native host library
    (dana_tpu_torch/native, `meansub`), bit for bit the JAX package's
    native pass, which releases the interpreter lock while it runs.

The ResNet stem's space-to-depth input (TPU.STEM_S2D): `s2d_pack` packs
canvases [(B,) H, W, 3] (H, W even) into [(B,) H/2+3, W/2+3, 12] with
conv1's 3-pixel border applied, channels ordered (row phase, column phase,
c); `query_blob_packed` packs a query straight from its resized image
(native `pad_s2d`: the 3-channel canvas is never made).  Uint8 borders
take the rounded means (`u8_pad_of`), float ones zeros, as the canvases'
own padding does.  A canvas with an odd side cannot be packed and stays
3-channel (the stem takes either).
"""

from __future__ import annotations

import struct
import threading
from collections import OrderedDict

import numpy as np

from dana_tpu_torch import native

# (H, W) canvases: landscape / portrait / square / wide, covering the
# reference TEST scale (600 shortest side, uncapped long side) up to
# aspect 2; beyond that `snap_bucket` makes a canvas
DEFAULT_BUCKETS = ((608, 1024), (1024, 608), (704, 704),
                   (608, 1216), (1216, 608))

# rounded BGR Caffe means: the pad value of raw-uint8 queries, ~0 after
# the device's mean subtraction like the float path's zero padding
U8_PAD_MEANS = np.array([103, 116, 123], np.uint8)


def u8_pad_of(pixel_means):
    """Rounded per-channel means as the raw-uint8 pad value."""
    return np.clip(np.round(np.asarray(pixel_means, np.float64).ravel()),
                   0, 255).astype(np.uint8)


class ImageCache:
    """Byte-bounded LRU of decoded images (uint8 BGR, read-only), shared by
    the `imread_bgr` calls that are handed it.  Thread-safe.

    The caller creates it (from TPU.IMAGE_CACHE_MB) and passes it down; the
    JAX package instead rebuilt one module-level cache whenever the
    configured size changed, outside any lock.  Entries never invalidate:
    a process that rewrites an image file in place makes a new cache."""

    def __init__(self, cap_mb):
        self.cap_bytes = int(cap_mb) * (1 << 20)
        self._d = OrderedDict()        # path -> uint8 array; front = LRU
        self._bytes = 0
        self._lock = threading.Lock()

    def get(self, path):
        with self._lock:
            arr = self._d.get(path)
            if arr is not None:
                self._d.move_to_end(path)
            return arr

    def put(self, path, arr):
        if arr.nbytes > self.cap_bytes:
            return arr
        arr = arr.copy()
        arr.flags.writeable = False
        with self._lock:
            old = self._d.pop(path, None)
            if old is not None:
                self._bytes -= old.nbytes
            while self._bytes + arr.nbytes > self.cap_bytes and self._d:
                _, ev = self._d.popitem(last=False)
                self._bytes -= ev.nbytes
            self._d[path] = arr
            self._bytes += arr.nbytes
        return arr


class FIFOCache:
    """Bounded first-in first-out map of decoded support crops, shared by
    the episodic loaders' assembly threads (TPU.SUPPORT_CACHE entries; 0
    disables it).  Thread-safe; values are never written after `put`, so
    two threads that miss on one key at once only compute it twice."""

    def __init__(self, cap):
        self.cap = int(cap)
        self._d = {}
        self._lock = threading.Lock()

    def get(self, key):
        if not self.cap:
            return None
        with self._lock:
            return self._d.get(key)

    def put(self, key, value):
        if not self.cap:
            return value
        with self._lock:
            if key not in self._d and len(self._d) >= self.cap:
                self._d.pop(next(iter(self._d)))
            self._d[key] = value
        return value


def _ppm_tokens(f, n):
    """The next n whitespace-separated header fields of a PPM file."""
    out, tok = [], b''
    while len(out) < n:
        ch = f.read(1)
        if not ch:
            raise ValueError(f'{f.name}: truncated PPM header')
        if ch == b'#':
            f.readline()
        elif ch.isspace():
            if tok:
                out.append(tok)
                tok = b''
        else:
            tok += ch
    return out


def read_ppm(path) -> np.ndarray:
    """Binary PPM (P6, maxval < 256) -> uint8 [h, w, 3] BGR."""
    with open(path, 'rb') as f:
        magic, w, h, maxval = _ppm_tokens(f, 4)
        if magic != b'P6' or int(maxval) > 255:
            raise ValueError(f'{path}: not an 8-bit binary PPM')
        w, h = int(w), int(h)
        data = np.frombuffer(f.read(w * h * 3), np.uint8)
    if data.size != w * h * 3:
        raise ValueError(f'{path}: truncated PPM data')
    return np.ascontiguousarray(data.reshape(h, w, 3)[:, :, ::-1])


def write_ppm(path, im_bgr: np.ndarray) -> None:
    """uint8 [h, w, 3] BGR -> binary PPM (lossless)."""
    h, w = im_bgr.shape[:2]
    with open(path, 'wb') as f:
        f.write(b'P6\n%d %d\n255\n' % (w, h))
        f.write(np.ascontiguousarray(im_bgr[:, :, ::-1], np.uint8).tobytes())


NPY_MAGIC = b'\x93NUMPY'
JPEG_MAGIC = b'\xff\xd8'


def _signature(path) -> bytes:
    with open(path, 'rb') as f:
        return f.read(len(NPY_MAGIC))


def _decode(path) -> np.ndarray:
    """uint8 [h, w, 3] BGR, by the format the file's first bytes name."""
    head = _signature(path)
    if head.startswith(b'P6'):
        return read_ppm(path)
    if head.startswith(NPY_MAGIC):
        im = np.load(path, allow_pickle=False)
        if im.dtype != np.uint8 or im.ndim != 3 or im.shape[2] != 3:
            raise ValueError(f'{path}: an image .npy holds uint8 [h, w, 3] '
                             f'BGR, not {im.dtype} {im.shape}')
        return im
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f'{path}: decoding this image needs cv2, which is '
                          'not installed (the port reads PPM and .npy '
                          'itself)') from e
    im = cv2.imread(path, cv2.IMREAD_COLOR)
    if im is None:
        raise FileNotFoundError(path)
    return im


def _jpeg_size(f):
    """(width, height) from the first SOF segment of the JPEG stream `f`,
    read just past its SOI marker."""
    while True:
        marker = f.read(2)
        while marker[:1] == b'\xff' and marker[1:] == b'\xff':
            marker = marker[1:] + f.read(1)         # fill bytes
        if len(marker) < 2 or marker[0] != 0xff:
            raise ValueError(f'{f.name}: no JPEG frame header')
        kind = marker[1]
        if 0xd0 <= kind <= 0xd9 or kind == 0x01:   # markers with no length
            continue
        (length,) = struct.unpack('>H', f.read(2))
        # SOF0-SOF15 but DHT (c4), JPG (c8) and DAC (cc)
        if 0xc0 <= kind <= 0xcf and kind not in (0xc4, 0xc8, 0xcc):
            _, h, w = struct.unpack('>BHH', f.read(5))
            return w, h
        f.seek(length - 2, 1)


def image_size(path) -> tuple[int, int]:
    """(width, height) of a PPM or JPEG file, from its header alone."""
    with open(path, 'rb') as f:
        head = f.read(2)
        if head == b'P6':
            f.seek(0)
            _, w, h, _ = _ppm_tokens(f, 4)
            return int(w), int(h)
        if head == JPEG_MAGIC:
            return _jpeg_size(f)
    raise ValueError(f'{path}: neither a binary PPM nor a JPEG file')


def imread_bgr(path: str, cache: ImageCache | None = None) -> np.ndarray:
    """Read an image as float32 BGR HWC, through `cache` when given; the
    result is always a fresh array."""
    if cache is not None:
        hit = cache.get(path)
        if hit is not None:
            return hit.astype(np.float32)
    im = _decode(path)
    if cache is not None:
        cache.put(path, im)
    return im.astype(np.float32)


def _taps(in_size, out_size, inv_scale, clamp_frac):
    """cv2's linear taps along one axis: the source coordinate of each
    destination pixel, (d + 0.5) * (1 / inv_scale) - 0.5 in double, rounded
    to float32; its floor and fraction -> (low index, high index, low
    weight, high weight).  Along x (`clamp_frac`) a coordinate below 0 or
    past the last pixel takes that pixel whole; along y the rows are only
    clamped, the fraction stays."""
    d = np.arange(out_size, dtype=np.float64)
    f = ((d + 0.5) * (1.0 / inv_scale) - 0.5).astype(np.float32)
    s = np.floor(f)
    f = f - s
    s = s.astype(np.int64)
    if clamp_frac:
        f[s < 0] = 0
        s[s < 0] = 0
        last = s >= in_size - 1
        f[last] = 0
        s[last] = in_size - 1
    lo = np.clip(s, 0, in_size - 1)
    hi = np.clip(s + 1, 0, in_size - 1)
    return lo, hi, np.float32(1) - f, f


def resize_linear(im, out_hw=None, scale=None) -> np.ndarray:
    """cv2.resize(..., INTER_LINEAR) of a float32 [h, w, c] image: either
    by `scale` (cv2's fx = fy = scale: the output side is round(side *
    scale), mapped with 1 / scale) or to `out_hw` (cv2's dsize: mapped with
    out / in).  Rows first along x, then along y, in float32; same size is
    a copy, as in cv2."""
    im = np.asarray(im, np.float32)
    h, w = im.shape[:2]
    if scale is not None:
        out_hw = (int(round(h * scale)), int(round(w * scale)))
        inv_y = inv_x = float(scale)
    else:
        inv_y, inv_x = out_hw[0] / h, out_hw[1] / w
    if tuple(out_hw) == (h, w):
        return im.copy()
    x0, x1, a0, a1 = _taps(w, out_hw[1], inv_x, True)
    y0, y1, b0, b1 = _taps(h, out_hw[0], inv_y, False)
    rows = np.unique(np.concatenate([y0, y1]))
    src = im[rows]
    horiz = np.empty((h,) + (out_hw[1],) + im.shape[2:], np.float32)
    horiz[rows] = (src[:, x0] * a0[:, None]) + (src[:, x1] * a1[:, None])
    return (horiz[y0] * b0[:, None, None]) + (horiz[y1] * b1[:, None, None])


def query_scale(h, w, target_size, max_size=None) -> float:
    """The reference's query scale: shortest side -> target, long-side cap
    only if max_size is given."""
    scale = float(target_size) / min(h, w)
    if max_size and round(scale * max(h, w)) > max_size:
        scale = float(max_size) / max(h, w)
    return scale


def snap_bucket(h, w, multiple=64):
    """A canvas for shapes no static bucket contains: each side rounded up
    to `multiple`."""
    def snap(v):
        return int(-(-int(v) // multiple) * multiple)
    return (snap(h), snap(w))


def prep_im_for_blob(im, pixel_means, target_size, max_size=None):
    """Mean-subtract and scale the shortest side to target -> (image,
    scale)."""
    im = native.meansub(im, pixel_means)
    h, w = im.shape[:2]
    scale = query_scale(h, w, target_size, max_size)
    return resize_linear(im, scale=scale), scale


def pick_bucket(h, w, buckets=DEFAULT_BUCKETS):
    """Smallest-area bucket that holds (h, w), else a snapped canvas."""
    fitting = [b for b in buckets if b[0] >= h and b[1] >= w]
    if fitting:
        return min(fitting, key=lambda b: b[0] * b[1])
    return snap_bucket(h, w)


def pad_to_canvas(im, canvas_hw):
    """Zero-pad an HWC image onto the (H, W) canvas, top-left anchored."""
    h, w = im.shape[:2]
    ch, cw = canvas_hw
    out = np.zeros((ch, cw, im.shape[2]), np.float32)
    out[:h, :w] = im[:ch, :cw]
    return out


def query_blob(im, pixel_means, target_size=600, max_size=None,
               flipped=False, buckets=DEFAULT_BUCKETS):
    """Raw BGR image -> (canvas [H,W,3] float32, im_info (h, w, scale)):
    im_info carries the scaled size; the padding beyond it is masked
    downstream."""
    if flipped:
        im = im[:, ::-1, :]
    im, scale = prep_im_for_blob(im, pixel_means, target_size, max_size)
    h, w = im.shape[:2]
    return (pad_to_canvas(im, pick_bucket(h, w, buckets)),
            np.array([h, w, scale], np.float32))


def _resized_u8(im, target_size, max_size, flipped):
    """The uint8 query before padding -> (image [h, w, 3] uint8, scale)."""
    if flipped:
        im = im[:, ::-1, :]
    h, w = im.shape[:2]
    scale = query_scale(h, w, target_size, max_size)
    im = resize_linear(np.asarray(im, np.float32), scale=scale)
    return np.clip(np.rint(im), 0, 255).astype(np.uint8), scale


def _u8_pad(pixel_means):
    return U8_PAD_MEANS if pixel_means is None else u8_pad_of(pixel_means)


def query_blob_u8(im, target_size=600, max_size=None, flipped=False,
                  buckets=DEFAULT_BUCKETS, pixel_means=None):
    """Raw BGR image -> (uint8 canvas without mean subtraction, im_info):
    the device subtracts the means.  Padded with the rounded means."""
    im, scale = _resized_u8(im, target_size, max_size, flipped)
    h, w = im.shape[:2]
    ch, cw = pick_bucket(h, w, buckets)
    out = np.empty((ch, cw, 3), np.uint8)
    out[:] = _u8_pad(pixel_means)
    out[:h, :w] = im[:ch, :cw]
    return out, np.array([h, w, scale], np.float32)


def s2d_pack(im, u8_pad=None):
    """Canvases [(B,) H, W, 3] (float32 or uint8; H, W even) -> the
    stem's space-to-depth input [(B,) H/2+3, W/2+3, 12]: conv1's 3-pixel
    border applied (zeros, or for uint8 `u8_pad`, by default the rounded
    Caffe means), 2x2 blocks packed as (row phase, column phase, c), one
    native pass an image (`native.pad_s2d`).  models/resnet.py
    `conv1_s2d` on it equals the direct 7x7/2 conv1 on the canvas."""
    im = np.asarray(im)
    single = im.ndim == 3
    batch = im[None] if single else im
    if batch.ndim != 4:
        raise ValueError(f's2d_pack takes [(B,) H, W, 3], not {im.shape}')
    _, h, w, _ = batch.shape
    pad3 = (U8_PAD_MEANS if u8_pad is None else u8_pad) \
        if batch.dtype == np.uint8 else None
    out = np.stack([native.pad_s2d(x, (h, w), pad3) for x in batch])
    return out[0] if single else out


def s2d_pack_any(x, u8_pad=None):
    """s2d_pack over any leading dims ([..., H, W, 3])."""
    x = np.asarray(x)
    lead = x.shape[:-3]
    out = s2d_pack(x.reshape((-1,) + x.shape[-3:]), u8_pad=u8_pad)
    return out.reshape(lead + out.shape[1:])


def s2d_unpack(xd):
    """`s2d_pack`'s inverse: [..., H/2+3, W/2+3, 12] -> the canvases [...,
    H, W, 3] (the border dropped)."""
    xd = np.asarray(xd)
    *lead, hh, ww, _ = xd.shape
    x = xd.reshape(*lead, hh, ww, 2, 2, 3)
    x = np.moveaxis(x, -3, -4).reshape(*lead, 2 * hh, 2 * ww, 3)
    return x[..., 3:-3, 3:-3, :]


def query_blob_packed(im, pixel_means, target_size=600, max_size=None,
                      flipped=False, buckets=DEFAULT_BUCKETS,
                      ship_uint8=False):
    """`query_blob` (or with ship_uint8 `query_blob_u8`) and `s2d_pack` in
    one: raw BGR image -> ([(H+6)/2, (W+6)/2, 12], im_info), packed by one
    native pass from the resized image.  Equal to s2d_pack of the
    canvas; a canvas with an odd side comes back unpacked, 3-channel."""
    if ship_uint8:
        im, scale = _resized_u8(im, target_size, max_size, flipped)
        pad3 = _u8_pad(pixel_means)
    else:
        if flipped:
            im = im[:, ::-1, :]
        im, scale = prep_im_for_blob(im, pixel_means, target_size, max_size)
        pad3 = None
    h, w = im.shape[:2]
    ch, cw = pick_bucket(h, w, buckets)
    info = np.array([h, w, scale], np.float32)
    if ch % 2 or cw % 2:
        out = np.empty((ch, cw, 3), im.dtype)
        out[:] = 0 if pad3 is None else pad3
        out[:h, :w] = im[:ch, :cw]
        return out, info
    return native.pad_s2d(im, (ch, cw), pad3), info


def _pad_support(crop, out_size):
    out = np.zeros((out_size, out_size, 3), np.float32)
    out[:crop.shape[0], :crop.shape[1]] = crop
    return out


def support_blob(im, box, pixel_means, out_size=320):
    """Crop a support box (with its +1 end pixel), resize the long side to
    out_size, zero-pad to [out_size, out_size, 3]: one resampling, an
    approximation of `support_blob_exact`."""
    im = native.meansub(im, pixel_means)
    x1, y1, x2, y2 = [int(v) for v in box[:4]]
    crop = im[y1:y2 + 1, x1:x2 + 1, :]
    h, w = crop.shape[:2]
    if h >= w:
        new_h, new_w = out_size, max(1, int(w * float(out_size) / h))
    else:
        new_h, new_w = max(1, int(h * float(out_size) / w)), out_size
    return _pad_support(resize_linear(crop, (new_h, new_w)), out_size)


def support_blob_exact(im, box, pixel_means, out_size=320,
                       target_size=600, max_size=None):
    """The reference's training support crop (fs_loader.py:113-138): the
    source scaled as a query, the box scaled and truncated to int16, the
    crop with its +1 end pixel, the long side -> out_size by the extents
    without the +1 (strict `box_h > box_w` branch), top-left zero pad.
    The short side is clamped to at least 1, where the reference would
    raise."""
    im, scale = prep_im_for_blob(im, pixel_means, target_size, max_size)
    b = (np.asarray(box[:4], np.float32) * np.float32(scale)) \
        .astype(np.int16)
    x_min, y_min, x_max, y_max = [int(v) for v in b]
    box_h, box_w = y_max - y_min, x_max - x_min
    crop = im[y_min:y_max + 1, x_min:x_max + 1, :]
    if box_h > box_w:
        new_h = out_size
        new_w = max(1, int(box_w * (float(out_size) / float(box_h))))
    else:
        new_w = out_size
        new_h = max(1, int(box_h * (float(out_size) / float(box_w))))
    return _pad_support(resize_linear(crop, (new_h, new_w)), out_size)


def support_blob_whole(im, pixel_means, out_size=320):
    """The reference's whole-image support (the directory pool at eval):
    mean subtraction at scale 1, the long side -> out_size (strict `h > w`
    branch; the ratio computed first, as the reference does), top-left
    zero pad.  The short side is clamped to at least 1."""
    im, _ = prep_im_for_blob(im, pixel_means, int(np.min(im.shape[:2])),
                             None)
    h, w = im.shape[:2]
    if h > w:
        resize_scale = float(out_size) / float(h)
        out_hw = (out_size, max(1, int(w * resize_scale)))
    else:
        resize_scale = float(out_size) / float(w)
        out_hw = (max(1, int(h * resize_scale)), out_size)
    return _pad_support(resize_linear(im, out_hw), out_size)
