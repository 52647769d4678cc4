"""The port's native host library (dana_tpu_torch/native) and the blobs
built on it (data/blob.py `s2d_pack`, `query_blob_packed`) against the JAX
package's (dana_tpu/native, dana_tpu/data/blob.py) and against their own
numpy plain versions, on the CPU.

Bit for bit, on the same inputs: both libraries compile the same C++ with
the same flags, and the packing and mean subtraction only move values or
subtract once in float32.  `query_blob_packed` is held bit for bit
against the JAX package's packing of the port's own canvas, and against
the JAX package's whole function at the tolerances of
tests/test_torch_port_data.py: the resize before it differs from cv2's
(float32 by up to 1e-3 grey; uint8 by one grey level, rounded in another
fixed point).
"""

import sys
import threading

import cv2
import numpy as np
import pytest

from dana_tpu import native as jnative
from dana_tpu.data import blob as jblob

from dana_tpu_torch import native
from dana_tpu_torch.data import blob

MEANS = np.array([102.9801, 115.9465, 122.7717])
FLOAT_TOL = 1e-3        # grey levels (tests/test_torch_port_data.py)


@pytest.fixture(autouse=True)
def no_ipp():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


def _boxes(rng, n, span=100.0):
    xy = rng.uniform(0, span, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(-2, 60, (n, 2))],
                          1).astype(np.float32)


@pytest.mark.parametrize('seed', [0, 1])
def test_bbox_overlaps_and_nms_bit_for_bit(seed):
    """IoU of disjoint, touching, nested and degenerate boxes (widths down
    to -2 px), and greedy NMS with tied scores and a keep cap."""
    rng = np.random.default_rng(seed)
    b, q = _boxes(rng, 70), _boxes(rng, 40)
    q[:5] = b[:5]
    got = native.bbox_overlaps(b, q)
    np.testing.assert_array_equal(got, jnative.bbox_overlaps(b, q))
    np.testing.assert_array_equal(got, native.bbox_overlaps_plain(b, q))
    assert got.dtype == np.float32 and (got == 1).sum() >= 5
    scores = rng.random(70).astype(np.float32)
    scores[10:25] = scores[3]
    for thresh, cap in ((0.3, None), (0.7, None), (0.5, 7)):
        keep = native.nms(b, scores, thresh, cap)
        np.testing.assert_array_equal(keep,
                                      jnative.nms(b, scores, thresh, cap))
        np.testing.assert_array_equal(
            keep, native.nms_plain(b, scores, thresh, cap))
        assert keep.dtype == np.int64
    assert len(native.nms(np.zeros((0, 4)), np.zeros(0), 0.3)) == 0


@pytest.mark.parametrize('dtype', [np.uint8, np.float32])
def test_meansub_bit_for_bit(dtype):
    rng = np.random.default_rng(2)
    im = rng.integers(0, 256, (45, 67, 3)).astype(dtype)
    got = native.meansub(im, MEANS)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jnative.meansub(im, MEANS))
    np.testing.assert_array_equal(got, native.meansub_plain(im, MEANS))
    # a strided view (a flipped image) reads as its contiguous copy
    np.testing.assert_array_equal(
        native.meansub(im[:, ::-1], MEANS),
        jnative.meansub(np.ascontiguousarray(im[:, ::-1]), MEANS))


@pytest.mark.parametrize('dtype', [np.uint8, np.float32])
def test_pad_s2d_bit_for_bit(dtype):
    """Random image sizes on random even canvases: smaller than the
    canvas, equal, and larger (cut to it), with zero and mean borders."""
    rng = np.random.default_rng(3 if dtype == np.uint8 else 4)
    for _ in range(12):
        h, w = rng.integers(1, 60, 2)
        ch, cw = 2 * rng.integers(1, 35, 2)
        im = rng.integers(0, 256, (h, w, 3)).astype(dtype)
        for pad3 in (None, blob.u8_pad_of(MEANS)):
            got = native.pad_s2d(im, (ch, cw), pad3)
            assert got.shape == ((ch + 6) // 2, (cw + 6) // 2, 12)
            assert got.dtype == dtype
            np.testing.assert_array_equal(
                got, jnative.pad_s2d(im, (ch, cw), pad3))
            np.testing.assert_array_equal(
                got, native.pad_s2d_plain(im, (ch, cw), pad3))
    with pytest.raises(ValueError, match='even canvas'):
        native.pad_s2d(im, (31, 40))


def test_s2d_pack_bit_for_bit():
    rng = np.random.default_rng(5)
    x = rng.normal(0, 50, (3, 2, 64, 96, 3)).astype(np.float32)
    got = blob.s2d_pack_any(x)
    assert got.shape == (3, 2, 35, 51, 12)
    np.testing.assert_array_equal(got, jblob.s2d_pack_any(x))
    np.testing.assert_array_equal(blob.s2d_pack(x[0, 0]), got[0, 0])
    np.testing.assert_array_equal(blob.s2d_unpack(got), x)
    u8 = rng.integers(0, 256, (2, 32, 48, 3)).astype(np.uint8)
    for pad in (None, blob.u8_pad_of(MEANS + 7)):
        np.testing.assert_array_equal(blob.s2d_pack(u8, u8_pad=pad),
                                      jblob.s2d_pack(u8, u8_pad=pad))


@pytest.mark.parametrize('ship_uint8', [False, True])
def test_query_blob_packed(ship_uint8):
    """The packed query is the port's own canvas packed (bit for bit
    against the JAX package's `s2d_pack` of it) and the JAX package's
    packed query within the resize's tolerance; a flipped query and an odd
    custom canvas (left 3-channel, as in JAX) too."""
    rng = np.random.default_rng(6)
    im = rng.integers(0, 256, (480, 640, 3)).astype(np.float32)
    buckets = blob.DEFAULT_BUCKETS + ((600, 801),)
    for flipped, bks in ((False, blob.DEFAULT_BUCKETS),
                         (True, blob.DEFAULT_BUCKETS), (False, buckets)):
        kw = dict(flipped=flipped, buckets=bks)
        got, info = blob.query_blob_packed(im, MEANS, 600,
                                           ship_uint8=ship_uint8, **kw)
        want, jinfo = jblob.query_blob_packed(im, MEANS, 600,
                                              ship_uint8=ship_uint8, **kw)
        if ship_uint8:
            canvas, cinfo = blob.query_blob_u8(im, 600, pixel_means=MEANS,
                                               **kw)
            pad = blob.u8_pad_of(MEANS)
        else:
            canvas, cinfo = blob.query_blob(im, MEANS, 600, **kw)
            pad = None
        np.testing.assert_array_equal(info, jinfo)
        np.testing.assert_array_equal(info, cinfo)
        assert got.dtype == want.dtype == canvas.dtype
        if canvas.shape[1] % 2:                  # the odd 600x801 canvas
            assert got.shape == want.shape == (600, 801, 3)
            np.testing.assert_array_equal(got, canvas)
        else:
            assert got.shape == want.shape == (307, 515, 12)
            np.testing.assert_array_equal(
                got, jblob.s2d_pack(canvas, u8_pad=pad))
        if ship_uint8:
            assert np.abs(got.astype(int) - want).max() <= 1
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_TOL)


def test_threads_share_the_library():
    """Sixteen threads pack and subtract at once (a ctypes call releases
    the interpreter lock), switching often: every result equals the serial
    one."""
    rng = np.random.default_rng(7)
    ims = [rng.integers(0, 256, (120, 160, 3)).astype(np.float32)
           for _ in range(16)]
    want = [native.pad_s2d(native.meansub(im, MEANS), (128, 160))
            for im in ims]
    got = [None] * len(ims)

    def run(i):
        for _ in range(20):
            got[i] = native.pad_s2d(native.meansub(ims[i], MEANS),
                                    (128, 160))
    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(ims))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that is not there: the build raises with the command it
    ran, and nothing falls back to numpy."""
    monkeypatch.setattr(native, 'CXX', str(tmp_path / 'no-such-c++'))
    with pytest.raises(RuntimeError, match='no-such-c\\+\\+'):
        native.load(str(tmp_path / 'build'))
    assert not (tmp_path / 'build').exists() or \
        not any(p.suffix == '.so' for p in (tmp_path / 'build').iterdir())


def test_compiler_errors_are_shown(tmp_path, monkeypatch):
    """A compiler that fails: its output is in the error."""
    cxx = tmp_path / 'cxx'
    cxx.write_text('#!/bin/sh\necho "host_ops.cpp:1: error: broken" >&2\n'
                   'exit 1\n')
    cxx.chmod(0o755)
    monkeypatch.setattr(native, 'CXX', str(cxx))
    with pytest.raises(RuntimeError, match='error: broken'):
        native.load(str(tmp_path / 'build'))
