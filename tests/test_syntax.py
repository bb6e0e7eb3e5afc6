"""Slice-data syntax roundtrip: serialize random FrameData → parse it
back → bit-exact equality of depths, modes, and coefficient levels.

This exercises every residual-coding path (last-xy, csbf, sig ctx
derivations, gt1/gt2 context sets, golomb-rice escapes) across CU sizes,
scan orders, and frame shapes including non-CTU-multiple boundaries.
"""

import numpy as np
import pytest

from kvazaar_jax.bitstream.bits import BitReader, BitWriter
from kvazaar_jax.bitstream.cabac import CabacDecoder, CabacEncoder
from kvazaar_jax.bitstream.contexts import Contexts
from kvazaar_jax.bitstream.headers import StreamParams
from kvazaar_jax.bitstream.syntax import (FrameData, SliceDataDecoder,
                                          SliceDataEncoder)
from kvazaar_jax.constants import SLICE_I

pytestmark = pytest.mark.smoke


def random_frame_data(rng, width, height, chroma=True, max_level=40,
                      density=0.25):
    fd = FrameData.empty(width, height, chroma)

    def split_cell(x0, y0, log2, depth):
        size = 1 << log2
        inside = x0 + size <= width and y0 + size <= height
        must_split = not inside and log2 > 3
        if log2 > 3 and (must_split or (log2 > 4 and rng.random() < 0.6)
                         or (log2 == 4 and rng.random() < 0.4)):
            h = size >> 1
            for dy in (0, h):
                for dx in (0, h):
                    if x0 + dx < width and y0 + dy < height:
                        split_cell(x0 + dx, y0 + dy, log2 - 1, depth + 1)
        else:
            c = size >> 3
            fd.depth8[y0 >> 3:(y0 >> 3) + c, x0 >> 3:(x0 >> 3) + c] = depth
            n4 = size >> 2
            fd.mode4[y0 >> 2:(y0 >> 2) + n4,
                     x0 >> 2:(x0 >> 2) + n4] = rng.integers(0, 35)

    for cy in range(0, height, 64):
        for cx in range(0, width, 64):
            split_cell(cx, cy, 6, 0)

    def sprinkle(plane):
        if plane.size == 0:
            return
        mask = rng.random(plane.shape) < density
        mag = rng.integers(1, max_level, size=plane.shape)
        heavy = rng.random(plane.shape) < 0.02
        mag = np.where(heavy, mag * 300, mag)
        sign = np.where(rng.random(plane.shape) < 0.5, -1, 1)
        plane[...] = np.where(mask, mag * sign, 0)

    sprinkle(fd.coeff_y)
    sprinkle(fd.coeff_cb)
    sprinkle(fd.coeff_cr)
    return fd


def roundtrip(fd, params):
    w = BitWriter()
    enc = SliceDataEncoder(params, fd, Contexts(SLICE_I, params.qp),
                           CabacEncoder(w))
    enc.encode_slice_data()
    w.align_zero()
    data = w.get_bytes()

    out = FrameData.empty(params.width, params.height,
                          params.chroma_format_idc != 0)
    dec = SliceDataDecoder(params, out, Contexts(SLICE_I, params.qp),
                           CabacDecoder(BitReader(data)))
    dec.decode_slice_data()
    return out, len(data)


@pytest.mark.parametrize("width,height,chroma,seed", [
    (64, 64, True, 0),
    (128, 64, True, 1),
    (64, 64, False, 2),
    (192, 128, True, 3),
    (80, 48, True, 4),     # non-CTU-multiple: boundary forced splits
    (104, 72, True, 5),    # min-CU-aligned odd shape
])
def test_slice_data_roundtrip(width, height, chroma, seed):
    rng = np.random.default_rng(seed)
    params = StreamParams(width=width, height=height, qp=27,
                          chroma_format_idc=1 if chroma else 0)
    fd = random_frame_data(rng, width, height, chroma)
    out, nbytes = roundtrip(fd, params)
    assert nbytes > 0
    np.testing.assert_array_equal(out.depth8, fd.depth8)
    np.testing.assert_array_equal(out.mode4, fd.mode4)
    np.testing.assert_array_equal(out.coeff_y, fd.coeff_y)
    np.testing.assert_array_equal(out.coeff_cb, fd.coeff_cb)
    np.testing.assert_array_equal(out.coeff_cr, fd.coeff_cr)


def test_slice_data_sparse_and_dc_only():
    # All-zero except single DC coefficients and a lone high-frequency
    # coefficient: exercises inferred csbf / empty-DC-subblock paths.
    params = StreamParams(width=64, height=64, qp=32)
    fd = FrameData.empty(64, 64)
    fd.depth8[:] = 1            # four 32x32 CUs
    fd.mode4[:] = 1             # DC
    fd.coeff_y[0, 0] = 5        # DC only
    fd.coeff_y[31, 63] = -1     # last coeff deep in TU at (32,0)
    fd.coeff_cb[16, 16] = 3
    out, _ = roundtrip(fd, params)
    np.testing.assert_array_equal(out.coeff_y, fd.coeff_y)
    np.testing.assert_array_equal(out.coeff_cb, fd.coeff_cb)
    np.testing.assert_array_equal(out.coeff_cr, fd.coeff_cr)


def test_slice_data_zero_frame():
    params = StreamParams(width=128, height=64, qp=22)
    fd = FrameData.empty(128, 64)
    fd.depth8[:] = 2
    fd.mode4[:] = 26
    out, nbytes = roundtrip(fd, params)
    np.testing.assert_array_equal(out.coeff_y, fd.coeff_y)
    assert nbytes < 200   # skip-ish frame stays tiny


def random_p_frame_data(rng, width, height, chroma=True):
    """Random P-slice FrameData obeying encoder invariants: skip CUs
    have no coefficients; merge non-skip CUs carry >=1 luma coeff."""
    fd = random_frame_data(rng, width, height, chroma, density=0.15)
    g8h, g8w = fd.depth8.shape
    seen = np.zeros((g8h, g8w), bool)
    for c8y in range(g8h):
        for c8x in range(g8w):
            if seen[c8y, c8x]:
                continue
            depth = int(fd.depth8[c8y, c8x])
            size = 64 >> depth
            cells = max(size >> 3, 1)
            y0, x0 = c8y * 8, c8x * 8
            seen[c8y:c8y + cells, c8x:c8x + cells] = True
            kind = rng.random()
            if kind < 0.35:
                continue                      # stays intra
            fd.inter8[c8y:c8y + cells, c8x:c8x + cells] = 1
            mv = rng.integers(-64, 65, 2)
            fd.mv8[c8y:c8y + cells, c8x:c8x + cells] = mv
            ys, xs = slice(y0, y0 + size), slice(x0, x0 + size)
            cys = slice(y0 // 2, (y0 + size) // 2)
            cxs = slice(x0 // 2, (x0 + size) // 2)
            if kind < 0.55:                   # skip: merge, no coeffs
                # skip flag lives on every cell of the CU: the
                # cu_skip_flag ctx reads neighbor CUs' edge cells.
                fd.skip8[c8y:c8y + cells, c8x:c8x + cells] = 1
                fd.merge8[c8y, c8x] = rng.integers(0, 5)
                fd.coeff_y[ys, xs] = 0
                if chroma:
                    fd.coeff_cb[cys, cxs] = 0
                    fd.coeff_cr[cys, cxs] = 0
            elif kind < 0.75:                 # merge non-skip
                fd.merge8[c8y, c8x] = rng.integers(0, 5)
                if not np.any(fd.coeff_y[ys, xs]):
                    fd.coeff_y[y0 + rng.integers(size),
                               x0 + rng.integers(size)] = \
                        rng.integers(1, 9)
            else:                             # AMVP
                fd.mvd8[c8y, c8x] = rng.integers(-200, 201, 2)
                fd.mvp8[c8y, c8x] = rng.integers(0, 2)
    return fd


def roundtrip_p(fd, params):
    from kvazaar_jax.constants import SLICE_P
    w = BitWriter()
    enc = SliceDataEncoder(params, fd, Contexts(SLICE_P, params.qp),
                           CabacEncoder(w))
    enc.encode_slice_data()
    w.align_zero()
    data = w.get_bytes()
    out = FrameData.empty(params.width, params.height,
                          params.chroma_format_idc != 0)
    dec = SliceDataDecoder(params, out, Contexts(SLICE_P, params.qp),
                           CabacDecoder(BitReader(data)))
    dec.decode_slice_data()
    return out, len(data)


@pytest.mark.parametrize("width,height,chroma,seed", [
    (64, 64, True, 10),
    (128, 128, True, 11),
    (192, 64, False, 12),
    (104, 72, True, 13),
])
def test_p_slice_roundtrip(width, height, chroma, seed):
    rng = np.random.default_rng(seed)
    params = StreamParams(width=width, height=height, qp=30,
                          chroma_format_idc=1 if chroma else 0)
    fd = random_p_frame_data(rng, width, height, chroma)
    out, _ = roundtrip_p(fd, params)
    np.testing.assert_array_equal(out.depth8, fd.depth8)
    np.testing.assert_array_equal(out.inter8, fd.inter8)
    np.testing.assert_array_equal(out.skip8, fd.skip8)
    np.testing.assert_array_equal(out.merge8, fd.merge8)
    np.testing.assert_array_equal(out.mvp8 * (fd.merge8 < 0),
                                  fd.mvp8 * (fd.merge8 < 0))
    np.testing.assert_array_equal(out.mvd8, fd.mvd8)
    np.testing.assert_array_equal(out.coeff_y, fd.coeff_y)
    np.testing.assert_array_equal(out.coeff_cb, fd.coeff_cb)
    np.testing.assert_array_equal(out.coeff_cr, fd.coeff_cr)
    # Intra modes preserved where intra.
    intra4 = np.kron(1 - fd.inter8, np.ones((2, 2), np.uint8))
    np.testing.assert_array_equal(out.mode4 * intra4, fd.mode4 * intra4)
