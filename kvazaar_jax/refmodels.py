"""Integer reference models written from the H.265 text.

Scalar loops with none of the encoder's device machinery: the DCT table
by direct angle reduction (the encoder derives it by recursion,
ops/transform.py), the two-stage inverse transform of 8.6.4.2 with
explicit clipping, the per-pixel intra prediction equations of
8.4.4.2.4-.6, and the per-sample 8-/4-tap MC filters of 8.5.4.2.2.
The test suite pins the encoder's ops against them on the CPU, and
kvazaar_jax.devcheck pins the same ops against them on the accelerator.

Reference anchors: src/strategies/generic/dct-generic.c (partial
butterflies), src/intra.c:482 (kvz_intra_predict),
src/strategies/generic/ipol-generic.c.
"""

import numpy as np

from kvazaar_jax.ops.intra import INTRA_PRED_ANGLE, INV_ANGLE, smooth_refs
from kvazaar_jax.ops.transform import dst4_matrix_np

# Hand-tuned magnitude list of the standard: value of the 32-point
# basis at angle index k (angle = k*pi/64), k = 0..32.  Normative
# constants (H.265 8.6.4.2) — the same numbers any implementation must
# carry.
_MAG = [64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73, 70, 67,
        64, 61, 57, 54, 50, 46, 43, 38, 36, 31, 25, 22, 18, 13, 9, 4, 0]


def spec_dct32():
    """T32[i][j] = sign(cos(theta)) * MAG[reduced angle], theta =
    i*(2j+1)*pi/64 — direct angle reduction, no recursion."""
    t = np.zeros((32, 32), dtype=np.int64)
    for i in range(32):
        for j in range(32):
            u = (i * (2 * j + 1)) % 128          # angle in pi/64 units
            sign = 1
            if u > 64:
                u = 128 - u                       # cos(2pi - x) = cos(x)
            if u > 32:
                sign = -1                         # cos(pi - x) = -cos(x)
                u = 64 - u
            t[i, j] = sign * _MAG[u]
    return t


def spec_dct(n):
    """T_N by the spec's subsampling of T32: T_N[i][j] = T32[i*32/N][j]."""
    t32 = spec_dct32()
    step = 32 // n
    return t32[::step, :n]


def spec_inverse_transform(coeff, size, bitdepth=8, dst=False):
    """Scalar two-stage inverse transform, H.265 8.6.4.2."""
    t = (dst4_matrix_np() if dst else spec_dct(size)).astype(np.int64)
    c = coeff.astype(np.int64)
    shift1, shift2 = 7, 20 - bitdepth
    n = size
    e = np.zeros((n, n), dtype=np.int64)
    # First (vertical) stage: e[x][y] = sum_k T[k][x] * c[k][y]
    for x in range(n):
        for y in range(n):
            s = 0
            for k in range(n):
                s += t[k, x] * c[k, y]
            e[x, y] = np.clip((s + (1 << (shift1 - 1))) >> shift1,
                              -32768, 32767)
    r = np.zeros((n, n), dtype=np.int64)
    # Second (horizontal) stage: r[x][y] = sum_k T[k][y] * e[x][k]
    for x in range(n):
        for y in range(n):
            s = 0
            for k in range(n):
                s += t[k, y] * e[x, k]
            r[x, y] = np.clip((s + (1 << (shift2 - 1))) >> shift2,
                              -32768, 32767)
    return r.astype(np.int32)


# Intra prediction: scalar 8.4.4.2 over the encoder's ref-vector layout
# (ref[i] = p[-1][2N-1-i] for i<2N; ref[2N] = corner; ref[2N+1+x] =
# p[x][-1]) — see ops/intra.py module docstring.

def _p_left(ref, n, y):
    return int(ref[2 * n - 1 - y])


def _p_top(ref, n, x):
    return int(ref[2 * n + 1 + x])


def spec_intra_predict(ref, mode, n, luma=True, bitdepth=8):
    """Scalar H.265 8.4.4.2.4-.6 prediction of one mode.

    ref: (4N+1,) substituted UNFILTERED reference vector.  Handles the
    8.4.4.2.3 [1 2 1] smoothing choice internally (normal smoothing
    only — strong smoothing is exercised elsewhere)."""
    ref = np.asarray(ref, dtype=np.int64)
    maxv = (1 << bitdepth) - 1

    # 8.4.4.2.3 filtering decision (luma, N>=8; never DC)
    use_filt = False
    if luma and n >= 8 and mode != 1:
        min_dist = min(abs(mode - 26), abs(mode - 10))
        thresh = {8: 7, 16: 1, 32: 0}[n]
        use_filt = min_dist > thresh
    if use_filt:
        f = np.asarray(smooth_refs(ref[None]))[0]
    else:
        f = ref
    pred = np.zeros((n, n), dtype=np.int64)

    if mode == 0:                       # planar 8.4.4.2.4
        for y in range(n):
            for x in range(n):
                pred[y, x] = ((n - 1 - x) * _p_left(f, n, y)
                              + (x + 1) * _p_top(f, n, n)
                              + (n - 1 - y) * _p_top(f, n, x)
                              + (y + 1) * _p_left(f, n, n)
                              + n) >> (int(n).bit_length())
        return pred.astype(np.int32)

    if mode == 1:                       # DC 8.4.4.2.5
        dc = (sum(_p_top(f, n, x) for x in range(n))
              + sum(_p_left(f, n, y) for y in range(n)) + n) \
            >> (int(n).bit_length())
        pred[:, :] = dc
        if luma and n < 32:
            for x in range(1, n):
                pred[0, x] = (_p_top(f, n, x) + 3 * dc + 2) >> 2
            for y in range(1, n):
                pred[y, 0] = (_p_left(f, n, y) + 3 * dc + 2) >> 2
            pred[0, 0] = (_p_left(f, n, 0) + 2 * dc
                          + _p_top(f, n, 0) + 2) >> 2
        return pred.astype(np.int32)

    # Angular 8.4.4.2.6
    angle = int(INTRA_PRED_ANGLE[mode - 2])
    vertical = mode >= 18

    def main_ref(k):
        # extended main reference array index k (k may go negative)
        if k >= 0:
            return (_p_top(f, n, k - 1) if vertical
                    else _p_left(f, n, k - 1))
        inv = int(INV_ANGLE[mode - 11])
        proj = -1 + ((k * inv + 128) >> 8)
        return (_p_left(f, n, proj) if vertical
                else _p_top(f, n, proj))

    for y in range(n):
        for x in range(n):
            t = (y + 1) if vertical else (x + 1)
            idx = (t * angle) >> 5
            fact = (t * angle) & 31
            base = (x if vertical else y) + idx + 1
            v = (32 - fact) * main_ref(base) + 16
            if fact:
                v += fact * main_ref(base + 1)
            v >>= 5
            pred[y, x] = v
    if luma and n < 32:
        # 10/26 boundary filters read the UNFILTERED refs (these modes
        # are never smoothed: min_dist == 0).
        if mode == 26:      # vertical: filter first column
            for y in range(n):
                pred[y, 0] = min(max(
                    _p_top(ref, n, 0)
                    + ((_p_left(ref, n, y) - int(ref[2 * n])) >> 1),
                    0), maxv)
        elif mode == 10:    # horizontal: filter first row
            for x in range(n):
                pred[0, x] = min(max(
                    _p_left(ref, n, 0)
                    + ((_p_top(ref, n, x) - int(ref[2 * n])) >> 1),
                    0), maxv)
    return pred.astype(np.int32)


# H.265 Table 8-11: luma 8-tap fractional interpolation coefficients.
LUMA_TAPS = {
    0: [0, 0, 0, 64, 0, 0, 0, 0],
    1: [-1, 4, -10, 58, 17, -5, 1, 0],
    2: [-1, 4, -11, 40, 40, -11, 4, -1],
    3: [0, 1, -5, 17, 58, -10, 4, -1],
}
# Table 8-12: chroma 4-tap coefficients per 1/8 phase.
CHROMA_TAPS = {
    0: [0, 64, 0, 0], 1: [-2, 58, 10, -2], 2: [-4, 54, 16, -2],
    3: [-6, 46, 28, -4], 4: [-4, 36, 36, -4], 5: [-4, 28, 46, -6],
    6: [-2, 16, 54, -4], 7: [-2, 10, 58, -2],
}


def _clip_idx(v, n):
    return min(max(v, 0), n - 1)


def np_mc_luma(plane, x0, y0, mv, size, bitdepth=8):
    """Naive 8.5.4.2.2 luma MC: per-output-sample tap sums, 14-bit
    intermediate, then the uni-pred rounding of 8.5.4.2.3.1."""
    h, w = plane.shape
    fx, fy = mv[0] & 3, mv[1] & 3
    ix, iy = x0 + (mv[0] >> 2), y0 + (mv[1] >> 2)
    shift1 = bitdepth - 8
    out = np.zeros((size, size), np.int64)
    for oy in range(size):
        for ox in range(size):
            # Horizontal pass into a column of 8 intermediate rows.
            acc2 = 0
            for ty in range(8):
                yy = _clip_idx(iy + oy + ty - 3, h)
                acc = 0
                for tx in range(8):
                    xx = _clip_idx(ix + ox + tx - 3, w)
                    acc += LUMA_TAPS[fx][tx] * int(plane[yy, xx])
                acc >>= shift1
                acc2 += LUMA_TAPS[fy][ty] * acc
            val = acc2 >> 6
            if fx == 0 and fy == 0:
                val = int(plane[_clip_idx(iy + oy, h),
                                _clip_idx(ix + ox, w)]) << (6 - shift1)
            elif fy == 0:
                # Horizontal only: one pass at shift1, scaled to 14-bit.
                acc = 0
                yy = _clip_idx(iy + oy, h)
                for tx in range(8):
                    xx = _clip_idx(ix + ox + tx - 3, w)
                    acc += LUMA_TAPS[fx][tx] * int(plane[yy, xx])
                val = acc >> shift1
            elif fx == 0:
                acc = 0
                xx = _clip_idx(ix + ox, w)
                for ty in range(8):
                    yy = _clip_idx(iy + oy + ty - 3, h)
                    acc += LUMA_TAPS[fy][ty] * int(plane[yy, xx])
                val = acc >> shift1
            shift3 = 14 - bitdepth       # uni-pred round, 8.5.4.2.3.1
            out[oy, ox] = np.clip((val + (1 << (shift3 - 1))) >> shift3,
                                  0, (1 << bitdepth) - 1)
    return out


def np_mc_chroma(plane, x0, y0, mv, size, bitdepth=8):
    """Naive 4-tap chroma MC (chroma MV = luma MV, 1/8-pel units)."""
    h, w = plane.shape
    fx, fy = mv[0] & 7, mv[1] & 7
    ix, iy = x0 + (mv[0] >> 3), y0 + (mv[1] >> 3)
    shift1 = bitdepth - 8
    shift3 = 14 - bitdepth
    out = np.zeros((size, size), np.int64)
    for oy in range(size):
        for ox in range(size):
            if fx == 0 and fy == 0:
                val = int(plane[_clip_idx(iy + oy, h),
                                _clip_idx(ix + ox, w)]) << (6 - shift1)
            elif fy == 0:
                acc = 0
                yy = _clip_idx(iy + oy, h)
                for tx in range(4):
                    xx = _clip_idx(ix + ox + tx - 1, w)
                    acc += CHROMA_TAPS[fx][tx] * int(plane[yy, xx])
                val = acc >> shift1
            elif fx == 0:
                acc = 0
                xx = _clip_idx(ix + ox, w)
                for ty in range(4):
                    yy = _clip_idx(iy + oy + ty - 1, h)
                    acc += CHROMA_TAPS[fy][ty] * int(plane[yy, xx])
                val = acc >> shift1
            else:
                acc2 = 0
                for ty in range(4):
                    yy = _clip_idx(iy + oy + ty - 1, h)
                    acc = 0
                    for tx in range(4):
                        xx = _clip_idx(ix + ox + tx - 1, w)
                        acc += CHROMA_TAPS[fx][tx] * int(plane[yy, xx])
                    acc >>= shift1
                    acc2 += CHROMA_TAPS[fy][ty] * acc
                val = acc2 >> 6
            out[oy, ox] = np.clip((val + (1 << (shift3 - 1))) >> shift3,
                                  0, (1 << bitdepth) - 1)
    return out


# ---- Vectorized int64 forms for whole batches ----

def _round_shift(v, s):
    return (v + (1 << (s - 1))) >> s


def np_forward_transform(resid, size, bitdepth=8, dst=False):
    """Two-stage forward transform of a batch (..., N, N) in int64:
    columns then rows, shift1 = log2N + bd - 9, shift2 = log2N + 6
    (HM's forward arithmetic; the forward transform is not normative)."""
    t = (dst4_matrix_np() if dst else spec_dct(size)).astype(np.int64)
    log2n = size.bit_length() - 1
    x = np.asarray(resid, np.int64)
    e = _round_shift(np.einsum("kn,...nm->...km", t, x),
                     log2n + bitdepth - 9)
    return _round_shift(np.einsum("lm,...km->...kl", t, e), log2n + 6)


def np_inverse_transform(coeff, size, bitdepth=8, dst=False):
    """spec_inverse_transform over a batch (..., N, N) in int64."""
    t = (dst4_matrix_np() if dst else spec_dct(size)).astype(np.int64)
    c = np.asarray(coeff, np.int64)
    e = np.clip(_round_shift(np.einsum("kx,...ky->...xy", t, c), 7),
                -32768, 32767)
    r = _round_shift(np.einsum("ky,...xk->...xy", t, e), 20 - bitdepth)
    return np.clip(r, -32768, 32767)


def np_sad_surfaces(cur, ref, radius, size):
    """Integer-pel SAD of every size-aligned block of `cur` at every
    displacement in +-radius against `ref` with the spec's edge clamp:
    (By, Bx, 2R+1, 2R+1) int64 indexed [by, bx, dy+R, dx+R]."""
    h, w = cur.shape
    r = radius
    pad = np.pad(np.asarray(ref, np.int32), r, mode="edge")
    c = np.asarray(cur, np.int32)
    out = np.zeros((h // size, w // size, 2 * r + 1, 2 * r + 1),
                   np.int64)
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            d = np.abs(pad[dy:dy + h, dx:dx + w] - c)
            out[:, :, dy, dx] = d[:h // size * size, :w // size * size] \
                .reshape(h // size, size, w // size, size).sum((1, 3))
    return out
