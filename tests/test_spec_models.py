"""Independent naive-spec reference models for the shared ops.

The oracle decoder imports prediction/dequant ops from the encoder, so
a weight-table bug would cancel out in e2e bit-exactness.  These tests
pin each op against a direct per-pixel transcription of the H.265
decoding process written from the spec text (like test_intra.py's
naive model breaks the loop for intra prediction):

- MC interpolation: the 8-tap luma / 4-tap chroma filters of 8.5.4.2.2
  (Tables 8-11/8-12) applied sample-by-sample.
- Deblocking: the strong/weak luma filter and the chroma filter of
  8.7.2.5 applied edge-by-edge.
- SAO: the band/edge offset application of 8.7.3.
- Dequant: the 8.6.3 scaling equation.
"""

import numpy as np
import pytest

from kvazaar_jax.refmodels import np_mc_chroma, np_mc_luma

pytestmark = pytest.mark.smoke


@pytest.mark.parametrize("mv", [(0, 0), (4, 8), (1, 0), (0, 3),
                                (5, 7), (-9, 13), (2, 2)])
def test_mc_luma_matches_spec_model(mv):
    import jax.numpy as jnp
    from kvazaar_jax.ops.inter import mc_luma
    rng = np.random.default_rng(abs(mv[0]) * 10 + abs(mv[1]))
    plane = rng.integers(0, 256, (48, 48)).astype(np.int32)
    x0, y0, s = 16, 8, 8
    got = np.asarray(mc_luma(jnp.asarray(plane), jnp.asarray([x0]),
                             jnp.asarray([y0]),
                             jnp.asarray([mv], np.int32), s))[0]
    want = np_mc_luma(plane, x0, y0, mv, s)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mv", [(0, 0), (4, 8), (3, 0), (0, 5),
                                (13, -7)])
def test_mc_chroma_matches_spec_model(mv):
    import jax.numpy as jnp
    from kvazaar_jax.ops.inter import mc_chroma
    rng = np.random.default_rng(7)
    plane = rng.integers(0, 256, (32, 32)).astype(np.int32)
    x0, y0, s = 8, 4, 4
    got = np.asarray(mc_chroma(jnp.asarray(plane), jnp.asarray([x0]),
                               jnp.asarray([y0]),
                               jnp.asarray([mv], np.int32), s))[0]
    want = np_mc_chroma(plane, x0, y0, mv, s)
    np.testing.assert_array_equal(got, want)


# ---- Deblocking (8.7.2.5) ----

BETA_TAB = [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 6, 7, 8,
            9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28,
            30, 32, 34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56,
            58, 60, 62, 64]
TC_TAB = [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
          1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5,
          6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24]


def np_deblock_luma_vertical(plane, qp, bs=2, bitdepth=8):
    """Naive 8.7.2.5 luma filtering of ONE vertical edge at x=8 over
    8 rows (per-4-sample decision groups), returns the filtered plane."""
    p = plane.astype(np.int64).copy()
    x = 8
    beta = BETA_TAB[min(max(qp, 0), 51)] * (1 << (bitdepth - 8))
    tc = TC_TAB[min(max(qp + 2 * (bs == 2), 0), 53)] \
        * (1 << (bitdepth - 8))
    maxv = (1 << bitdepth) - 1
    for g in range(0, 8, 4):          # 4-row decision groups
        r0, r3 = g, g + 3

        def dpq(r):
            dp = abs(int(p[r, x - 3]) - 2 * int(p[r, x - 2])
                     + int(p[r, x - 1]))
            dq = abs(int(p[r, x + 2]) - 2 * int(p[r, x + 1])
                     + int(p[r, x]))
            return dp, dq

        dp0, dq0 = dpq(r0)
        dp3, dq3 = dpq(r3)
        d = dp0 + dq0 + dp3 + dq3
        if d >= beta:
            continue

        def strong_row(r):
            sw = (2 * (dpq(r)[0] + dpq(r)[1]) < beta >> 2
                  and abs(int(p[r, x - 4]) - int(p[r, x - 1]))
                  + abs(int(p[r, x + 3]) - int(p[r, x])) < beta >> 3
                  and abs(int(p[r, x - 1]) - int(p[r, x]))
                  < (5 * tc + 1) >> 1)
            return sw

        strong = strong_row(r0) and strong_row(r3)
        for r in range(g, g + 4):
            p3, p2, p1, p0 = (int(p[r, x - 4]), int(p[r, x - 3]),
                              int(p[r, x - 2]), int(p[r, x - 1]))
            q0, q1, q2, q3 = (int(p[r, x]), int(p[r, x + 1]),
                              int(p[r, x + 2]), int(p[r, x + 3]))
            if strong:
                c2 = 2 * tc
                p[r, x - 1] = np.clip((p2 + 2 * p1 + 2 * p0 + 2 * q0
                                       + q1 + 4) >> 3,
                                      p0 - c2, p0 + c2)
                p[r, x - 2] = np.clip((p2 + p1 + p0 + q0 + 2) >> 2,
                                      p1 - c2, p1 + c2)
                p[r, x - 3] = np.clip((2 * p3 + 3 * p2 + p1 + p0 + q0
                                       + 4) >> 3, p2 - c2, p2 + c2)
                p[r, x] = np.clip((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2
                                   + 4) >> 3, q0 - c2, q0 + c2)
                p[r, x + 1] = np.clip((p0 + q0 + q1 + q2 + 2) >> 2,
                                      q1 - c2, q1 + c2)
                p[r, x + 2] = np.clip((p0 + q0 + q1 + 3 * q2 + 2 * q3
                                       + 4) >> 3, q2 - c2, q2 + c2)
            else:
                delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
                if abs(delta) >= tc * 10:
                    continue
                delta = np.clip(delta, -tc, tc)
                p[r, x - 1] = np.clip(p0 + delta, 0, maxv)
                p[r, x] = np.clip(q0 - delta, 0, maxv)
                if dp0 + dp3 < ((beta + (beta >> 1)) >> 3):
                    dp = np.clip((((p2 + p0 + 1) >> 1) - p1 + delta)
                                 >> 1, -(tc >> 1), tc >> 1)
                    p[r, x - 2] = np.clip(p1 + dp, 0, maxv)
                if dq0 + dq3 < ((beta + (beta >> 1)) >> 3):
                    dq = np.clip((((q2 + q0 + 1) >> 1) - q1 - delta)
                                 >> 1, -(tc >> 1), tc >> 1)
                    p[r, x + 1] = np.clip(q1 + dq, 0, maxv)
    return np.clip(p, 0, maxv)


@pytest.mark.parametrize("qp,seed", [(27, 0), (37, 1), (22, 2),
                                     (45, 3)])
def test_deblock_luma_vertical_edge_matches_spec_model(qp, seed):
    """One 8x8-block vertical edge, luma, bs 2: the vectorized op
    equals the per-row spec transcription (8-row plane, single edge at
    x = 8; horizontal pass disabled via bs_h = 0)."""
    import jax.numpy as jnp
    from kvazaar_jax.ops.deblock import deblock_plane
    rng = np.random.default_rng(seed)
    # Smooth-ish content so both strong and weak branches occur.
    base = rng.integers(60, 196, (1, 16)).astype(np.int64)
    plane = (base + rng.integers(-6, 7, (8, 16))).clip(0, 255)
    bs_v = np.array([[0, 2]], np.int32)       # edge at x = 8 only
    bs_h = np.zeros((1, 2), np.int32)
    got = np.asarray(deblock_plane(
        jnp.asarray(plane.astype(np.int32)), qp, 8, 8,
        bs_v=jnp.asarray(np.tile(bs_v, (1, 1))),
        bs_h=jnp.asarray(bs_h), blk=8))
    want = np_deblock_luma_vertical(plane, qp)
    np.testing.assert_array_equal(got, want)


# ---- SAO (8.7.3) ----

def np_sao_band(rec, band_pos, offsets, bitdepth=8):
    shift = bitdepth - 5
    out = rec.astype(np.int64).copy()
    for i in range(4):
        band = (band_pos + i) % 32
        m = (rec >> shift) == band
        out[m] += offsets[i]
    return np.clip(out, 0, (1 << bitdepth) - 1)


def np_sao_edge(rec, eo_class, offsets, bitdepth=8):
    h, w = rec.shape
    out = rec.astype(np.int64).copy()
    dy, dx = [(0, 1), (1, 0), (1, 1), (1, -1)][eo_class]
    for y in range(h):
        for x in range(w):
            ya, xa = y - dy, x - dx
            yb, xb = y + dy, x + dx
            if not (0 <= ya < h and 0 <= xa < w
                    and 0 <= yb < h and 0 <= xb < w):
                continue
            c = int(rec[y, x])
            a, b = int(rec[ya, xa]), int(rec[yb, xb])
            sa = (c > a) - (c < a)
            sb = (c > b) - (c < b)
            cat = {-2: 0, -1: 1, 0: -1, 1: 2, 2: 3}[sa + sb]
            if cat >= 0:
                out[y, x] = c + offsets[cat]
    return np.clip(out, 0, (1 << bitdepth) - 1)


@pytest.mark.parametrize("kind", ["band", "eo0", "eo1", "eo2", "eo3"])
def test_sao_matches_spec_model(kind):
    import jax.numpy as jnp
    from kvazaar_jax.ops.sao import apply_sao_plane
    rng = np.random.default_rng(11)
    rec = rng.integers(0, 256, (64, 64)).astype(np.int32)
    off = np.array([2, -1, 1, -2], np.int32)
    if kind == "band":
        t, eo, bp = 1, 0, 10
        want = np_sao_band(rec, bp, off)
    else:
        t, eo, bp = 2, int(kind[2]), 0
        want = np_sao_edge(rec, eo, off)
    got = np.asarray(apply_sao_plane(
        jnp.asarray(rec), jnp.full((1, 1), t, jnp.int32),
        jnp.full((1, 1), eo, jnp.int32),
        jnp.full((1, 1), bp, jnp.int32),
        jnp.asarray(off).reshape(1, 1, 4), 64, 8))
    np.testing.assert_array_equal(got, want)


# ---- Dequant (8.6.3) ----

LEVEL_SCALE = [40, 45, 51, 57, 64, 72]


def np_dequant(level, qp, size, bitdepth=8):
    n = size
    log2n = n.bit_length() - 1
    bd_shift = bitdepth + log2n - 5
    out = np.zeros_like(level, np.int64)
    for y in range(n):
        for x in range(n):
            d = (int(level[y, x]) * (LEVEL_SCALE[qp % 6] << (qp // 6))
                 * 16 + (1 << (bd_shift - 1))) >> bd_shift
            out[y, x] = np.clip(d, -32768, 32767)
    return out


@pytest.mark.parametrize("size,qp", [(4, 22), (8, 30), (16, 37),
                                     (32, 45)])
def test_dequant_matches_spec_model(size, qp):
    import jax.numpy as jnp
    from kvazaar_jax.ops.quant import dequantize
    rng = np.random.default_rng(size)
    lv = rng.integers(-100, 101, (1, size, size)).astype(np.int32)
    got = np.asarray(dequantize(jnp.asarray(lv), qp, size, 8))[0]
    want = np_dequant(lv[0], qp, size)
    np.testing.assert_array_equal(got, want)
