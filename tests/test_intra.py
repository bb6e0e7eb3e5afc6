"""Intra prediction vs an independent, naive per-pixel model of H.265
8.4.4.2 (the analogue of the reference's generic-vs-AVX2 strategy tests,
tests/intra_sad_tests.c): the batched weight-tensor implementation must
match a direct transcription of the spec equations."""

import numpy as np
import jax.numpy as jnp

from kvazaar_jax.ops import intra
import pytest

pytestmark = pytest.mark.smoke

ANGLES = intra.INTRA_PRED_ANGLE
INV = intra.INV_ANGLE


def naive_predict(p_left, p_top, corner, mode, n, luma=True, bd=8):
    """p_left[y] = p[-1][y] for y in 0..2N-1; p_top[x] = p[x][-1]."""
    maxv = (1 << bd) - 1

    def filt_arrays():
        # [1 2 1] filter over the connected boundary.
        fl = p_left.copy()
        ft = p_top.copy()
        fc = (p_left[0] + 2 * corner + p_top[0] + 2) >> 2
        for y in range(2 * n - 1):
            a = corner if y == 0 else p_left[y - 1]
            b = p_left[y + 1] if y + 1 < 2 * n else p_left[2 * n - 1]
            if y + 1 < 2 * n:
                fl[y] = (a + 2 * p_left[y] + b + 2) >> 2
        for x in range(2 * n - 1):
            a = corner if x == 0 else p_top[x - 1]
            b = p_top[x + 1] if x + 1 < 2 * n else p_top[2 * n - 1]
            if x + 1 < 2 * n:
                ft[x] = (a + 2 * p_top[x] + b + 2) >> 2
        return fl, ft, fc

    filter_flag = False
    if luma and mode != 1 and n > 4:
        min_dist = min(abs(mode - 26), abs(mode - 10))
        filter_flag = min_dist > {8: 7, 16: 1, 32: 0}[n]
    if filter_flag:
        l, t, c = filt_arrays()
    else:
        l, t, c = p_left, p_top, corner

    pred = np.zeros((n, n), dtype=np.int64)
    if mode == 0:  # planar
        for y in range(n):
            for x in range(n):
                pred[y, x] = ((n - 1 - x) * l[y] + (x + 1) * t[n]
                              + (n - 1 - y) * t[x] + (y + 1) * l[n]
                              + n) >> (n.bit_length())
    elif mode == 1:  # DC
        dc = (sum(t[:n]) + sum(l[:n]) + n) >> (n.bit_length())
        pred[:, :] = dc
        if luma and n < 32:
            for x in range(n):
                pred[0, x] = (t[x] + 3 * dc + 2) >> 2
            for y in range(n):
                pred[y, 0] = (l[y] + 3 * dc + 2) >> 2
            pred[0, 0] = (l[0] + 2 * dc + t[0] + 2) >> 2
    else:
        angle = int(ANGLES[mode - 2])
        if mode >= 18:
            ref = {}
            for k in range(0, 2 * n + 1):
                ref[k] = c if k == 0 else t[k - 1]
            if angle < 0:
                inv = int(INV[mode - 11])
                for k in range(-1, ((n * angle) >> 5) - 1, -1):
                    yy = -1 + ((k * inv + 128) >> 8)
                    if yy < 2 * n:  # OOB entries are never referenced
                        ref[k] = c if yy == -1 else l[yy]
            for y in range(n):
                idx = ((y + 1) * angle) >> 5
                fact = ((y + 1) * angle) & 31
                for x in range(n):
                    a = ref[x + idx + 1]
                    b = ref.get(x + idx + 2, a) if fact else a
                    pred[y, x] = ((32 - fact) * a + fact * b + 16) >> 5
            if mode == 26 and luma and n < 32:
                for y in range(n):
                    pred[y, 0] = np.clip(t[0] + ((l[y] - c) >> 1), 0, maxv)
        else:
            ref = {}
            for k in range(0, 2 * n + 1):
                ref[k] = c if k == 0 else l[k - 1]
            if angle < 0:
                inv = int(INV[mode - 11])
                for k in range(-1, ((n * angle) >> 5) - 1, -1):
                    xx = -1 + ((k * inv + 128) >> 8)
                    if xx < 2 * n:  # OOB entries are never referenced
                        ref[k] = c if xx == -1 else t[xx]
            for x in range(n):
                idx = ((x + 1) * angle) >> 5
                fact = ((x + 1) * angle) & 31
                for y in range(n):
                    a = ref[y + idx + 1]
                    b = ref.get(y + idx + 2, a) if fact else a
                    pred[y, x] = ((32 - fact) * a + fact * b + 16) >> 5
            if mode == 10 and luma and n < 32:
                for x in range(n):
                    pred[0, x] = np.clip(l[0] + ((t[x] - c) >> 1), 0, maxv)
    return pred


def _pack_refs(p_left, p_top, corner, n):
    """Into the module's 4N+1 vector layout."""
    r = np.zeros(4 * n + 1, dtype=np.int32)
    for i in range(2 * n):
        r[i] = p_left[2 * n - 1 - i]
    r[2 * n] = corner
    r[2 * n + 1:] = p_top
    return r


def test_all_modes_match_naive_model():
    rng = np.random.default_rng(7)
    for n in (4, 8, 16, 32):
        for luma in (True, False):
            if not luma and n == 32:
                continue
            p_left = rng.integers(0, 256, 2 * n).astype(np.int64)
            p_top = rng.integers(0, 256, 2 * n).astype(np.int64)
            corner = int(rng.integers(0, 256))
            refs = jnp.asarray(_pack_refs(p_left, p_top, corner, n))[None]
            got = np.asarray(intra.predict_all_modes(refs, n, luma=luma))
            for mode in range(35):
                want = naive_predict(p_left, p_top, corner, mode, n, luma)
                np.testing.assert_array_equal(
                    got[0, mode], want,
                    err_msg=f"n={n} luma={luma} mode={mode}")


def test_predict_modes_matches_all_modes():
    rng = np.random.default_rng(8)
    n = 8
    b = 35
    refs = jnp.asarray(rng.integers(0, 256, (b, 4 * n + 1)), dtype=jnp.int32)
    modes = jnp.arange(35, dtype=jnp.int32)
    all_modes = np.asarray(intra.predict_all_modes(refs, n, luma=True))
    single = np.asarray(intra.predict_modes(refs, modes, n, luma=True))
    for i in range(b):
        np.testing.assert_array_equal(single[i], all_modes[i, i])


def test_substitution_none_available():
    n = 8
    refs = jnp.zeros((2, 4 * n + 1), jnp.int32)
    avail = jnp.zeros((2, 4 * n + 1), bool)
    out = np.asarray(intra.substitute_refs(refs, avail, 8))
    assert (out == 128).all()


def test_substitution_fill_rules():
    n = 4
    r = np.arange(17, dtype=np.int32) * 10
    avail = np.zeros(17, bool)
    avail[5] = True   # first available
    avail[9] = True
    refs = jnp.asarray(r)[None]
    out = np.asarray(intra.substitute_refs(refs, jnp.asarray(avail)[None], 8))[0]
    # Leading unavailables take the first available value (50);
    # later unavailables inherit the previous value.
    assert (out[:6] == 50).all()
    assert (out[6:9] == 50).all()
    assert (out[9:] == 90).all()
