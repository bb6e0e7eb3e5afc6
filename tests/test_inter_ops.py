"""Inter ops: batched MC interpolation vs a scalar spec implementation
(H.265 8.5.4.2.2), and full-search SAD sanity."""

import numpy as np
import pytest

import jax.numpy as jnp

from kvazaar_jax.ops.inter import (CHROMA_FILTERS, LUMA_FILTERS,
                                   mc_chroma, mc_luma, sad_full_search)

pytestmark = pytest.mark.smoke


def scalar_mc_luma(plane, x0, y0, mv, size, bitdepth=8):
    h, w = plane.shape
    fx, fy = mv[0] & 3, mv[1] & 3
    ix, iy = x0 + (mv[0] >> 2), y0 + (mv[1] >> 2)
    shift1 = bitdepth - 8
    shift2 = 14 - bitdepth
    out = np.zeros((size, size), np.int64)
    fL = LUMA_FILTERS

    def ref(x, y):
        return int(plane[min(max(y, 0), h - 1), min(max(x, 0), w - 1)])

    for yy in range(size):
        for xx in range(size):
            # horizontal first on the 8 needed rows, then vertical
            temp = []
            for k in range(8):
                s = sum(int(fL[fx][i]) * ref(ix + xx - 3 + i,
                                             iy + yy - 3 + k)
                        for i in range(8))
                temp.append((s * 64 if fx == 0 else s * 1) if False
                            else s)
            # emulate our pipeline exactly per spec: hor >> shift1
            temp = [t >> shift1 if shift1 else t for t in temp]
            v = sum(int(fL[fy][k]) * temp[k] for k in range(8)) >> 6
            off = 1 << (shift2 - 1)
            out[yy, xx] = min(max((v + off) >> shift2, 0),
                              (1 << bitdepth) - 1)
    return out


def scalar_mc_chroma(plane, x0, y0, mv, size, bitdepth=8):
    h, w = plane.shape
    fx, fy = mv[0] & 7, mv[1] & 7
    ix, iy = x0 + (mv[0] >> 3), y0 + (mv[1] >> 3)
    shift1 = bitdepth - 8
    shift2 = 14 - bitdepth
    fC = CHROMA_FILTERS
    out = np.zeros((size, size), np.int64)

    def ref(x, y):
        return int(plane[min(max(y, 0), h - 1), min(max(x, 0), w - 1)])

    for yy in range(size):
        for xx in range(size):
            temp = []
            for k in range(4):
                s = sum(int(fC[fx][i]) * ref(ix + xx - 1 + i,
                                             iy + yy - 1 + k)
                        for i in range(4))
                temp.append(s >> shift1 if shift1 else s)
            v = sum(int(fC[fy][k]) * temp[k] for k in range(4)) >> 6
            off = 1 << (shift2 - 1)
            out[yy, xx] = min(max((v + off) >> shift2, 0),
                              (1 << bitdepth) - 1)
    return out


def _wait_note():
    """The scalar luma oracle applies the identity hor filter as x64
    like the device path; both reduce exactly per the algebra in
    ops/inter.py, so spec conformance is preserved."""


@pytest.mark.parametrize("mv,size", [
    ((0, 0), 8), ((5, -3), 8), ((-13, 7), 16), ((2, 2), 8),
    ((1, 3), 8), ((-9, -18), 16), ((33, 21), 8),
])
def test_mc_luma_matches_scalar(mv, size):
    rng = np.random.default_rng(abs(mv[0]) * 100 + abs(mv[1]))
    plane = rng.integers(0, 256, (48, 64)).astype(np.int32)
    x0, y0 = 16, 16
    want = scalar_mc_luma(plane, x0, y0, mv, size)
    got = np.asarray(mc_luma(jnp.asarray(plane),
                             jnp.asarray([x0]), jnp.asarray([y0]),
                             jnp.asarray([mv]), size))[0]
    np.testing.assert_array_equal(got, want)


def test_mc_luma_identity_integer_mv():
    rng = np.random.default_rng(0)
    plane = rng.integers(0, 256, (40, 40)).astype(np.int32)
    got = np.asarray(mc_luma(jnp.asarray(plane), jnp.asarray([8]),
                             jnp.asarray([8]), jnp.asarray([[16, -8]]),
                             8))[0]
    np.testing.assert_array_equal(got, plane[6:14, 12:20])


@pytest.mark.parametrize("mv,size", [
    ((0, 0), 4), ((5, -3), 4), ((-13, 7), 8), ((9, 17), 4),
])
def test_mc_chroma_matches_scalar(mv, size):
    rng = np.random.default_rng(7)
    plane = rng.integers(0, 256, (32, 32)).astype(np.int32)
    x0, y0 = 12, 12
    want = scalar_mc_chroma(plane, x0, y0, mv, size)
    got = np.asarray(mc_chroma(jnp.asarray(plane),
                               jnp.asarray([x0]), jnp.asarray([y0]),
                               jnp.asarray([mv]), size))[0]
    np.testing.assert_array_equal(got, want)


def test_sad_full_search_finds_shift():
    rng = np.random.default_rng(1)
    ref = rng.integers(0, 256, (64, 96)).astype(np.int32)
    # current block = ref shifted by (dx=3, dy=-2)
    x0, y0 = 32, 24
    cur = ref[y0 - 2:y0 + 14, x0 + 3:x0 + 19]
    sads = np.asarray(sad_full_search(
        jnp.asarray(cur[None]), jnp.asarray(ref), jnp.asarray([x0]),
        jnp.asarray([y0]), 8, 16))[0]
    best = np.unravel_index(np.argmin(sads), sads.shape)
    assert sads[best] == 0
    assert (best[0] - 8, best[1] - 8) == (-2, 3)


def test_cand_scalar_matches_vectorized():
    from kvazaar_jax.encoder.geometry import make_intra_plan
    from kvazaar_jax.encoder.inter_cands import (
        amvp_candidates, amvp_pair_at, merge_candidates, merge_list_at)
    rng = np.random.default_rng(5)
    plan = make_intra_plan(128, 128, 16, True)
    by, bx = plan.blocks_y, plan.blocks_x
    inter_map = rng.random((by, bx)) < 0.7
    mv = rng.integers(-32, 33, (by, bx, 2)).astype(np.int32)
    # Duplicate some MVs to exercise pruning.
    mv[1::2] = mv[0::2]
    vec_m = merge_candidates(inter_map, mv, plan.avail)
    vec_a = amvp_candidates(inter_map, mv, plan.avail)
    for y in range(by):
        for x in range(bx):
            sm = merge_list_at(inter_map, mv, plan.avail, y, x)
            assert [tuple(v) for v in vec_m[y, x]] == sm, (y, x)
            sa = amvp_pair_at(inter_map, mv, plan.avail, y, x)
            assert [tuple(v) for v in vec_a[y, x]] == sa, (y, x)


@pytest.mark.smoke
def test_sad_surfaces_multi_matches_per_size():
    """The pooled SAD pyramid is bit-identical to independent per-size
    surfaces (SAD is additive over sub-blocks)."""
    from kvazaar_jax.ops.inter import sad_surfaces, sad_surfaces_multi
    rng = np.random.default_rng(7)
    h, w, r = 128, 192, 8
    cur = jnp.asarray(rng.integers(0, 256, (h, w), np.int32))
    ref = jnp.asarray(rng.integers(0, 256, (h, w), np.int32))
    multi = sad_surfaces_multi(cur, ref, r, (8, 16, 32, 64))
    for s in (8, 16, 32, 64):
        single = sad_surfaces(cur, ref, r, s)
        assert np.array_equal(np.asarray(multi[s]),
                              np.asarray(single)), s


@pytest.mark.smoke
def test_sad_surfaces_multi_crop_grid():
    """A plane not divisible by 64 yields the 64-aligned-crop grid."""
    from kvazaar_jax.ops.inter import sad_surfaces_multi
    rng = np.random.default_rng(8)
    h, w, r = 96, 160, 4      # 32-aligned, not 64-aligned
    cur = jnp.asarray(rng.integers(0, 256, (h, w), np.int32))
    ref = jnp.asarray(rng.integers(0, 256, (h, w), np.int32))
    multi = sad_surfaces_multi(cur, ref, r, (8, 64))
    assert multi[64].shape == (1, 2, 2 * r + 1, 2 * r + 1)
    # Interior block (no edge-clamp difference): equals the brute sum
    # of its 64 8x8 children at the same displacement.
    s8 = np.asarray(multi[8])
    agg = s8[:8, :8].sum(axis=(0, 1))
    assert np.array_equal(np.asarray(multi[64])[0, 0], agg)
