"""Vectorized variable-tree signalling derivation vs the scalar
decode-order oracle: merge/AMVP (P and B) and cu_skip_flag must be
bit-identical on randomized trees and motion fields.

The scalar forms are what the oracle decoder follows per CU in decode
order (inter_cands.merge_list_pu_at etc.); the encoder's hot path uses
the frame-wide numpy forms (merge_amvp_var_vec etc.).
"""

import numpy as np
import pytest

from kvazaar_jax.encoder.inter_cands import (
    merge_amvp_var_b_scalar, merge_amvp_var_b_vec,
    merge_amvp_var_scalar, merge_amvp_var_vec, var_skip8_scalar,
    var_skip8_vec)

pytestmark = pytest.mark.smoke


def random_tree(rng, h8, w8, sizes=(8, 16, 32, 64)):
    """Random valid var tree on an (h8, w8) cell grid: top-down random
    splits per CTU; boundary CTUs forced to split to fit."""
    size8 = np.zeros((h8, w8), np.uint8)

    def fill(y8, x8, c):
        s = c * 8
        if (y8 + c > h8 or x8 + c > w8
                or (s in sizes and rng.random() < 0.45 and c > 1)
                or s not in sizes):
            if c == 1:
                size8[y8, x8] = 8
                return
            h = c // 2
            for dy in (0, h):
                for dx in (0, h):
                    if y8 + dy < h8 and x8 + dx < w8:
                        fill(y8 + dy, x8 + dx, h)
            return
        size8[y8:y8 + c, x8:x8 + c] = s

    for y8 in range(0, h8, 8):
        for x8 in range(0, w8, 8):
            fill(y8, x8, 8)
    return size8


def random_fields(rng, size8):
    """Cell-filled inter/mv fields consistent with a tree (every cell
    of a CU carries the CU's values)."""
    h8, w8 = size8.shape
    inter8 = np.zeros((h8, w8), np.uint8)
    mv0 = np.zeros((h8, w8, 2), np.int32)
    mv1 = np.zeros((h8, w8, 2), np.int32)
    dirs = np.zeros((h8, w8), np.uint8)
    y = 0
    while y < h8:
        x = 0
        while x < w8:
            c = int(size8[y, x]) // 8
            if y % c == 0 and x % c == 0:
                it = rng.random() < 0.8
                inter8[y:y + c, x:x + c] = it
                if it:
                    # small MV alphabet => frequent merge coincidences
                    m0 = rng.integers(-2, 3, 2) * 4
                    m1 = rng.integers(-2, 3, 2) * 4
                    d = int(rng.integers(0, 3))
                    mv0[y:y + c, x:x + c] = m0 if d != 1 else 0
                    mv1[y:y + c, x:x + c] = m1 if d != 0 else 0
                    dirs[y:y + c, x:x + c] = d
            x += 1
        y += 1
    return inter8, mv0, mv1, dirs


@pytest.mark.parametrize("seed", range(6))
def test_merge_amvp_var_p_equivalence(seed):
    rng = np.random.default_rng(seed)
    h8, w8 = 16, 24          # 128x192 luma, 2x3 CTUs
    size8 = random_tree(rng, h8, w8)
    inter8, mv0, _mv1, _d = random_fields(rng, size8)
    ref = merge_amvp_var_scalar(size8, inter8, mv0)
    got = merge_amvp_var_vec(size8, inter8, mv0)
    for r, g, name in zip(ref, got, ("merge8", "mvp8", "mvd8")):
        np.testing.assert_array_equal(r, g, err_msg=name)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("ref_poc", [(0, 8), (4, 4)])
def test_merge_amvp_var_b_equivalence(seed, ref_poc):
    rng = np.random.default_rng(100 + seed)
    h8, w8 = 16, 24
    size8 = random_tree(rng, h8, w8)
    inter8, mv0, mv1, dirs = random_fields(rng, size8)
    poc = 2
    ref = merge_amvp_var_b_scalar(size8, inter8, dirs, mv0, mv1,
                                  poc, ref_poc)
    got = merge_amvp_var_b_vec(size8, inter8, dirs, mv0, mv1,
                               poc, ref_poc)
    names = ("merge8", "mvp8", "mvd8", "mvp8_l1", "mvd8_l1")
    for r, g, name in zip(ref, got, names):
        np.testing.assert_array_equal(r, g, err_msg=name)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("chroma", [False, True])
def test_var_skip8_equivalence(seed, chroma):
    rng = np.random.default_rng(200 + seed)
    h8, w8 = 16, 24
    size8 = random_tree(rng, h8, w8)
    inter8, mv0, _mv1, _d = random_fields(rng, size8)
    merge8, _mvp, _mvd = merge_amvp_var_vec(size8, inter8, mv0)
    cy = (rng.random((h8 * 8, w8 * 8)) < 0.01).astype(np.int16)
    ccb = ccr = None
    if chroma:
        ccb = (rng.random((h8 * 4, w8 * 4)) < 0.01).astype(np.int16)
        ccr = (rng.random((h8 * 4, w8 * 4)) < 0.01).astype(np.int16)
    ref = var_skip8_scalar(size8, inter8, merge8, cy, ccb, ccr)
    got = var_skip8_vec(size8, inter8, merge8, cy, ccb, ccr)
    np.testing.assert_array_equal(ref, got)
