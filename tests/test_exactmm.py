"""MXU float-decomposition matmuls must be bit-exact vs int32 einsums
for all operand ranges used by the codec (the analogue of the reference's
generic-vs-SIMD equivalence suite)."""

import jax.numpy as jnp
import numpy as np
import pytest

from kvazaar_jax.ops import transform as tr
from kvazaar_jax.ops.exactmm import (einsum_exact, einsum_exact_f32,
                                     einsum_exact_small,
                                     einsum_exact_split)

pytestmark = pytest.mark.smoke


@pytest.mark.parametrize("tmax,xmax,k", [
    (90, 255, 32), (90, 1023, 32), (90, 32767, 32), (32, 255, 130),
    (32, 1023, 258), (1, 16320, 8),
])
def test_exact_vs_int32(tmax, xmax, k):
    rng = np.random.default_rng(tmax * 1000 + k)
    t = rng.integers(-tmax, tmax + 1, size=(16, k)).astype(np.int32)
    x = rng.integers(-xmax, xmax + 1, size=(5, k, 12)).astype(np.int32)
    want = np.einsum("nk,bkm->bnm", t, x)
    assert np.abs(want).max() < (1 << 31)
    got = np.asarray(einsum_exact("nk,bkm->bnm", jnp.asarray(t),
                                  jnp.asarray(x), xmax + 1))
    np.testing.assert_array_equal(got, want)
    if xmax <= (1 << 23):
        got32 = np.asarray(einsum_exact_f32("nk,bkm->bnm",
                                            jnp.asarray(t),
                                            jnp.asarray(x)))
        if np.abs(want).max() < (1 << 24):
            np.testing.assert_array_equal(got32, want)


@pytest.mark.parametrize("size", [4, 8, 16, 32])
def test_transform_matches_int32_reference(size):
    """The exactmm-backed transform must equal a plain int64 matrix
    evaluation of the spec arithmetic."""
    rng = np.random.default_rng(size)
    x = rng.integers(-255, 256, size=(6, size, size)).astype(np.int32)
    t = tr.dct_matrix_np(size).astype(np.int64)
    log2n = size.bit_length() - 1
    s1, s2 = log2n + 8 - 9, log2n + 6

    def rs(v, s):
        return (v + (1 << (s - 1))) >> s

    e = rs(np.einsum("kn,bnm->bkm", t, x.astype(np.int64)), s1)
    want = rs(np.einsum("lm,bkm->bkl", t, e), s2)
    got = np.asarray(tr.forward_transform(jnp.asarray(x), size, 8))
    np.testing.assert_array_equal(got, want)

    # Inverse against int64 reference with the spec clips.
    c = rng.integers(-32768, 32768, size=(6, size, size)).astype(np.int32)
    e = np.clip(rs(np.einsum("kn,bkm->bnm", t, c.astype(np.int64)), 7),
                -32768, 32767)
    want = np.clip(rs(np.einsum("ml,bnm->bnl", t, e), 12),
                   -32768, 32767)
    got = np.asarray(tr.inverse_transform(jnp.asarray(c), size, 8))
    np.testing.assert_array_equal(got, want)
