"""Exact-integer HEVC transforms (DCT-like 4..32, DST-VII 4x4) in JAX.

Spec: H.265 8.6.4 (scaling and transformation).  The reference implements
these as partial-butterfly C/AVX2 per size (src/strategies/generic/
dct-generic.c, src/strategies/avx2/dct-avx2.c, dispatch src/transform.c:189).

Device design: the transform of an NxN block is two NxN integer matrix
products with interleaved rounding shifts — the matrix unit's native
operation.  We therefore keep the full spec matrices dense and batch over
many blocks at once: inputs are (..., N, N) int32 tensors, and XLA maps
the batch onto matmuls.  No butterflies: the dense matmul is the fast path.

The transform matrices are the hand-tuned integer tables of the standard
(NOT round(scale*cos): e.g. T4[1][1] is 36 where rounding gives 35).  They
are generated here from the N/2 odd-frequency magnitude vectors of each size
plus the DCT-II even/odd recursion, which reproduces the spec tables exactly
(verified by tests against the explicitly written 4x4/8x8 tables).
"""

from __future__ import annotations

import functools
import math

import jax.numpy as jnp
import numpy as np

from kvazaar_jax.constants import MAX_TR_DYNAMIC_RANGE
from kvazaar_jax.ops.exactmm import einsum_exact

# Odd-row magnitude constants per transform size (H.265 8.6.4.2 tables).
_ODD_MAGS = {
    2: [64],
    4: [83, 36],
    8: [89, 75, 50, 18],
    16: [90, 87, 80, 70, 57, 43, 25, 9],
    32: [90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4],
}


@functools.lru_cache(maxsize=None)
def dct_matrix_np(n: int) -> np.ndarray:
    """The NxN integer DCT table of H.265 (rows = frequencies)."""
    if n == 1:
        return np.array([[64]], dtype=np.int32)
    half = dct_matrix_np(n // 2)
    t = np.zeros((n, n), dtype=np.int64)
    # Even rows: T_N[2k][x] = T_{N/2}[k][x] for x < N/2, and the row is
    # symmetric/antisymmetric: T_N[k][N-1-x] = (-1)^k * T_N[k][x].
    t[0::2, : n // 2] = half
    t[0::2, n // 2:] = half[:, ::-1] * (
        np.where(np.arange(0, n, 2) % 2 == 0, 1, -1)[:, None]
    )
    mags = _ODD_MAGS[n]
    for k in range(1, n, 2):
        for x in range(n):
            u = k * (2 * x + 1)  # angle in units of pi/(2N)
            sign = 1 if math.cos(u * math.pi / (2 * n)) >= 0 else -1
            v = u % (4 * n)
            if v >= 2 * n:
                v = 4 * n - v
            w = v if v <= n else 2 * n - v  # odd, in 1..n-1
            t[k, x] = sign * mags[(w - 1) // 2]
    return t.astype(np.int32)


_DST4 = np.array(
    [
        [29, 55, 74, 84],
        [74, 74, 0, -74],
        [84, -29, -74, 55],
        [55, -84, 74, -29],
    ],
    dtype=np.int32,
)


def dst4_matrix_np() -> np.ndarray:
    return _DST4.copy()


def _round_shift(x, shift):
    return (x + (1 << (shift - 1))) >> shift


def _clip16(x):
    return jnp.clip(x, -32768, 32767)


def _matrices(size: int, dst: bool):
    t = dst4_matrix_np() if dst else dct_matrix_np(size)
    return jnp.asarray(t, dtype=jnp.int32)


def forward_transform(resid, size: int, bitdepth: int = 8, dst: bool = False):
    """Batched forward 2D transform.

    resid: (..., size, size) int32 residual.  Returns int32 coefficients
    with the spec's dynamic-range normalization (fits int16).
    Matches HM/reference two-stage shifts: shift1 = log2N + bd - 9,
    shift2 = log2N + 6 (src/strategies/generic/dct-generic.c partial
    butterflies implement the same arithmetic).
    """
    log2n = size.bit_length() - 1
    shift1 = log2n + bitdepth - 9
    shift2 = log2n + 6
    t = _matrices(size, dst)
    x = resid.astype(jnp.int32)
    # Stage 1 transforms columns: (T @ X), then rows: (. @ T^T).
    # Exact float matmul paths (ops/exactmm.py): residuals fit +-2^10, the
    # stage-1 output fits +-2^15 (MAX_TR_DYNAMIC_RANGE) so it takes the
    # hi/lo-split route.
    e = _round_shift(
        einsum_exact("kn,...nm->...km", t, x, 1 << bitdepth), shift1)
    c = _round_shift(
        einsum_exact("lm,...km->...kl", t, e, 1 << 15), shift2)
    return c


def inverse_transform(coeff, size: int, bitdepth: int = 8, dst: bool = False):
    """Batched inverse 2D transform (H.265 8.6.4.2).

    Intermediate after the first (column) stage is clipped to int16 per
    spec.  shift1 = 7, shift2 = 20 - bitdepth.
    """
    shift1 = 7
    shift2 = 20 - bitdepth
    t = _matrices(size, dst)
    c = coeff.astype(jnp.int32)
    e = _clip16(_round_shift(
        einsum_exact("kn,...km->...nm", t, c, 1 << 15), shift1))
    r = _clip16(_round_shift(
        einsum_exact("ml,...nm->...nl", t, e, 1 << 15), shift2))
    return r


def transform_2d(resid, size: int, bitdepth: int = 8, intra_luma_4x4: bool = False):
    """Dispatch like the reference's kvz_transform2d (src/transform.c:189):
    4x4 intra luma uses DST-VII, everything else the DCT table."""
    return forward_transform(resid, size, bitdepth,
                             dst=(size == 4 and intra_luma_4x4))


def itransform_2d(coeff, size: int, bitdepth: int = 8, intra_luma_4x4: bool = False):
    return inverse_transform(coeff, size, bitdepth,
                             dst=(size == 4 and intra_luma_4x4))
