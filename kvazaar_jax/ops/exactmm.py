"""Exact integer matmuls on the matrix unit via float decomposition.

The tensor cores multiply bf16 and accumulate in f32; int32 dots do not
map to them.  But every integer matmul in HEVC has small, static operand bounds,
and float arithmetic over integers is EXACT while |values| stay within
the mantissa (bf16: ±256; f32: ±2^24).  Two regimes cover everything:

- direct: both operands within ±256 and every accumulated partial sum
  within ±2^24 → one bf16xbf16→f32 matmul, bit-exact.
- split: the data operand exceeds ±256 → decompose x = (x>>8)*256 +
  (x&255); two bf16 matmuls recombined in int32.  Exact while
  |T|·K·2^8-scaled partials stay within 2^24 (true for all HEVC
  transform stages: |T|<=90, K<=32).

This replaces the reference's fixed-point SIMD butterflies
(src/strategies/avx2/dct-avx2.c etc.) with the operation the matrix
unit is built for.  Whether the split form beats a plain f32 HIGHEST
matmul or int32 arithmetic on the GPU is not measured (ROADMAP A8).
tests/test_exactmm.py pins equality against int32 einsums.
"""

from __future__ import annotations

import jax.numpy as jnp


def einsum_exact_small(spec: str, t, x):
    """Both operands within +-256, partial sums within 2^24: one bf16
    matmul."""
    r = jnp.einsum(spec, t.astype(jnp.bfloat16), x.astype(jnp.bfloat16),
                   preferred_element_type=jnp.float32)
    return r.astype(jnp.int32)


def einsum_exact_split(spec: str, t, x):
    """t within +-256; x within +-2^23 (int32 data): hi/lo byte split of
    x, two bf16 matmuls, int32 recombine.  Exact when the lo/hi partial
    sums stay within 2^24 (|t|<=255, contraction length <=~350)."""
    tb = t.astype(jnp.bfloat16)
    xh = (x >> 8).astype(jnp.bfloat16)
    xl = (x & 255).astype(jnp.bfloat16)
    rh = jnp.einsum(spec, tb, xh,
                    preferred_element_type=jnp.float32).astype(jnp.int32)
    rl = jnp.einsum(spec, tb, xl,
                    preferred_element_type=jnp.float32).astype(jnp.int32)
    return (rh << 8) + rl


def einsum_exact_f32(spec: str, a, b):
    """Both operands within +-2^23 and partial sums within 2^24: one f32
    matmul.  Precision.HIGHEST is required — by default an f32 matmul
    may run as one bf16 pass or as TF32 on the GPU, neither of which is
    exact beyond +-2^8 (bf16) or +-2^11 (TF32).
    Prefer the bf16 split path on hot paths; this is the fallback for
    operand shapes the split doesn't fit."""
    import jax
    r = jnp.einsum(spec, a.astype(jnp.float32), b.astype(jnp.float32),
                   precision=jax.lax.Precision.HIGHEST,
                   preferred_element_type=jnp.float32)
    return r.astype(jnp.int32)


def einsum_exact(spec: str, t, x, x_bound: int):
    """Dispatch on the static bound of |x| (t must be within +-256,
    which holds for all HEVC transform/prediction tables)."""
    if x_bound <= 256:
        return einsum_exact_small(spec, t, x)
    return einsum_exact_split(spec, t, x)
