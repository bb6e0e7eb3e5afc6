"""Vectorized TB coefficient-rate model for RDO (--rd 2).

The reference's full-RD intra stage counts exact CABAC bits per
candidate with live contexts (kvz_get_coeff_cost, src/rdo.c:208, via
the only_count CABAC mode).  Context feedback is inherently
sequential, so the device form freezes contexts and models each syntax
element with static per-bin costs — the same approximation boundary
the reference itself draws for mode bits with its kvz_entropy_bits
tables (src/rdo.h:69-77).  Bypass-coded components (signs, golomb-rice
remainders, last-coordinate suffixes) are counted exactly; context
bins get state-0-ish fractional costs.

All functions are batched over leading axes and jit-friendly.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from kvazaar_jax.ops.scan import coeff_scan

# Fractional bit costs (in bits) for context-coded bins near their
# typical operating states.  sig/gt1 contexts sit mid-range early in a
# frame; these constants were fit against the Python CABAC on random
# TBs (correlation gate: tests/test_rd2.py::test_rate_model_tracks_cabac).
_BITS_SIG_1 = 1.0     # sig_coeff_flag = 1
_BITS_SIG_0 = 0.5     # sig_coeff_flag = 0
_BITS_CSBF_1 = 0.9
_BITS_CSBF_0 = 0.6
_BITS_GT1 = 1.0
_BITS_GT2 = 0.9
_BITS_LAST_CTX = 0.85  # per last_sig prefix bin


@functools.lru_cache(maxsize=None)
def _scan_tables(size: int):
    """Static diag-scan tables: flat position -> scan index, and per
    scan index the (x, y) coordinate."""
    log2n = size.bit_length() - 1
    scan = coeff_scan(log2n, 0)                 # (S*S, 2) (x, y)
    sx = scan[:, 0].astype(np.int32)
    sy = scan[:, 1].astype(np.int32)
    flat_of_scan = (sy * size + sx).astype(np.int32)
    return flat_of_scan, sx, sy


@functools.lru_cache(maxsize=None)
def _last_prefix_bits(size: int):
    """Bits to code a last_sig coordinate value v (9.3.3.1.2): ctx-coded
    TR prefix (group index bins) + exact bypass suffix bits."""
    out = np.zeros(size, np.float32)
    max_g = {4: 3, 8: 5, 16: 7, 32: 9}[size]
    for v in range(size):
        if v < 4:
            g, suffix = v, 0
        else:
            k = int(np.floor(np.log2(v)))
            g = 2 * k + ((v >> (k - 1)) & 1)   # lastSigCoeffGroupIdx
            suffix = k - 1                     # bypass suffix bits
        prefix_bins = g + 1 if g < max_g else max_g
        out[v] = _BITS_LAST_CTX * prefix_bins + suffix
    return out


def tb_rate_bits(levels, signhide: bool = False):
    """Estimated bits to code one TB's quantized levels (diag scan).

    levels: (..., S, S) int32 -> (...,) float32.  Zero TBs cost ~the
    cbf flag alone (returned as a small constant so callers can still
    compare against coded alternatives)."""
    s = levels.shape[-1]
    flat_of_scan, sx, sy = _scan_tables(s)
    a = jnp.abs(levels).reshape(*levels.shape[:-2], s * s)
    a_scan = a[..., jnp.asarray(flat_of_scan)]        # scan order
    nz = a_scan > 0
    n = s * s
    idx = jnp.arange(n)
    last = jnp.max(jnp.where(nz, idx, -1), axis=-1)   # (-1 = empty)
    any_nz = last >= 0
    lastc = jnp.maximum(last, 0)

    # last_sig_coeff_x/y bits from the last coefficient's coordinates.
    lx = jnp.asarray(sx)[lastc]
    ly = jnp.asarray(sy)[lastc]
    lp = jnp.asarray(_last_prefix_bits(s))
    bits = lp[lx] + lp[ly]

    # Group structure (4x4 sub-blocks along the scan).
    ng = n // 16
    g = a_scan.reshape(*a_scan.shape[:-1], ng, 16)
    gnz = jnp.any(g > 0, axis=-1)
    g_idx = jnp.arange(ng)
    last_g = lastc // 16
    in_region = g_idx <= last_g[..., None]
    # csbf coded for groups strictly between first and last (both
    # inferred 1); approximate: all region groups except the last.
    coded_csbf = in_region & (g_idx != last_g[..., None]) & (g_idx != 0)
    bits = bits + jnp.sum(
        jnp.where(coded_csbf,
                  jnp.where(gnz, _BITS_CSBF_1, _BITS_CSBF_0), 0.0),
        axis=-1)

    # sig flags: coeffs in coded (nonzero) groups of the region, scan
    # positions before last (last inferred significant).
    pos_in_region = (idx < last[..., None])
    grp_coded = jnp.repeat(gnz | (g_idx == last_g[..., None]), 16,
                           axis=-1) & jnp.repeat(in_region, 16, axis=-1)
    sig_coded = pos_in_region & grp_coded
    bits = bits + jnp.sum(
        jnp.where(sig_coded,
                  jnp.where(nz, _BITS_SIG_1, _BITS_SIG_0), 0.0),
        axis=-1)

    # Per-group level coding: gt1 flags for up to 8 first nz coeffs,
    # gt2 for the first gt1 coeff; remainders golomb-rice (exact
    # bypass bit counts with a per-group rice estimate).
    gnz_cnt = jnp.sum((g > 0).astype(jnp.int32), axis=-1)
    n_gt1 = jnp.minimum(gnz_cnt, 8)
    bits = bits + jnp.sum(n_gt1.astype(jnp.float32) * _BITS_GT1,
                          axis=-1)
    bits = bits + jnp.sum(jnp.where(gnz_cnt > 0, _BITS_GT2, 0.0),
                          axis=-1)
    # signs (1 bypass bit per nz; sign hiding saves ~1 per busy group).
    total_nz = jnp.sum(nz.astype(jnp.float32), axis=-1)
    bits = bits + total_nz
    if signhide:
        busy = jnp.sum((gnz_cnt >= 4).astype(jnp.float32), axis=-1)
        bits = bits - busy

    # Remainders: coeff_abs_level_remaining = a - base where base is 3
    # for the first gt2 coeff, 2 for gt1-flagged, 1 beyond the 8-coeff
    # budget.  Approximate base=2 for all nz beyond the first, 3 for
    # the largest; golomb-rice length with per-group rice from the
    # group's mean magnitude (the reference adapts rice per coeff).
    rem = jnp.maximum(g - 2, 0)
    gsum = jnp.sum(g, axis=-1)
    rice = jnp.clip(
        jnp.floor(jnp.log2(jnp.maximum(gsum.astype(jnp.float32) / 8.0,
                                       1.0))),
        0, 4).astype(jnp.int32)[..., None]

    def rice_bits(v, k):
        vf = v.astype(jnp.float32)
        kf = k.astype(jnp.float32)
        pre = jnp.floor(vf / (2.0 ** kf))
        short = pre < 8
        b_short = pre + 1 + kf
        # EG(k+1) escape for long codes.
        eg = 2 * jnp.floor(jnp.log2(jnp.maximum(
            vf - 8 * (2.0 ** kf) + (2.0 ** (kf + 1)), 1.0))) + 1 - kf
        b_long = 8 + 1 + jnp.maximum(eg, kf + 1)
        return jnp.where(short, b_short, b_long)

    bits = bits + jnp.sum(
        jnp.where(rem > 0, rice_bits(rem, rice), 0.0), axis=(-2, -1))
    # cbf flag itself (context bin).
    return jnp.where(any_nz, bits + 0.9, jnp.float32(0.7))
