"""HEVC quantization / dequantization (H.265 8.6.3) in JAX, batched.

Reference: src/strategies/generic/quant-generic.c (kvz_quant_generic,
kvz_dequant) and the scaling machinery in src/scalinglist.c.  We implement
the flat (default) scaling list; custom scaling lists become a per-
coefficient multiplier tensor later.

All arithmetic is int32/int64-exact; blocks are batched (..., N, N).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# g_quantScales / g_invQuantScales of the standard (per qp % 6).
QUANT_SCALES = np.array([26214, 23302, 20560, 18396, 16384, 14564],
                        dtype=np.int32)
INV_QUANT_SCALES = np.array([40, 45, 51, 57, 64, 72], dtype=np.int32)

QUANT_SHIFT = 14


def quant_params(qp: int, log2_size: int, bitdepth: int):
    """(scale, qbits, inv_scale, inv_shift) for a transform size."""
    transform_shift = 15 - bitdepth - log2_size  # MAX_TR_DYNAMIC_RANGE=15
    qbits = QUANT_SHIFT + qp // 6 + transform_shift
    inv_shift = bitdepth + log2_size - 5
    return (int(QUANT_SCALES[qp % 6]), qbits,
            int(INV_QUANT_SCALES[qp % 6]), inv_shift)


def _qp_is_array(qp) -> bool:
    return not isinstance(qp, (int, np.integer))


def _quant_params_arr(qp, log2_size: int, bitdepth: int):
    """Array form of quant_params: qp is a traced int32 tensor (per-CU
    QP — the LCU-level rate-control path, reference
    kvz_set_lcu_lambda_and_qp src/rate_control.c:278).  Returns
    (scale, qbits, inv_scale) broadcastable over block leading dims;
    inv_shift stays static."""
    qp = qp.astype(jnp.int32)
    transform_shift = 15 - bitdepth - log2_size
    qbits = QUANT_SHIFT + qp // 6 + transform_shift
    scale = jnp.take(jnp.asarray(QUANT_SCALES), qp % 6)
    inv_scale = jnp.take(jnp.asarray(INV_QUANT_SCALES), qp % 6)
    return scale, qbits, inv_scale


def quantize(coeff, qp: int, size: int, bitdepth: int = 8,
             intra=True, qc=None):
    """Scalar (non-RDOQ) quantization, the reference's kvz_quant path.

    Rounding offset 171/512 for intra, 85/512 for inter, as in HM and
    the reference (src/strategies/generic/quant-generic.c).  `intra` may
    be a bool or a boolean array broadcastable against the leading axes
    of coeff (mixed P-frame batches).
    """
    log2n = size.bit_length() - 1
    if _qp_is_array(qp):
        # Per-block QP (LCU rate control): scale/qbits become tensors
        # broadcastable over the block's leading axes.
        scale, qbits, _ = _quant_params_arr(qp, log2n, bitdepth)
        scale = scale[..., None, None]
        qbits = qbits[..., None, None]
        rnd = jnp.where(intra, 171, 85) if not isinstance(intra, bool) \
            else (171 if intra else 85)
        if not isinstance(rnd, int):
            rnd = rnd.astype(jnp.int32)[..., None, None]
        offset = rnd << (qbits - 9)
        c = coeff.astype(jnp.int32)
        if qc is not None:
            raise NotImplementedError(
                "scaling lists with per-block QP")
        level = (jnp.abs(c) * scale + offset) >> qbits
        level = jnp.clip(level, 0, 32767)
        return jnp.where(c < 0, -level, level).astype(jnp.int32)
    scale, qbits, _, _ = quant_params(qp, log2n, bitdepth)
    if isinstance(intra, bool):
        offset = (171 if intra else 85) << (qbits - 9)
    else:
        offset = jnp.where(intra, 171, 85).astype(jnp.int32) << (qbits - 9)
        offset = offset[..., None, None]
    # int32-safe: |coeff| <= 32767 (transform output fits int16), so
    # |coeff|*scale + offset < 2^31.  With a scaling list, qc is the
    # per-position (N, N) table (scale<<4)//m (m >= 8 keeps the
    # product in range; see ops/scaling.py) — either a single table or
    # (qc_intra, qc_inter) selected by the `intra` mask.
    c = coeff.astype(jnp.int32)
    if qc is not None:
        if isinstance(qc, tuple):
            if isinstance(intra, bool):
                scale = qc[0] if intra else qc[1]
            else:
                scale = jnp.where(intra[..., None, None], qc[0], qc[1])
        else:
            scale = qc
    level = (jnp.abs(c) * scale + offset) >> qbits
    level = jnp.clip(level, 0, 32767)
    return jnp.where(c < 0, -level, level).astype(jnp.int32)


def dequantize(level, qp: int, size: int, bitdepth: int = 8,
               dqc=None, intra=None):
    """Spec 8.6.3 scaling.  Flat list by default; with a scaling list
    pass dqc = per-position inv_scale*m table ((N, N) or an
    (dqc_intra, dqc_inter) pair selected by the `intra` mask), using
    the reference's integer schedule (kvz_dequant scaling branch,
    src/strategies/generic/quant-generic.c:290)."""
    log2n = size.bit_length() - 1
    if _qp_is_array(qp):
        if dqc is not None:
            raise NotImplementedError("scaling lists with per-block QP")
        _, _, inv_scale = _quant_params_arr(qp, log2n, bitdepth)
        shift = bitdepth + log2n - 5
        l = level.astype(jnp.int32)
        m = (inv_scale << (qp.astype(jnp.int32) // 6))[..., None, None]
        d = (l * m + (1 << (shift - 5))) >> (shift - 4)
        return jnp.clip(d, -32768, 32767).astype(jnp.int32)
    _, _, inv_scale, shift = quant_params(qp, log2n, bitdepth)
    l = level.astype(jnp.int32)
    if dqc is not None:
        if isinstance(dqc, tuple):
            if intra is None or isinstance(intra, bool):
                m = dqc[0] if (intra is None or intra) else dqc[1]
            else:
                m = jnp.where(intra[..., None, None], dqc[0], dqc[1])
        else:
            m = dqc
        # Reference base shift = bd + log2n - 9; its scaling-list
        # branch adds 4, which equals our quant_params `shift`
        # (bd + log2n - 5).  dqc <= 72*255 so l*dqc < 2^31.
        sh = shift - qp // 6
        if sh > 0:
            d = (l * m + (1 << (sh - 1))) >> sh
        else:
            d = jnp.clip(l * m, -32768, 32767) << (-sh)
        return jnp.clip(d, -32768, 32767).astype(jnp.int32)
    # Spec computes ((level*16*levScale << qp/6) + 1<<(shift-1)) >> shift;
    # folding the *16 into the shift keeps everything int32-safe:
    # |level|*levScale<<8 <= 32767*72*256 < 2^31.  shift >= 5 always
    # (bitdepth >= 8, log2n >= 2), so shift-4 >= 1.
    d = (l * (inv_scale << (qp // 6)) + (1 << (shift - 5))) >> (shift - 4)
    return jnp.clip(d, -32768, 32767).astype(jnp.int32)


def quantize_rdoq(coeff, qp: int, size: int, bitdepth: int = 8,
                  intra=True, lam: float = 1.0, qc=None, dqc=None):
    """Rate-distortion optimized quantization, fully vectorized.

    The reference's RDOQ (kvz_rdoq, src/rdo.c:548-884) walks
    coefficients sequentially with live CABAC contexts; the device form
    evaluates the candidate levels {0, l, l-1} for EVERY coefficient in
    parallel against a static rate model, then applies a per-4x4-group
    zeroing pass — the same D + lambda*R objective with the context
    feedback approximated away (the reference itself draws that
    approximation boundary for mode costs via kvz_entropy_bits,
    src/rdo.h:69-77).

    Distortion is measured in the pixel domain: the spec transform's
    2-D gain is 2^(15 - bitdepth - log2(size)) (integer basis rows have
    norm 64*sqrt(N), and the two rounding stages shift by
    2*log2(N) + bitdepth - 3), so
    d_pixel = (dequant(l) - c)^2 / 4^(15 - bitdepth - log2n).
    """
    log2n = size.bit_length() - 1
    if _qp_is_array(qp):
        scale, qbits, inv_scale = _quant_params_arr(qp, log2n, bitdepth)
        scale = scale[..., None, None]
        qbits = qbits[..., None, None]
        inv_m = (inv_scale << (qp.astype(jnp.int32) // 6))[..., None,
                                                           None]
        inv_shift = bitdepth + log2n - 5
        rnd_half = 1 << (qbits - 1)
    else:
        scale, qbits, inv_scale, inv_shift = quant_params(qp, log2n,
                                                          bitdepth)
        inv_m = inv_scale << (qp // 6)
        rnd_half = 1 << (qbits - 1)
    def _sel(tab):
        # (intra, inter) per-position (N, N) tables, like quantize().
        if isinstance(tab, tuple):
            if isinstance(intra, bool):
                return tab[0] if intra else tab[1]
            return jnp.where(intra[..., None, None], tab[0], tab[1])
        return tab

    dq_sh = None
    if qc is not None:
        # Scaling-list path (per-position forward scale + inverse m,
        # same integer schedules as quantize/dequantize).
        scale = _sel(qc)
        inv_m = _sel(dqc)
        dq_sh = inv_shift - qp // 6
    c = coeff.astype(jnp.int32)
    ac = jnp.abs(c)
    # Round-half level and its lower neighbor.
    l1 = ((ac * scale + rnd_half) >> qbits).astype(jnp.int32)
    l1 = jnp.clip(l1, 0, 32767)
    l0 = jnp.maximum(l1 - 1, 0)

    inv_gain = 1.0 / float(4 ** (15 - bitdepth - log2n))

    def dq(l):
        if dq_sh is not None:
            if dq_sh > 0:
                d = (l * inv_m + (1 << (dq_sh - 1))) >> dq_sh
            else:
                d = jnp.clip(l * inv_m, -32768, 32767) << (-dq_sh)
        else:
            d = (l * inv_m + (1 << (inv_shift - 5))) >> (inv_shift - 4)
        return jnp.clip(d, -32768, 32767)

    def dist(l):
        e = (dq(l) - ac).astype(jnp.float32)
        return e * e * inv_gain

    def rate(l):
        lf = l.astype(jnp.float32)
        gt0 = lf > 0
        gt1 = lf > 1
        gt2 = lf > 2
        rem = jnp.maximum(lf - 3, 0.0)
        rem_bits = jnp.where(lf > 2,
                             2.0 * jnp.log2(rem + 2.0) + 1.0, 0.0)
        return jnp.where(gt0,
                         1.0 + 1.0                       # sig + sign
                         + 1.0                           # gt1 flag
                         + jnp.where(gt1, 1.0, 0.0)      # gt2 flag
                         + jnp.where(gt2, rem_bits, 0.0),
                         0.15)                           # sig = 0

    cands = [jnp.zeros_like(l1), l0, l1]
    costs = jnp.stack([dist(l) + lam * rate(l) for l in cands])
    best = jnp.argmin(costs, axis=0)
    lvl = jnp.where(best == 2, l1, jnp.where(best == 1, l0, 0))
    best_cost = jnp.min(costs, axis=0)

    # Group-zeroing pass: drop whole 4x4 coefficient groups whose total
    # rate is not worth their distortion (the coded_sub_block_flag
    # trade the reference evaluates per group).
    lead = lvl.shape[:-2]
    nsb = size // 4
    g = lvl.reshape(*lead, nsb, 4, nsb, 4)
    gc = best_cost.reshape(*lead, nsb, 4, nsb, 4)
    gz = dist(jnp.zeros_like(lvl)).reshape(*lead, nsb, 4, nsb, 4)
    cost_keep = gc.sum(axis=(-3, -1)) + lam * 1.0       # csbf bit
    cost_zero = gz.sum(axis=(-3, -1))
    kill = (cost_zero < cost_keep)[..., :, None, :, None]
    g = jnp.where(kill, 0, g)
    lvl = g.reshape(*lead, size, size)
    return jnp.where(c < 0, -lvl, lvl).astype(jnp.int32)


def _scan4_maps():
    """(3, 16) flat 4x4 positions in scan order per scanIdx."""
    from kvazaar_jax.ops.scan import scan_order
    maps = np.zeros((3, 16), np.int32)
    for s in range(3):
        so = scan_order(4, s)
        maps[s] = so[:, 1] * 4 + so[:, 0]
    return maps


_SCAN4 = _scan4_maps()


def sign_hide(levels, scan_sel):
    """Sign-data-hiding parity adjustment (device-side, vectorized).

    For each 4x4 coefficient group with lastSig-firstSig > 3 (scan
    positions), the decoder infers the first coefficient's sign from the
    parity of the group's absolute sum (H.265 7.3.8.11 semantics) —
    so the encoder must make parity match.  We bump |firstSig| by one on
    mismatch (the cheap non-RDO strategy; the reference's RDO variant is
    kvz_rdoq_sign_hiding, src/rdo.c:405).

    levels: (..., S, S) int32; scan_sel: (...,) int32 scanIdx per block.
    """
    s = levels.shape[-1]
    nsb = s // 4
    lead = levels.shape[:-2]
    g = levels.reshape(*lead, nsb, 4, nsb, 4)
    g = jnp.swapaxes(g, -3, -2).reshape(*lead, nsb * nsb, 16)
    smap = jnp.asarray(_SCAN4)[scan_sel]        # (..., 16)
    smap = smap[..., None, :]                   # broadcast over groups
    smap_b = jnp.broadcast_to(smap, g.shape)
    gs = jnp.take_along_axis(g, smap_b, axis=-1)   # scan-ordered groups

    nz = gs != 0
    any_nz = jnp.any(nz, axis=-1)
    idx = jnp.arange(16)
    first = jnp.min(jnp.where(nz, idx, 16), axis=-1)
    last = jnp.max(jnp.where(nz, idx, -1), axis=-1)
    hidden = any_nz & ((last - first) > 3)
    sum_abs = jnp.sum(jnp.abs(gs), axis=-1)
    firstv = jnp.take_along_axis(
        gs, jnp.minimum(first, 15)[..., None], axis=-1)[..., 0]
    neg = firstv < 0
    mismatch = hidden & (((sum_abs & 1) == 1) != neg)
    bump = jnp.where(neg, -1, 1)
    newv = firstv + jnp.where(mismatch, bump, 0)
    gs = jnp.where(
        (idx == jnp.minimum(first, 15)[..., None]) & mismatch[..., None],
        newv[..., None], gs)

    # Undo the scan ordering (inverse permutation) and group reshape.
    invp = jnp.argsort(smap_b, axis=-1)
    out = jnp.take_along_axis(gs, invp, axis=-1)
    g2 = out.reshape(*lead, nsb, nsb, 4, 4)
    g2 = jnp.swapaxes(g2, -3, -2).reshape(*lead, s, s)
    return g2
