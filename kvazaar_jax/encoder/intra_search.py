"""Batched intra mode decision — all blocks, all 35 modes at once.

The reference searches one PU at a time with SATD over a rough mode list
then RDO refinement (src/search_intra.c:404-545).  Device design: predict
every mode for every block of the frame in one einsum (the mode-weight
matmul of ops/intra.py), Hadamard-SATD them all, add lambda-weighted
mode-signalling bits, argmin.  Mode decisions use *original* neighbor
pixels (open-loop) so the search has no sequential dependencies; the
reconstruction pass (intra_recon.py) then honors the exact spec
dependencies for bit-exact conformance.  MPM costs come from a two-pass
scheme: pass 1 picks SATD-best modes, pass 2 re-costs with the MPMs
implied by pass-1 neighbors.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from kvazaar_jax.constants import INTRA_DC, INTRA_PLANAR
from kvazaar_jax.encoder.geometry import (IntraFramePlan,
                                          plan_flat_gather,
                                          plan_flat_noref,
                                          plan_gidx_key)
from kvazaar_jax.ops.devconst import fetch
from kvazaar_jax.ops.exactmm import einsum_exact, einsum_exact_f32
from kvazaar_jax.ops.intra import predict_all_modes


@functools.lru_cache(maxsize=None)
def _hadamard_np(n: int) -> np.ndarray:
    h = np.array([[1]], dtype=np.int32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


def _hadamard8_np() -> np.ndarray:
    return _hadamard_np(8)


def satd8_batch(diff):
    """SATD over (..., S, S) int32 diffs as a sum of 8x8 Hadamard costs,
    normalized like the reference's satd_8x8 ((sum + 2) >> 2,
    src/strategies/generic/picture-generic.c).  4x4 blocks use the 4x4
    Hadamard with the reference's (sum + 1) >> 1 normalization
    (satd_4x4, same file)."""
    s = diff.shape[-1]
    if s == 4:
        h = jnp.asarray(_hadamard_np(4))
        t1 = einsum_exact("ij,...jk->...ik", h, diff, 1 << 10)
        t = einsum_exact("lk,...ik->...il", h, t1, 1 << 13)
        return (jnp.sum(jnp.abs(t), axis=(-2, -1)) + 1) >> 1
    assert s % 8 == 0
    h = jnp.asarray(_hadamard8_np())
    d = diff.reshape(*diff.shape[:-2], s // 8, 8, s // 8, 8)
    d = jnp.swapaxes(d, -3, -2)            # (..., s/8, s/8, 8, 8)
    # Exact as bf16 matmuls: diffs fit +-2^10, Hadamard intermediates +-2^14,
    # all partial sums < 2^24 (ops/exactmm.py).
    t1 = einsum_exact("ij,...jk->...ik", h, d, 1 << 10)
    t = einsum_exact("lk,...ik->...il", h, t1, 1 << 14)
    per_tile = (jnp.sum(jnp.abs(t), axis=(-2, -1)) + 2) >> 2
    return jnp.sum(per_tile, axis=(-2, -1))


def _mpm_triplet(cand_l, cand_a):
    """Vectorized H.265 8.4.2 MPM derivation over int32 arrays."""
    eq = cand_l == cand_a
    small = cand_l < 2
    # equal & angular
    m = cand_l
    e0, e1, e2 = m, 2 + ((m + 29) % 32), 2 + ((m - 1) % 32)
    # equal & non-angular
    p0, p1, p2 = (jnp.full_like(m, INTRA_PLANAR),
                  jnp.full_like(m, INTRA_DC), jnp.full_like(m, 26))
    # different
    d0, d1 = cand_l, cand_a
    has_planar = (cand_l == INTRA_PLANAR) | (cand_a == INTRA_PLANAR)
    has_dc = (cand_l == INTRA_DC) | (cand_a == INTRA_DC)
    d2 = jnp.where(~has_planar, INTRA_PLANAR,
                   jnp.where(~has_dc, INTRA_DC, 26))
    mpm0 = jnp.where(eq, jnp.where(small, p0, e0), d0)
    mpm1 = jnp.where(eq, jnp.where(small, p1, e1), d1)
    mpm2 = jnp.where(eq, jnp.where(small, p2, e2), d2)
    return mpm0, mpm1, mpm2


def mode_bits_table(modes_grid, cu_size: int, ctu_size: int = 64):
    """(By, Bx, 35) approximate signalling bits for each candidate mode
    given neighbor decisions (MPM flag + idx vs 5-bit remainder)."""
    by, bx = modes_grid.shape
    cand_l = jnp.concatenate(
        [jnp.full((by, 1), INTRA_DC, modes_grid.dtype),
         modes_grid[:, :-1]], axis=1)
    cand_a = jnp.concatenate(
        [jnp.full((1, bx), INTRA_DC, modes_grid.dtype),
         modes_grid[:-1, :]], axis=0)
    # Above neighbor outside the CTU row reverts to DC (8.4.2).
    rows = np.arange(by) * cu_size
    outside_ctu = jnp.asarray((rows % ctu_size) == 0)
    cand_a = jnp.where(outside_ctu[:, None], INTRA_DC, cand_a)
    m0, m1, m2 = _mpm_triplet(cand_l, cand_a)
    all_modes = jnp.arange(35, dtype=modes_grid.dtype)
    is0 = all_modes[None, None, :] == m0[..., None]
    is1 = all_modes[None, None, :] == m1[..., None]
    is2 = all_modes[None, None, :] == m2[..., None]
    return jnp.where(is0, 2.0, jnp.where(is1 | is2, 3.0, 6.0))


def _rd_rerank(preds, orig, satd, modes1, lambda_satd, s, qp, lam_rd,
               bitdepth, k: int = 4):
    """--rd 2 stage: re-rank the top-K SATD candidates per block by
    TRUE roundtrip cost — transform+quant+dequant+inverse SSD plus the
    modeled CABAC coefficient rate (ops/rate.py) plus MPM mode bits.
    The device recast of search_intra_rdo (src/search_intra.c:573): all
    blocks x K candidates in one batch instead of per-PU recursion.

    preds: (N, 35, S, S); orig: (N, 1, S, S); satd: (N, 35).
    Returns ((N,) modes, (N,) rd costs)."""
    import jax.lax
    from kvazaar_jax.ops.quant import dequantize, quantize
    from kvazaar_jax.ops.rate import tb_rate_bits
    from kvazaar_jax.ops.transform import (forward_transform,
                                           inverse_transform)
    n = preds.shape[0]
    by_bx = modes1.shape
    bits = mode_bits_table(modes1, s).reshape(n, 35)
    cost1 = satd.astype(jnp.float32) + lambda_satd * bits
    _, topk = jax.lax.top_k(-cost1, k)                    # (N, K)
    cand = jnp.take_along_axis(
        preds, topk[..., None, None], axis=1)             # (N,K,S,S)
    resid = (orig - cand).reshape(n * k, s, s)
    coeff = forward_transform(resid, s, bitdepth)
    levels = quantize(coeff, qp, s, bitdepth, intra=True)
    dq = dequantize(levels, qp, s, bitdepth)
    rrec = inverse_transform(dq, s, bitdepth)
    err = (rrec - resid).astype(jnp.float32)
    ssd = jnp.sum(err * err, axis=(-2, -1)).reshape(n, k)
    rate = tb_rate_bits(levels).reshape(n, k)
    mbits = jnp.take_along_axis(bits, topk, axis=1)
    cost = ssd + lam_rd * (rate + mbits)
    sel = jnp.argmin(cost, axis=-1)
    modes = jnp.take_along_axis(topk, sel[:, None],
                                axis=1)[:, 0].astype(jnp.int32)
    best = jnp.min(cost, axis=-1)
    return modes.reshape(by_bx), best.reshape(by_bx)


def search_frame_modes(frame, plan: IntraFramePlan, lambda_satd: float,
                       bitdepth: int = 8, two_pass: bool = True,
                       return_satd: bool = False, rdo: bool = False,
                       qp: int = 30, lam_rd: float = None):
    """frame: (H, W) int32 coded-size luma.  Returns (By, Bx) int32 modes
    and the winning cost grid (+ the full (By, Bx, 35) SATD tensor when
    return_satd — feeds the same-mode 64x64 CU aggregation).

    two_pass: re-rank with MPM-aware signalling bits from pass-1
    neighbor decisions (--rd >= 1; rd 0 is the pure-SATD argmin,
    mirroring the reference's rough-search-only depth,
    src/search_intra.c:404 vs :573)."""
    s = plan.cu_size
    by, bx = plan.blocks_y, plan.blocks_x
    n = by * bx
    flat_ext = jnp.concatenate([frame.reshape(-1),
                                jnp.zeros((1,), frame.dtype)])
    gidx = fetch(plan_gidx_key(plan, True),
                 lambda: plan_flat_gather(plan, True))         # (N, R)
    noref = jnp.asarray(plan_flat_noref(plan, True))           # (N,)
    refs = flat_ext[gidx]
    refs = jnp.where(noref[:, None], 1 << (bitdepth - 1), refs)

    preds = predict_all_modes(refs.astype(jnp.int32), s, luma=True,
                              bitdepth=bitdepth)               # (N,35,S,S)
    orig = frame.reshape(by, s, bx, s).transpose(0, 2, 1, 3)
    orig = orig.reshape(n, 1, s, s).astype(jnp.int32)
    satd = satd8_batch(preds - orig)                           # (N, 35)

    modes1 = jnp.argmin(satd, axis=-1).astype(jnp.int32).reshape(by, bx)
    if rdo:
        modes, best = _rd_rerank(preds, orig, satd, modes1,
                                 lambda_satd, s, qp,
                                 lam_rd if lam_rd is not None
                                 else lambda_satd * lambda_satd,
                                 bitdepth)
        if return_satd:
            return modes, best, satd.reshape(by, bx, 35)
        return modes, best
    if not two_pass:
        best1 = jnp.min(satd, axis=-1).astype(jnp.float32)
        if return_satd:
            return modes1, best1.reshape(by, bx), \
                satd.reshape(by, bx, 35)
        return modes1, best1.reshape(by, bx)
    bits = mode_bits_table(modes1, s).reshape(n, 35)
    cost = satd.astype(jnp.float32) + lambda_satd * bits
    modes = jnp.argmin(cost, axis=-1).astype(jnp.int32).reshape(by, bx)
    best = jnp.min(cost, axis=-1).reshape(by, bx)
    if return_satd:
        return modes, best, satd.reshape(by, bx, 35)
    return modes, best


def rd_cost_given_modes(frame, plan: IntraFramePlan, modes, qp: int,
                        lam_rd: float, bitdepth: int = 8):
    """(By, Bx) true-roundtrip RD cost (SSD + lam*coeff rate) of coding
    each block with the GIVEN mode (open-loop refs) — feeds the 64x64
    level of the rd-2 quadtree argmin."""
    from kvazaar_jax.ops.intra import predict_modes
    from kvazaar_jax.ops.quant import dequantize, quantize
    from kvazaar_jax.ops.rate import tb_rate_bits
    from kvazaar_jax.ops.transform import (forward_transform,
                                           inverse_transform)
    s = plan.cu_size
    by, bx = plan.blocks_y, plan.blocks_x
    n = by * bx
    flat_ext = jnp.concatenate([frame.reshape(-1),
                                jnp.zeros((1,), frame.dtype)])
    gidx = fetch(plan_gidx_key(plan, True),
                 lambda: plan_flat_gather(plan, True))
    noref = jnp.asarray(plan_flat_noref(plan, True))
    refs = flat_ext[gidx]
    refs = jnp.where(noref[:, None], 1 << (bitdepth - 1), refs)
    pred = predict_modes(refs.astype(jnp.int32),
                         modes.reshape(-1).astype(jnp.int32), s,
                         luma=True, bitdepth=bitdepth)
    orig = frame.reshape(by, s, bx, s).transpose(0, 2, 1, 3)
    orig = orig.reshape(n, s, s).astype(jnp.int32)
    resid = orig - pred
    coeff = forward_transform(resid, s, bitdepth)
    levels = quantize(coeff, qp, s, bitdepth, intra=True)
    dq = dequantize(levels, qp, s, bitdepth)
    rrec = inverse_transform(dq, s, bitdepth)
    err = (rrec - resid).astype(jnp.float32)
    ssd = jnp.sum(err * err, axis=(-2, -1))
    cost = ssd + lam_rd * tb_rate_bits(levels)
    return cost.reshape(by, bx)


CHROMA_CAND_BASE = (0, 26, 10, 1)   # Table 8-3 modeList order


def chroma_cand_table(luma_modes):
    """(...,) luma modes -> (..., 4) actual chroma modes selectable by
    intra_chroma_pred_mode 0..3 (8.4.3 Table 8-3: the list entry equal
    to IntraPredModeY is replaced by angular-34); index 4 (DM) is the
    luma mode itself."""
    base = jnp.asarray(CHROMA_CAND_BASE, jnp.int32)
    cand = jnp.broadcast_to(base, luma_modes.shape + (4,))
    return jnp.where(cand == luma_modes[..., None].astype(jnp.int32),
                     34, cand)


def search_chroma_modes(cbp, crp, luma_modes, plan: IntraFramePlan,
                        qp_c: int, lam_rd: float, bitdepth: int = 8):
    """--rd 3 chroma-mode RDO: for every CU evaluate the four Table 8-3
    list candidates plus DM with a TRUE transform+quant roundtrip on
    BOTH chroma planes; argmin of SSD + lambda*(coeff rate + signalling
    bits).  Open-loop source-pixel refs like the luma search — the
    wavefront recon then honors exact dependencies.

    The device recast of kvz_search_cu_intra_chroma
    (src/search_intra.c:736): all CUs x 5 candidates in one batch
    instead of the reference's per-CU recursion.

    cbp/crp: (H/2, W/2) int32 source chroma planes (coded size).
    luma_modes: (By, Bx) int32 chosen luma modes.
    Returns (By, Bx) int32 actual chroma prediction modes."""
    from kvazaar_jax.ops.quant import dequantize, quantize
    from kvazaar_jax.ops.rate import tb_rate_bits
    from kvazaar_jax.ops.transform import (forward_transform,
                                           inverse_transform)
    maps = plan.chroma
    s2 = maps.size
    by, bx = plan.blocks_y, plan.blocks_x
    n = by * bx
    gidx = fetch(plan_gidx_key(plan, False),
                 lambda: plan_flat_gather(plan, False))     # (N, R)
    noref = jnp.asarray(plan_flat_noref(plan, False))       # (N,)
    lm = luma_modes.reshape(-1).astype(jnp.int32)           # (N,)
    cand = jnp.concatenate(
        [chroma_cand_table(lm), lm[:, None]], axis=1)       # (N, 5)

    def plane_costs(plane):
        flat_ext = jnp.concatenate([plane.reshape(-1),
                                    jnp.zeros((1,), plane.dtype)])
        refs = flat_ext[gidx]
        refs = jnp.where(noref[:, None], 1 << (bitdepth - 1), refs)
        preds = predict_all_modes(refs.astype(jnp.int32), s2,
                                  luma=False, bitdepth=bitdepth)
        sel = jnp.take_along_axis(
            preds, cand[:, :, None, None], axis=1)          # (N,5,S,S)
        orig = plane.reshape(by, s2, bx, s2).transpose(0, 2, 1, 3)
        orig = orig.reshape(n, 1, s2, s2).astype(jnp.int32)
        resid = (orig - sel).reshape(n * 5, s2, s2)
        coeff = forward_transform(resid, s2, bitdepth)
        levels = quantize(coeff, qp_c, s2, bitdepth, intra=True)
        dq = dequantize(levels, qp_c, s2, bitdepth)
        rrec = inverse_transform(dq, s2, bitdepth)
        err = (rrec - resid).astype(jnp.float32)
        ssd = jnp.sum(err * err, axis=(-2, -1)).reshape(n, 5)
        rate = tb_rate_bits(levels).reshape(n, 5)
        return ssd + lam_rd * rate

    cost = plane_costs(cbp) + plane_costs(crp)
    # intra_chroma_pred_mode bits (9.3.3.8): DM = 1 ctx bin, explicit
    # = 1 ctx bin + 2 bypass.
    sig = jnp.asarray([3.0, 3.0, 3.0, 3.0, 1.0])
    cost = cost + lam_rd * sig[None, :]
    pick = jnp.argmin(cost, axis=1)                         # (N,)
    cmode = jnp.take_along_axis(cand, pick[:, None],
                                axis=1)[:, 0].astype(jnp.int32)
    return cmode.reshape(by, bx)


def modes64_from_satd32(satd32, lambda_satd: float,
                        two_pass: bool = True):
    """Best single-mode 64x64 CU from the four 32x32 TBs' per-mode
    SATDs (a 64 intra CU forces the TU split to 32x32 TBs, 7.3.8.8 —
    its prediction IS four same-mode 32x32 TB predictions, 8.4.4.2).

    satd32: (By, Bx, 35).  Returns ((By//2, Bx//2) modes, cost grid);
    partial CTUs (odd trailing 32-blocks) are excluded by the caller.
    """
    by, bx = satd32.shape[0] // 2, satd32.shape[1] // 2
    s4 = (satd32[0::2, 0::2][:by, :bx]
          + satd32[0::2, 1::2][:by, :bx]
          + satd32[1::2, 0::2][:by, :bx]
          + satd32[1::2, 1::2][:by, :bx]).astype(jnp.float32)
    modes1 = jnp.argmin(s4, axis=-1).astype(jnp.int32)
    if not two_pass:
        return modes1, jnp.min(s4, axis=-1)
    bits = mode_bits_table(modes1, 64)
    cost = s4 + lambda_satd * bits
    modes = jnp.argmin(cost, axis=-1).astype(jnp.int32)
    return modes, jnp.min(cost, axis=-1)
