"""Variable-CU quadtree search + data-driven wavefront reconstruction.

The reference searches the quadtree recursively per CTU with pruning
(search_cu, /root/reference/src/search.c:424-757).  Device design: evaluate
ALL candidate CU sizes for the whole frame in parallel (three open-loop
mode searches), then choose the tree by a bottom-up segmented argmin
with lambda-weighted split-flag bits — evaluate-everything-then-argmin
replaces branch-and-prune (SURVEY.md §7).

Because the chosen tree is content-dependent, the reconstruction
schedule cannot be baked into the compiled program like the fixed-grid
path: a host-side planner (numpy) derives decode order, per-CU reference
availability/substitution (H.265 6.4.1, 8.4.4.2.2), and a wavefront
step assignment from the tree, and hands the device index tensors as
DATA.  The device program is compiled per (n_steps bucket, slot
capacities) and reused across frames.

Edge state generalizes the fixed-grid buffers: every reference sample
of any CU sits on a row y%8==7 (a CU bottom row) or a column x%8==7 (a
CU right column), so two flat buffers at 8-pixel granularity serve all
CU sizes (the mixed-size form of the reference's hor/ver boundary
buffers, src/encoderstate.h:170-186).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from kvazaar_jax.encoder.geometry import make_intra_plan
from kvazaar_jax.encoder.intra_search import search_frame_modes

SIZES = (8, 16, 32)


def search_quadtree(y, width: int, height: int, lambda_satd: float,
                    bitdepth: int = 8, min_cu: int = 8,
                    max_cu: int = 32, two_pass: bool = True,
                    rdo: bool = False, qp: int = 30,
                    lam_rd: float = None, tu_split: bool = False):
    """Open-loop mode search at every candidate CU size (device part).

    y: (H, W) int32 coded-size luma.  Returns (costs, modes): dicts
    size -> (H/s, W/s) grids of per-CU cost / best mode — SATD+lambda*
    modebits at rd<=1, true roundtrip SSD+lam*rate at rd 2 (the
    reference's search_intra_rdo depth, src/search_intra.c:573).
    64x64 CUs are evaluated as same-mode sums of the four 32x32 TBs
    (they force the TU split, 7.3.8.8).  The tree argmin happens on
    the host (choose_tree)."""
    from kvazaar_jax.encoder.intra_search import (modes64_from_satd32,
                                                  rd_cost_given_modes)
    if lam_rd is None:
        lam_rd = lambda_satd * lambda_satd
    costs = {}
    modes = {}
    for s in SIZES:
        if s < min_cu or s > max_cu:
            continue
        plan = make_intra_plan(width, height, s, chroma=False)
        if s == 32 and max_cu >= 64:
            m, c, satd32 = search_frame_modes(
                y, plan, lambda_satd, bitdepth, two_pass,
                return_satd=True, rdo=rdo, qp=qp, lam_rd=lam_rd)
            m64, _c64 = modes64_from_satd32(satd32, lambda_satd,
                                            two_pass)
            # 64 level in the same RD units as the leaves: roundtrip
            # the four 32 TBs with the chosen 64 mode + per-CU bins.
            m64up = jnp.repeat(jnp.repeat(m64, 2, 0), 2, 1)
            by32, bx32 = plan.blocks_y, plan.blocks_x
            pad = jnp.zeros((by32, bx32), jnp.int32)
            pad = pad.at[:m64up.shape[0], :m64up.shape[1]].set(
                m64up)
            cg = rd_cost_given_modes(y, plan, pad, qp,
                                     lam_rd, bitdepth)
            by64, bx64 = m64.shape
            c64 = (cg[0::2, 0::2][:by64, :bx64]
                   + cg[0::2, 1::2][:by64, :bx64]
                   + cg[1::2, 0::2][:by64, :bx64]
                   + cg[1::2, 1::2][:by64, :bx64]
                   + lam_rd * (INTRA_MODE_BINS
                               + OVERHEAD_BINS_INTRA))
            modes[64], costs[64] = m64, c64
        else:
            m, c = search_frame_modes(y, plan, lambda_satd, bitdepth,
                                      two_pass, rdo=rdo, qp=qp,
                                      lam_rd=lam_rd)
        modes[s] = m
        # RD-unit leaf costs (the reference compares kvz_cu_rd_cost at
        # every depth, src/search.c:236, regardless of rd level):
        # rdo costs are already roundtrip SSD + lam*(TB rate + mode
        # bits) — add the CU overhead bins; non-rdo SATD costs are
        # re-costed with a roundtrip at the winner mode.
        if rdo:
            costs[s] = c + lam_rd * OVERHEAD_BINS_INTRA
        else:
            costs[s] = intra_rd_recost(y, plan, m, qp, lam_rd,
                                       bitdepth, p_slice=False)
    if not tu_split:
        return costs, modes
    # --tr-depth-intra 1: cost each 16/32 CU ALSO as four half-size
    # TBs sharing the CU's mode (one explicit split_transform_flag
    # level, 7.3.8.8; reference search_intra_trdepth
    # src/search_intra.c:189).  Same RD units as costs[s]; the
    # roundtrip at TB granularity captures the prediction gain of
    # intra refs advancing inside the CU only partially (open-loop
    # refs), but the 4x independent last-sig/rate structure is exact.
    tucosts = {}
    for s in (16, 32):
        # The half-size class must exist in the scan (its TBs ride the
        # s/2 recon class), so min_cu bounds the splittable sizes.
        if s not in modes or s // 2 < min_cu:
            continue
        plan_h = make_intra_plan(width, height, s // 2, chroma=False)
        mh = jnp.repeat(jnp.repeat(modes[s], 2, 0), 2, 1)
        pad = jnp.zeros((plan_h.blocks_y, plan_h.blocks_x), jnp.int32)
        pad = pad.at[:mh.shape[0], :mh.shape[1]].set(mh)
        cg = rd_cost_given_modes(y, plan_h, pad, qp, lam_rd, bitdepth)
        by_, bx_ = modes[s].shape
        tc = (cg[0::2, 0::2][:by_, :bx_] + cg[0::2, 1::2][:by_, :bx_]
              + cg[1::2, 0::2][:by_, :bx_]
              + cg[1::2, 1::2][:by_, :bx_])
        tucosts[s] = tc + lam_rd * (INTRA_MODE_BINS
                                    + OVERHEAD_BINS_INTRA
                                    + TU_SPLIT_EXTRA_BINS)
    return costs, modes, tucosts


def choose_tree(costs: dict, width: int, height: int,
                lambda_satd: float, percu_bits: float = 0.0,
                split_bits: float = 1.0,
                tucosts: dict | None = None) -> np.ndarray:
    """Bottom-up tree argmin (host numpy).  Per-CU costs arrive in RD
    units with their own syntax-overhead bins included (roundtrip
    recost in the searches — the device form of the reference comparing
    kvz_cu_rd_cost at every depth, src/search.c:236,424); the argmin
    adds only the split-flag bins per split.  Returns size8
    (H/8, W/8) uint8 — or (size8, trsplit8) when tucosts is given
    (--tr-depth-intra: each 16/32 candidate enters the argmin at
    min(whole-TB, four-half-TB) cost and the winner's TU choice is
    recorded)."""
    percu = lambda_satd * percu_bits
    split = lambda_satd * split_bits
    c = {s: np.asarray(v).astype(np.float64) for s, v in costs.items()}
    tr_pick = {}
    if tucosts:
        for s, tc in tucosts.items():
            if s not in c:
                continue
            tc = np.asarray(tc).astype(np.float64)
            pick = tc < c[s]
            c[s] = np.where(pick, tc, c[s])
            tr_pick[s] = pick
    use8 = None
    if 8 in c and 16 in c:
        c8sum = (c[8][0::2, 0::2] + c[8][0::2, 1::2]
                 + c[8][1::2, 0::2] + c[8][1::2, 1::2] + 3 * percu)
        use8 = c8sum + split < c[16]
        c16 = np.where(use8, c8sum + split, c[16])
    elif 16 in c:
        c16 = c[16]
        use8 = np.zeros_like(c16, bool)
    use16 = None
    c32 = None
    if 32 in c and 16 in c:
        c16sum = (c16[0::2, 0::2] + c16[0::2, 1::2]
                  + c16[1::2, 0::2] + c16[1::2, 1::2] + 3 * percu)
        use16 = c16sum + split < c[32]
        c32 = np.where(use16, c16sum + split, c[32])
    elif 32 in c:
        c32 = c[32]
    elif 16 in c:
        use16 = np.ones((c16.shape[0] // 2, c16.shape[1] // 2), bool)

    # 64x64 level: full CTUs only (boundary CTUs take inferred splits).
    use32 = None
    if 64 in c and c32 is not None:
        by64, bx64 = c[64].shape
        c32sum = (c32[0::2, 0::2][:by64, :bx64]
                  + c32[0::2, 1::2][:by64, :bx64]
                  + c32[1::2, 0::2][:by64, :bx64]
                  + c32[1::2, 1::2][:by64, :bx64] + 3 * percu)
        use32 = c32sum + split < c[64]

    h8, w8 = height // 8, width // 8
    top = 32 if 32 in c else 16
    size8 = np.full((h8, w8), top, np.int32)
    eff32 = np.ones((h8, w8), bool)
    if use32 is not None:
        u64 = np.zeros((h8, w8), bool)
        full = np.kron(~use32, np.ones((8, 8), bool))
        u64[:full.shape[0], :full.shape[1]] = full
        size8 = np.where(u64, 64, size8)
        eff32 = ~u64
    if use16 is not None and 32 in c:
        u16 = np.kron(use16, np.ones((4, 4), bool))[:h8, :w8]
        size8 = np.where(eff32 & u16, 16, size8)
        eff16 = eff32 & u16
    else:
        eff16 = eff32
    if use8 is not None:
        u8 = np.kron(use8, np.ones((2, 2), bool))[:h8, :w8]
        size8 = np.where(eff16 & u8, 8, size8)
    size8 = size8.astype(np.uint8)
    if tucosts is None:
        return size8
    trsplit8 = np.zeros((h8, w8), np.uint8)
    for s, pick in tr_pick.items():
        cell = s // 8
        up = np.kron(pick, np.ones((cell, cell), bool))[:h8, :w8]
        trsplit8 = np.where((size8 == s) & up, 1, trsplit8
                            ).astype(np.uint8)
    return size8, trsplit8


# ---------------------------------------------------------------------
# RD-unit tree costing: the reference's search_cu reconstructs the
# winning mode and compares REAL rd costs (SSD + CABAC-estimated bits,
# kvz_cu_rd_cost_luma src/search.c:236) at every depth, regardless of
# rd level (the rd level only deepens the MODE search).  Device form: one
# luma roundtrip per candidate size over the whole frame, rate from the
# vectorized TB model (ops/rate.py), plus syntax-derived per-CU
# overhead bins — no hand-tuned per-CU constants.
# ---------------------------------------------------------------------

# Context-bin counts of the CU-level syntax not carried by the TB rate
# model (which includes cbf_luma): intra = part/pred flags (~1) +
# intra_chroma_pred_mode (~1.5) + chroma cbfs (2); inter = merge_flag
# (1) + rqt_root_cbf (1) + chroma cbfs (2).  Derived from the syntax
# structure (encode_coding_tree.c), not fit to outcomes.
OVERHEAD_BINS_INTRA = 4.5
OVERHEAD_BINS_INTER = 4.0
INTRA_MODE_BINS = 2.5      # MPM-weighted average of mpm_idx/rem coding
SPLIT_FLAG_BINS = 1.0
# Extra structure bins a one-level TU split pays over a single TB:
# 3 extra cbf_luma + ~2 chroma-cbf re-codings (split_transform_flag
# itself is coded either way when the SPS enables the level).
TU_SPLIT_EXTRA_BINS = 5.0


def tb_rd_cost(resid, s: int, qp, lam_rd, bitdepth: int,
               intra: bool):
    """(N,) luma roundtrip RD cost of (N, s, s) int32 residuals:
    SSD + lam * modeled TB bits (s <= 32)."""
    from kvazaar_jax.ops.quant import dequantize, quantize
    from kvazaar_jax.ops.rate import tb_rate_bits
    from kvazaar_jax.ops.transform import (forward_transform,
                                           inverse_transform)
    coeff = forward_transform(resid, s, bitdepth)
    levels = quantize(coeff, qp, s, bitdepth, intra=intra)
    dq = dequantize(levels, qp, s, bitdepth, intra=intra)
    rrec = inverse_transform(dq, s, bitdepth)
    err = (rrec - resid).astype(jnp.float32)
    ssd = jnp.sum(err * err, axis=(-2, -1))
    return ssd + lam_rd * tb_rate_bits(levels)


def inter_rd_grid(y, pred_blocks, s: int, by: int, bx: int, qp,
                  lam_rd, bitdepth: int):
    """(by, bx) inter RD cost grid from MC pred blocks (N, s, s):
    roundtrip cost with 32-max TU tiling for 64 CUs."""
    n = by * bx
    orig = y[:by * s, :bx * s].reshape(by, s, bx, s)
    orig = orig.transpose(0, 2, 1, 3).reshape(n, s, s)
    resid = orig.astype(jnp.int32) - pred_blocks
    if s <= 32:
        c = tb_rd_cost(resid, s, qp, lam_rd, bitdepth, intra=False)
        return c.reshape(by, bx)
    # 64: four 32x32 TBs (max transform size).
    r4 = resid.reshape(n, 2, 32, 2, 32).transpose(0, 1, 3, 2, 4)
    c4 = tb_rd_cost(r4.reshape(n * 4, 32, 32), 32, qp, lam_rd,
                    bitdepth, intra=False)
    return c4.reshape(by, bx, 4).sum(axis=-1)


def _mc_blocks_at(ref, mvs_grid, s: int, bitdepth: int):
    """Uni-rounded MC luma blocks (N, s, s) at a per-CU qpel MV grid."""
    from kvazaar_jax.encoder.inter_search import _luma_hp_blocks
    from kvazaar_jax.ops.inter import uni_round
    by, bx = mvs_grid.shape[:2]
    n = by * bx
    ys_, xs_ = np.mgrid[0:by, 0:bx]
    x0s = jnp.asarray((xs_ * s).reshape(-1))
    y0s = jnp.asarray((ys_ * s).reshape(-1))
    return uni_round(_luma_hp_blocks(ref, x0s, y0s,
                                     mvs_grid.reshape(n, 2), s,
                                     bitdepth), bitdepth)


def _mv_rate_grid(mvs_grid):
    from kvazaar_jax.encoder.inter_search import (_mv_bits_est,
                                                  _mv_pred_grid)
    p = _mv_pred_grid(mvs_grid)
    return (_mv_bits_est(mvs_grid[..., 0] - p[..., 0])
            + _mv_bits_est(mvs_grid[..., 1] - p[..., 1]))


def intra_rd_recost(y, plan, modes_grid, qp, lam_rd, bitdepth,
                    p_slice: bool):
    """Intra RD-unit cost grid for the winner modes: luma roundtrip +
    mode bins + CU overhead bins (+pred_mode_flag on P/B slices)."""
    from kvazaar_jax.encoder.intra_search import rd_cost_given_modes
    extra = INTRA_MODE_BINS + OVERHEAD_BINS_INTRA + (
        1.0 if p_slice else 0.0)
    return rd_cost_given_modes(y, plan, modes_grid, qp, lam_rd,
                               bitdepth) + lam_rd * extra


# ---------------------------------------------------------------------
# Inter (P/B) quadtree search: dense ME at every candidate CU size +
# per-size intra-vs-inter argmin; the tree choice reuses choose_tree on
# the combined costs (reference: search_cu tries inter then intra per
# depth, src/search.c:424-757 + kvz_search_cu_inter
# src/search_inter.c:1588).
# ---------------------------------------------------------------------

def _inf_grid(width, height, s):
    return jnp.full((height // s, width // s), jnp.inf, jnp.float32)


def _plan64(width: int, height: int):
    """Lightweight 64-grid geometry over the 64-aligned crop
    (boundary CTUs take inferred splits, so 64 CUs never reach them)."""
    import types
    w64, h64 = (width // 64) * 64, (height // 64) * 64
    return types.SimpleNamespace(cu_size=64, blocks_y=h64 // 64,
                                 blocks_x=w64 // 64, width=w64,
                                 height=h64), w64, h64


def search_quadtree_p(y, ref_y, width: int, height: int,
                      lambda_satd: float, me_range: int,
                      bitdepth: int = 8, intra_rng=(8, 32),
                      inter_rng=(8, 32), two_pass: bool = True,
                      subpel: bool = True, qp=30, lam_rd=None):
    """Device search for a P variable tree.  Returns per-size dicts
    (keys may include 64): costs (RD units: luma roundtrip SSD +
    lam*modeled bits of the intra/inter winner — the device form of
    kvz_cu_rd_cost_luma, src/search.c:236), modes (intra winners),
    mvs (qpel, (H/s, W/s, 2)), inter_maps (bool, decided on the RD
    costs).  Sizes outside a tool's [min, max] range take +inf for
    that tool (the reference's --pu-depth-intra/inter semantics,
    src/cfg.c)."""
    from kvazaar_jax.encoder.inter_search import search_inter_frame
    from kvazaar_jax.encoder.intra_search import (modes64_from_satd32,
                                                  rd_cost_given_modes,
                                                  search_frame_modes)
    from kvazaar_jax.ops.inter import coarse_mv_grids
    if lam_rd is None:
        lam_rd = lambda_satd * lambda_satd
    sizes = [s for s in SIZES
             if (intra_rng[0] <= s <= intra_rng[1]
                 or inter_rng[0] <= s <= inter_rng[1])]
    want64 = intra_rng[1] >= 64 or inter_rng[1] >= 64
    costs, modes, mvs, imaps = {}, {}, {}, {}
    icost64 = modes64 = None
    # Hierarchical ME: one ds4 dense coarse pass for the whole size
    # ladder, full-res refinement inside search_inter_frame.
    inter_sizes = [s for s in sizes
                   if inter_rng[0] <= s <= inter_rng[1]]
    if inter_rng[1] >= 64 and (width // 64) and (height // 64):
        inter_sizes = inter_sizes + [64]
    hints = (coarse_mv_grids(y, ref_y, me_range, tuple(inter_sizes),
                             bitdepth) if inter_sizes else {})
    for s in sizes:
        plan = make_intra_plan(width, height, s, chroma=False)
        by, bx = plan.blocks_y, plan.blocks_x
        intra_ok = intra_rng[0] <= s <= intra_rng[1]
        inter_ok = inter_rng[0] <= s <= inter_rng[1]
        if intra_ok:
            if s == 32 and want64 and intra_rng[1] >= 64:
                m, _ic, satd32 = search_frame_modes(
                    y, plan, lambda_satd, bitdepth, two_pass,
                    return_satd=True)
                modes64, icost64 = modes64_from_satd32(
                    satd32, lambda_satd, two_pass)
            else:
                m, _ic = search_frame_modes(y, plan, lambda_satd,
                                            bitdepth, two_pass)
            ir = intra_rd_recost(y, plan, m, qp, lam_rd, bitdepth,
                                 p_slice=True)
        else:
            m = jnp.zeros((height // s, width // s), jnp.int32)
            ir = _inf_grid(width, height, s)
        if inter_ok:
            mv, _mc = search_inter_frame(y, ref_y, plan, lambda_satd,
                                         me_range, bitdepth,
                                         subpel=subpel,
                                         mv_hint=hints[s])
            pred = _mc_blocks_at(ref_y, mv, s, bitdepth)
            er = inter_rd_grid(y, pred, s, by, bx, qp, lam_rd,
                               bitdepth) + lam_rd * (
                _mv_rate_grid(mv) + 1.0 + OVERHEAD_BINS_INTER)
        else:
            mv = jnp.zeros((height // s, width // s, 2), jnp.int32)
            er = _inf_grid(width, height, s)
        imap = er <= ir
        costs[s] = jnp.where(imap, er, ir)
        modes[s] = m
        mvs[s] = jnp.where(imap[..., None], mv, 0).astype(jnp.int32)
        imaps[s] = imap
    if want64 and (width // 64) and (height // 64):
        plan64, w64, h64 = _plan64(width, height)
        by64, bx64 = h64 // 64, w64 // 64
        if modes64 is not None and intra_rng[1] >= 64:
            # RD recost of the 64 intra candidate: four 32x32 TBs with
            # the chosen 64 mode (forced TU split, 7.3.8.8).
            plan32 = make_intra_plan(width, height, 32, chroma=False)
            m64up = jnp.repeat(jnp.repeat(modes64, 2, 0), 2, 1)
            pad = jnp.zeros((plan32.blocks_y, plan32.blocks_x),
                            jnp.int32)
            pad = pad.at[:m64up.shape[0], :m64up.shape[1]].set(m64up)
            cg = rd_cost_given_modes(y, plan32, pad, qp, lam_rd,
                                     bitdepth)
            ir64 = (cg[0::2, 0::2][:by64, :bx64]
                    + cg[0::2, 1::2][:by64, :bx64]
                    + cg[1::2, 0::2][:by64, :bx64]
                    + cg[1::2, 1::2][:by64, :bx64]
                    + lam_rd * (INTRA_MODE_BINS
                                + OVERHEAD_BINS_INTRA + 1.0))
        else:
            modes64 = jnp.zeros((by64, bx64), jnp.int32)
            ir64 = jnp.full((by64, bx64), jnp.inf, jnp.float32)
        if inter_rng[1] >= 64:
            mv64, _mc64 = search_inter_frame(
                y[:h64, :w64], ref_y[:h64, :w64], plan64, lambda_satd,
                me_range, bitdepth, subpel=subpel,
                mv_hint=hints[64])
            pred64 = _mc_blocks_at(ref_y, mv64, 64, bitdepth)
            er64 = inter_rd_grid(y[:h64, :w64], pred64, 64, by64,
                                 bx64, qp, lam_rd, bitdepth) \
                + lam_rd * (_mv_rate_grid(mv64) + 1.0
                            + OVERHEAD_BINS_INTER)
        else:
            mv64 = jnp.zeros((by64, bx64, 2), jnp.int32)
            er64 = jnp.full((by64, bx64), jnp.inf, jnp.float32)
        imap64 = er64 <= ir64
        costs[64] = jnp.where(imap64, er64, ir64)
        modes[64] = modes64
        mvs[64] = jnp.where(imap64[..., None], mv64,
                            0).astype(jnp.int32)
        imaps[64] = imap64
    return costs, modes, mvs, imaps


def search_quadtree_b(y, r0_y, r1_y, width: int, height: int,
                      lambda_satd: float, me_range: int,
                      bitdepth: int = 8, intra_rng=(8, 32),
                      inter_rng=(8, 32), two_pass: bool = True,
                      subpel: bool = True, bipred: bool = True,
                      qp=30, lam_rd=None):
    """Device search for a B variable tree: per size, L0/L1 ME + a
    bi-pred SATD check; combined RD-unit cost vs intra (roundtrip
    recost like search_quadtree_p).  Returns (costs, modes, mv0s,
    mv1s, dirss, inter_maps) per-size dicts."""
    from kvazaar_jax.encoder.inter_search import (_mv_bits_est,
                                                  _mv_pred_grid,
                                                  search_inter_frame)
    from kvazaar_jax.encoder.intra_search import (modes64_from_satd32,
                                                  rd_cost_given_modes,
                                                  satd8_batch,
                                                  search_frame_modes)
    from kvazaar_jax.ops.inter import (bi_average, coarse_mv_grids,
                                       mc_luma_hp, uni_round)
    if lam_rd is None:
        lam_rd = lambda_satd * lambda_satd
    sizes = [s for s in SIZES
             if (intra_rng[0] <= s <= intra_rng[1]
                 or inter_rng[0] <= s <= inter_rng[1])]
    want64 = intra_rng[1] >= 64 or inter_rng[1] >= 64
    out_c, out_m, out_mv0, out_mv1, out_d, out_i = ({}, {}, {}, {},
                                                    {}, {})
    # One ds4 coarse pass per reference list for the whole size ladder.
    inter_sizes = [s for s in sizes
                   if inter_rng[0] <= s <= inter_rng[1]]
    if inter_rng[1] >= 64 and (width // 64) and (height // 64):
        inter_sizes = inter_sizes + [64]
    hints0 = (coarse_mv_grids(y, r0_y, me_range, tuple(inter_sizes),
                              bitdepth) if inter_sizes else {})
    hints1 = (coarse_mv_grids(y, r1_y, me_range, tuple(inter_sizes),
                              bitdepth) if inter_sizes else {})

    def inter_at(cur, r0, r1, plan, hint0=None, hint1=None):
        mv0, c0 = search_inter_frame(cur, r0, plan, lambda_satd,
                                     me_range, bitdepth, subpel=subpel,
                                     mv_hint=hint0)
        mv1, c1 = search_inter_frame(cur, r1, plan, lambda_satd,
                                     me_range, bitdepth, subpel=subpel,
                                     mv_hint=hint1)
        s = plan.cu_size
        by, bx = plan.blocks_y, plan.blocks_x
        n = by * bx
        ys_, xs_ = np.mgrid[0:by, 0:bx]
        x0s = jnp.asarray((xs_ * s).reshape(-1))
        y0s = jnp.asarray((ys_ * s).reshape(-1))
        hp0 = mc_luma_hp(r0, x0s, y0s, mv0.reshape(n, 2), s, bitdepth)
        hp1 = mc_luma_hp(r1, x0s, y0s, mv1.reshape(n, 2), s, bitdepth)
        bi = bi_average(hp0, hp1, bitdepth)
        cb = cur.reshape(by, s, bx, s).transpose(0, 2, 1, 3)
        cb = cb.reshape(n, s, s).astype(jnp.int32)
        satd_bi = satd8_batch(bi - cb).reshape(by, bx)
        p0 = _mv_pred_grid(mv0)
        p1 = _mv_pred_grid(mv1)
        rate = (_mv_bits_est(mv0[..., 0] - p0[..., 0])
                + _mv_bits_est(mv0[..., 1] - p0[..., 1])
                + _mv_bits_est(mv1[..., 0] - p1[..., 0])
                + _mv_bits_est(mv1[..., 1] - p1[..., 1]))
        cbi = satd_bi.astype(jnp.float32) + lambda_satd * rate
        if not bipred:
            cbi = jnp.full_like(cbi, jnp.inf)
        cc = jnp.stack([c0, c1, cbi])
        dirs = jnp.argmin(cc, axis=0).astype(jnp.int32)
        # RD recost of the selected hypothesis: roundtrip the selected
        # prediction + per-list mv rate + inter_pred_idc (~2 bins).
        dn = dirs.reshape(n, 1, 1)
        pred_sel = jnp.where(dn == 0, uni_round(hp0, bitdepth),
                             jnp.where(dn == 1,
                                       uni_round(hp1, bitdepth),
                                       bi_average(hp0, hp1, bitdepth)))
        r0b = (_mv_bits_est(mv0[..., 0] - p0[..., 0])
               + _mv_bits_est(mv0[..., 1] - p0[..., 1]))
        r1b = (_mv_bits_est(mv1[..., 0] - p1[..., 0])
               + _mv_bits_est(mv1[..., 1] - p1[..., 1]))
        rate_sel = jnp.where(dirs == 0, r0b,
                             jnp.where(dirs == 1, r1b, r0b + r1b))
        er = inter_rd_grid(cur, pred_sel, s, by, bx, qp, lam_rd,
                           bitdepth) + lam_rd * (
            rate_sel + 2.0 + 1.0 + OVERHEAD_BINS_INTER)
        return mv0, mv1, dirs, er

    modes64 = None
    for s in sizes:
        plan = make_intra_plan(width, height, s, chroma=False)
        intra_ok = intra_rng[0] <= s <= intra_rng[1]
        if intra_ok:
            if s == 32 and want64 and intra_rng[1] >= 64:
                m, _ic, satd32 = search_frame_modes(
                    y, plan, lambda_satd, bitdepth, two_pass,
                    return_satd=True)
                modes64, _ic64 = modes64_from_satd32(
                    satd32, lambda_satd, two_pass)
            else:
                m, _ic = search_frame_modes(y, plan, lambda_satd,
                                            bitdepth, two_pass)
            ir = intra_rd_recost(y, plan, m, qp, lam_rd, bitdepth,
                                 p_slice=True)
        else:
            m = jnp.zeros((height // s, width // s), jnp.int32)
            ir = _inf_grid(width, height, s)
        if inter_rng[0] <= s <= inter_rng[1]:
            mv0, mv1, dirs, er = inter_at(y, r0_y, r1_y, plan,
                                          hints0[s], hints1[s])
        else:
            z = jnp.zeros((height // s, width // s, 2), jnp.int32)
            mv0 = mv1 = z
            dirs = jnp.zeros((height // s, width // s), jnp.int32)
            er = _inf_grid(width, height, s)
        imap = er <= ir
        out_c[s] = jnp.where(imap, er, ir)
        out_m[s] = m
        out_mv0[s] = jnp.where(imap[..., None], mv0,
                               0).astype(jnp.int32)
        out_mv1[s] = jnp.where(imap[..., None], mv1,
                               0).astype(jnp.int32)
        out_d[s] = jnp.where(imap, dirs, 0)
        out_i[s] = imap
    if want64 and (width // 64) and (height // 64):
        plan64, w64, h64 = _plan64(width, height)
        by64, bx64 = h64 // 64, w64 // 64
        if modes64 is not None and intra_rng[1] >= 64:
            plan32 = make_intra_plan(width, height, 32, chroma=False)
            m64up = jnp.repeat(jnp.repeat(modes64, 2, 0), 2, 1)
            pad = jnp.zeros((plan32.blocks_y, plan32.blocks_x),
                            jnp.int32)
            pad = pad.at[:m64up.shape[0], :m64up.shape[1]].set(m64up)
            cg = rd_cost_given_modes(y, plan32, pad, qp, lam_rd,
                                     bitdepth)
            ir64 = (cg[0::2, 0::2][:by64, :bx64]
                    + cg[0::2, 1::2][:by64, :bx64]
                    + cg[1::2, 0::2][:by64, :bx64]
                    + cg[1::2, 1::2][:by64, :bx64]
                    + lam_rd * (INTRA_MODE_BINS
                                + OVERHEAD_BINS_INTRA + 1.0))
        else:
            modes64 = jnp.zeros((by64, bx64), jnp.int32)
            ir64 = jnp.full((by64, bx64), jnp.inf, jnp.float32)
        if inter_rng[1] >= 64:
            mv0, mv1, dirs, er64 = inter_at(
                y[:h64, :w64], r0_y[:h64, :w64], r1_y[:h64, :w64],
                plan64, hints0[64], hints1[64])
        else:
            z = jnp.zeros((by64, bx64, 2), jnp.int32)
            mv0 = mv1 = z
            dirs = jnp.zeros((by64, bx64), jnp.int32)
            er64 = jnp.full((by64, bx64), jnp.inf, jnp.float32)
        imap64 = er64 <= ir64
        out_c[64] = jnp.where(imap64, er64, ir64)
        out_m[64] = modes64
        out_mv0[64] = jnp.where(imap64[..., None], mv0,
                                0).astype(jnp.int32)
        out_mv1[64] = jnp.where(imap64[..., None], mv1,
                                0).astype(jnp.int32)
        out_d[64] = jnp.where(imap64, dirs, 0)
        out_i[64] = imap64
    return out_c, out_m, out_mv0, out_mv1, out_d, out_i


def build_cell_fields(size8: np.ndarray, imaps: dict, mv_grids: dict,
                      extra_grids: tuple = ()):
    """Expand per-size CU decisions onto the 8x8-cell grid following
    the chosen tree: inter8 (h8, w8) bool, mv_cells (h8, w8, 2) int32,
    plus one expanded grid per entry of extra_grids (each a dict
    size -> (H/s, W/s[, 2]) array).  Owner lookups are at CU origins
    (cells are z-aligned)."""
    h8, w8 = size8.shape
    inter8 = np.zeros((h8, w8), bool)
    mv_cells = np.zeros((h8, w8, 2), np.int32)
    extras = []
    for g in extra_grids:
        sample = next(iter(g.values()))
        shape = (h8, w8) + sample.shape[2:]
        extras.append(np.zeros(shape, sample.dtype))
    for s in sorted(imaps.keys()):
        c = s // 8
        sel = size8 == s                      # cell-filled owner mask
        if not sel.any():
            continue
        oy = (np.arange(h8) // c)
        ox = (np.arange(w8) // c)

        # Per-size grids may be cropped (64 level): pad with zeros.
        def up(grid):
            g = np.asarray(grid)
            gy, gx = g.shape[0], g.shape[1]
            out = np.zeros((h8,) + (w8,) + g.shape[2:], g.dtype)
            yy = np.minimum(oy, gy - 1)
            xx = np.minimum(ox, gx - 1)
            filled = g[np.ix_(yy, xx)]
            valid = ((oy < gy)[:, None] & (ox < gx)[None, :])
            out[valid] = filled[valid]
            return out
        im = up(imaps[s]).astype(bool)
        inter8 = np.where(sel, im, inter8)
        mvu = up(mv_grids[s])
        mv_cells = np.where(sel[..., None] & im[..., None], mvu,
                            mv_cells)
        for i, g in enumerate(extra_grids):
            gu = up(g[s])
            if gu.ndim == 3:
                extras[i] = np.where(sel[..., None] & im[..., None],
                                     gu, extras[i])
            else:
                extras[i] = np.where(sel & im, gu, extras[i])
    return (inter8, mv_cells) + tuple(extras)


def var_edge_masks(size8: np.ndarray):
    """TU-boundary masks on the 8-cell grid for a variable tree:
    edge_v[y, x] = the LEFT edge of cell (y, x) is a TU boundary
    (64 CUs count their forced 32x32 TB edges, 8.7.2)."""
    c = np.minimum((size8 // 8).astype(np.int32), 4)
    x8 = np.arange(size8.shape[1])[None, :]
    y8 = np.arange(size8.shape[0])[:, None]
    return (x8 % c == 0), (y8 % c == 0)


def var_bs_maps(inter8, cbf8, mv_cells, edge_v, edge_h,
                mv1_cells=None, dirs8=None):
    """Deblock boundary strengths for a variable P/B tree on the
    8-cell grid (8.7.2.4): bs 2 when either side is intra (at a
    boundary), else 1 on cbf / MV-difference / direction mismatch.
    All inputs traced device arrays; PU edges coincide with CU edges
    (2Nx2N only)."""
    intra8 = ~inter8

    def edge(sl_a, sl_b, mask):
        a_i, b_i = intra8[sl_a], intra8[sl_b]
        cbf = cbf8[sl_a] | cbf8[sl_b]
        mvd = jnp.any(jnp.abs(mv_cells[sl_a] - mv_cells[sl_b]) >= 4,
                      axis=-1)
        if mv1_cells is not None:
            d_a, d_b = dirs8[sl_a], dirs8[sl_b]
            dif = d_a != d_b
            d1 = jnp.any(jnp.abs(mv1_cells[sl_a] - mv1_cells[sl_b])
                         >= 4, axis=-1)
            use0 = d_a != 1
            use1 = d_a != 0
            mvd = dif | (use0 & mvd) | (use1 & d1)
        bs = jnp.where(a_i | b_i, 2,
                       jnp.where(cbf | mvd, 1, 0)).astype(jnp.int32)
        return jnp.where(mask, bs, 0)

    h8, w8 = inter8.shape
    bs_v = jnp.zeros((h8, w8), jnp.int32)
    bs_h = jnp.zeros((h8, w8), jnp.int32)
    bs_v = bs_v.at[:, 1:].set(edge(
        (slice(None), slice(0, w8 - 1)), (slice(None), slice(1, w8)),
        edge_v[:, 1:]))
    bs_h = bs_h.at[1:, :].set(edge(
        (slice(0, h8 - 1), slice(None)), (slice(1, h8), slice(None)),
        edge_h[1:, :]))
    return bs_v, bs_h


# ---------------------------------------------------------------------
# Data-driven reconstruction (single frame; schedule tensors are traced
# inputs, so one compiled program per n_steps bucket serves all trees).
# ---------------------------------------------------------------------

def _class_pass(hbuf, vbuf, xs_c, s: int, qp: int, bitdepth: int,
                luma: bool, lossless: bool, signhide: bool,
                rdoq: bool = False, lam: float = 0.0,
                scaling_tab=None):
    """One wavefront step for one CU-size class.  hbuf/vbuf: flat edge
    buffers (+1 trash); xs_c: per-step slices of (origs (K,S,S), modes
    (K,), noref (K,), idx_h (K,R), idx_v, sel_h, wr_h (K,S), wr_v
    [, inter (K,), mc (K,S,S)]) — the optional tail carries P/B inter
    flags + motion-compensated prediction (no wavefront dependency;
    inter blocks still write their recon edges for intra neighbors)."""
    from kvazaar_jax.encoder.intra_recon import (_predict_select,
                                                 _scan_sel,
                                                 _tu_roundtrip)
    origs, modes, noref, idx_h, idx_v, sel_h, wr_h, wr_v = xs_c[:8]
    inter_k = mc = None
    if len(xs_c) > 8:
        inter_k, mc = xs_c[8], xs_c[9]
    k, r = idx_h.shape
    refs = jnp.where(sel_h, hbuf[idx_h], vbuf[idx_v])
    refs = jnp.where(noref[:, None], 1 << (bitdepth - 1), refs)
    pred = _predict_select(refs, modes, s, luma, bitdepth)
    intra_flag = True
    if inter_k is not None:
        pred = jnp.where(inter_k[:, None, None], mc, pred)
        intra_flag = ~inter_k
    # Min luma CU is 8 here, so the DST-VII 4x4 intra-luma path never
    # arises; 4x4 chroma TBs use the DCT as the spec requires.
    scan_sel = _scan_sel(modes, s, luma, inter_k) if signhide else None
    levels, rec, _ = _tu_roundtrip(origs.astype(jnp.int32), pred, s, qp,
                                bitdepth, intra_flag, lossless, scan_sel,
                                rdoq, lam, scaling_tab)
    hbuf = hbuf.at[wr_h.reshape(-1)].set(
        rec[:, -1, :].reshape(-1).astype(hbuf.dtype))
    vbuf = vbuf.at[wr_v.reshape(-1)].set(
        rec[:, :, -1].reshape(-1).astype(vbuf.dtype))
    return hbuf, vbuf, levels, rec


def reconstruct_frame_var(sched, qp: int, qp_c: int, width: int,
                          height: int, chroma: bool, bitdepth: int = 8,
                          lossless: bool = False,
                          signhide: bool = False, rdoq: bool = False,
                          lam: float = 0.0, scaling=None,
                          mc_planes=None):
    """sched: jnp-ified VarPlan tensors — {'luma': {size: {arrays}},
    'chroma': {size: {arrays incl. origs_cb/origs_cr}}} (see
    var_schedule.ClassSched; 'origs' carry the source pixels, gathered
    host-side through the same pixel maps).

    mc_planes: optional (mc_y (H, W), mc_cb, mc_cr) device MC
    prediction planes for P/B variable trees — gathered per class
    through the same pix maps; class dicts then carry 'inter' masks.

    Returns (rec_y (H, W), rec_cb, rec_cr, levels: dict[, cbf8]) —
    recon assembled on device via the per-class pixel scatter maps;
    levels per class as (steps, K, S, S) int16 in schedule order;
    with mc_planes, also the (H/8, W/8) bool luma per-TB cbf grid
    (deblock boundary strengths)."""
    lh_y = (height // 8) * width
    lv_y = (width // 8) * height
    carry0 = [jnp.zeros(lh_y + 1, jnp.int32),
              jnp.zeros(lv_y + 1, jnp.int32)]
    # cb and cr share geometry/modes/QP: one merged class pass per
    # size over a [cb | trash | cr | trash] edge-buffer pair halves
    # the chroma pass count per scan step.  Per-component scaling
    # lists need distinct quant tables per half -> split passes.
    merge_c = chroma and scaling is None
    if chroma:
        wc, hc = width // 2, height // 2
        lh_c = (hc // 4) * wc
        lv_c = (wc // 4) * hc
        if merge_c:
            carry0 += [jnp.zeros(2 * (lh_c + 1), jnp.int32),
                       jnp.zeros(2 * (lv_c + 1), jnp.int32)]
        else:
            carry0 += [jnp.zeros(lh_c + 1, jnp.int32),
                       jnp.zeros(lv_c + 1, jnp.int32)] * 2

    lsizes = sorted(sched["luma"].keys())
    csizes = sorted(sched["chroma"].keys()) if chroma else []
    inter = mc_planes is not None

    def _flat_ext(plane):
        return jnp.concatenate([plane.reshape(-1).astype(jnp.int32),
                                jnp.zeros(1, jnp.int32)])

    def derive(cs, s, plane_w, plane_h, gran, plane, extra=()):
        """Derive the big gather maps on device from the compact
        (x0, y0, valid, avail, corner_h) upload: ref-routing indices
        (idx_h/idx_v/sel_h with 8.4.4.2.2 substitution), pix (block
        pixel map), wr_h/wr_v (edge writes), origs (source gather),
        cell8 (luma 8-cell map) — the host used to upload these
        (~32 MB/frame)."""
        d = dict(cs)
        x0 = cs["x0"].astype(jnp.int32)
        y0 = cs["y0"].astype(jnp.int32)
        valid = cs["valid"]
        # Ref-sample coords in spec order (var_schedule._ref_coords).
        r = 4 * s + 1
        i_r = jnp.arange(r, dtype=jnp.int32)
        xs_r = jnp.where(i_r <= 2 * s, x0[..., None] - 1,
                         x0[..., None] + (i_r - (2 * s + 1)))
        ys_r = jnp.where(i_r <= 2 * s,
                         y0[..., None] + 2 * s - 1 - i_r,
                         y0[..., None] - 1)
        av = cs["avail"] != 0
        d["noref"] = ~jnp.any(av, axis=-1)
        # Substitution fill: each sample takes the nearest available
        # sample at or before it in spec order (8.4.4.2.2).
        sub = jax.lax.cummax(jnp.where(av, i_r, -1), axis=2)
        first = jnp.argmax(av, axis=-1).astype(jnp.int32)
        sub = jnp.where(sub < 0, first[..., None], sub)
        sxs = jnp.take_along_axis(xs_r, sub, axis=-1)
        sys_ = jnp.take_along_axis(ys_r, sub, axis=-1)
        # Routing (see var_schedule make_class): top-arm samples live
        # on their owner's bottom row (hbuf); left-arm samples on its
        # right column (vbuf); the above-left corner routes by the
        # per-CU owner check (corner_h).
        lh_t = (plane_h // gran) * plane_w
        lv_t = (plane_w // gran) * plane_h
        on_h = (sys_ == y0[..., None] - 1) \
            & ((sxs >= x0[..., None]) | cs["corner_h"][..., None])
        d["idx_h"] = jnp.where(on_h & valid[..., None],
                               (sys_ // gran) * plane_w + sxs, 0)
        d["idx_v"] = jnp.where(on_h | ~valid[..., None], lv_t,
                               (sxs // gran) * plane_h + sys_)
        d["sel_h"] = on_h | ~valid[..., None]
        yy, xx = np.meshgrid(np.arange(s), np.arange(s), indexing="ij")
        off = jnp.asarray((yy * plane_w + xx).ravel().astype(np.int32))
        trash = plane_w * plane_h
        d["pix"] = jnp.where(valid[..., None],
                             (y0 * plane_w + x0)[..., None] + off,
                             trash)
        ar = jnp.arange(s, dtype=jnp.int32)
        lh = (plane_h // gran) * plane_w
        lv_ = (plane_w // gran) * plane_h
        d["wr_h"] = jnp.where(
            valid[..., None],
            (((y0 + s - 1) // gran) * plane_w + x0)[..., None] + ar, lh)
        d["wr_v"] = jnp.where(
            valid[..., None],
            (((x0 + s - 1) // gran) * plane_h + y0)[..., None] + ar,
            lv_)
        st, k = x0.shape
        if plane is not None:
            d["origs"] = _flat_ext(plane)[d["pix"]].reshape(st, k, s,
                                                            s)
        for name, pl in extra:
            d[name] = _flat_ext(pl)[d["pix"]].reshape(st, k, s, s)
        if "inter" in cs and plane_w == width:
            c8 = s // 8
            w8, h8 = width // 8, height // 8
            cyy, cxx = np.meshgrid(np.arange(c8), np.arange(c8),
                                   indexing="ij")
            coff = jnp.asarray((cyy * w8 + cxx).ravel()
                               .astype(np.int32))
            cb8 = (y0 // 8) * w8 + x0 // 8
            d["cell8"] = jnp.where(valid[..., None],
                                   cb8[..., None] + coff, w8 * h8)
        return d

    sched = dict(sched)
    sched["luma"] = {
        s: derive(sched["luma"][s], s, width, height, 8,
                  sched["plane_y"]) for s in lsizes}
    if chroma:
        sched["chroma"] = {
            s: derive(sched["chroma"][s], s, width // 2, height // 2,
                      4, None,
                      extra=[("origs_cb", sched["plane_cb"]),
                             ("origs_cr", sched["plane_cr"])])
            for s in csizes}

    def mc_gather(cs, plane):
        """(steps, K, S, S) MC prediction via the class pixel map (pad
        slots read the trailing trash element)."""
        st, k = cs["modes"].shape
        ssz = int(np.sqrt(cs["pix"].shape[-1]))
        return _flat_ext(plane)[cs["pix"]].reshape(st, k, ssz, ssz)

    def xs_of(cs, okey, mc_plane=None):
        base = (cs[okey], cs["modes"], cs["noref"], cs["idx_h"],
                cs["idx_v"], cs["sel_h"], cs["wr_h"], cs["wr_v"])
        if inter:
            base += (cs["inter"], mc_gather(cs, mc_plane))
        return base

    def xs_of_c2(cs):
        """Merged cb+cr slots (K -> 2K) with cr indices offset into
        the second half of the shared edge buffers."""
        dup = lambda a: jnp.concatenate([a, a], axis=1)
        o2 = jnp.concatenate([cs["origs_cb"], cs["origs_cr"]], axis=1)
        idx_h2 = jnp.concatenate(
            [cs["idx_h"], cs["idx_h"] + (lh_c + 1)], axis=1)
        idx_v2 = jnp.concatenate(
            [cs["idx_v"], cs["idx_v"] + (lv_c + 1)], axis=1)
        wr_h2 = jnp.concatenate(
            [cs["wr_h"], cs["wr_h"] + (lh_c + 1)], axis=1)
        wr_v2 = jnp.concatenate(
            [cs["wr_v"], cs["wr_v"] + (lv_c + 1)], axis=1)
        base = (o2, dup(cs["modes"]), dup(cs["noref"]), idx_h2,
                idx_v2, dup(cs["sel_h"]), wr_h2, wr_v2)
        if inter:
            base += (dup(cs["inter"]),
                     jnp.concatenate([mc_gather(cs, mc_planes[1]),
                                      mc_gather(cs, mc_planes[2])],
                                     axis=1))
        return base

    xs = tuple(xs_of(sched["luma"][s], "origs",
                     mc_planes[0] if inter else None) for s in lsizes)
    if merge_c:
        xs += tuple(xs_of_c2(sched["chroma"][s]) for s in csizes)
    elif chroma:
        xs += tuple(xs_of(sched["chroma"][s], "origs_cb",
                          mc_planes[1] if inter else None)
                    for s in csizes)
        xs += tuple(xs_of(sched["chroma"][s], "origs_cr",
                          mc_planes[2] if inter else None)
                    for s in csizes)

    def tab(size, comp, qq):
        if scaling is None:
            return None
        return (scaling.qc(size, True, comp)[qq % 6],
                scaling.qc(size, False, comp)[qq % 6],
                scaling.dqc(size, True, comp)[qq % 6],
                scaling.dqc(size, False, comp)[qq % 6])

    # ---- Direct (scan-free) inter reconstruction.  Inter CUs carry
    # no wavefront dependency: they roundtrip in compact per-size
    # batches (work proportional to real CU count — padded full grids
    # would run RDOQ over 3x the plane per size), their recon
    # pre-fills the edge buffers, and the scan covers only the intra
    # islands (the planner excluded inter CUs from the classes). ----
    direct = inter and "iluma" in sched
    cbf8_direct = None
    rec_i_y = lv_i_y = rec_i_cb = lv_i_cb = rec_i_cr = lv_i_cr = None
    if direct:
        from kvazaar_jax.encoder.intra_recon import (_scan_sel,
                                                     _tu_roundtrip)

        def direct_pass(cls_key, plane, mcp, qpv, luma_flag,
                        comp, scale):
            """Batched inter-CU reconstruction, one fori row at a
            time: row shapes are STATIC per resolution (worst-case
            padding) while the TRACED per-size row count bounds the
            executed work — content variation cannot recompile this
            program (each variant is a separate compile)."""
            pw, ph = plane.shape[1], plane.shape[0]
            flat = jnp.zeros(ph * pw + 1, jnp.int32)
            lflat = jnp.zeros(ph * pw + 1, jnp.int32)
            h8w8_ = (height // 8) * (width // 8)
            cbf_flat = (jnp.zeros(h8w8_ + 1, jnp.int32)
                        if luma_flag else None)
            pl_ext = _flat_ext(plane)
            mc_ext = _flat_ext(mcp)
            for s_l in (8, 16, 32):
                s = s_l // scale
                cs = sched[cls_key][s]
                kcap = cs["valid"].shape[1]
                yy, xx = np.meshgrid(np.arange(s), np.arange(s),
                                     indexing="ij")
                off = jnp.asarray((yy * pw + xx).ravel()
                                  .astype(np.int32))
                trash = pw * ph
                coff = None
                if luma_flag:
                    c8 = s_l // 8
                    w8c, h8c = width // 8, height // 8
                    cyy, cxx = np.meshgrid(np.arange(c8),
                                           np.arange(c8),
                                           indexing="ij")
                    coff = jnp.asarray((cyy * w8c + cxx).ravel()
                                       .astype(np.int32))

                def row_body(t, carry, _s=s, _kcap=kcap, _off=off,
                             _trash=trash, _cs=cs,
                             _luma=luma_flag,
                             _coff=coff if luma_flag else None,
                             _c8=(s_l // 8) if luma_flag else 0):
                    if _luma:
                        fl, lf, cbf = carry
                    else:
                        fl, lf = carry
                    ix = jax.lax.dynamic_index_in_dim
                    x0 = ix(_cs["x0"], t, 0, keepdims=False) \
                        .astype(jnp.int32)
                    y0 = ix(_cs["y0"], t, 0, keepdims=False) \
                        .astype(jnp.int32)
                    valid = ix(_cs["valid"], t, 0, keepdims=False)
                    pix = jnp.where(valid[:, None],
                                    (y0 * pw + x0)[:, None] + _off,
                                    _trash)
                    origs = pl_ext[pix].reshape(_kcap, _s, _s)
                    mcb = mc_ext[pix].reshape(_kcap, _s, _s)
                    scan_sel = None
                    if signhide:
                        scan_sel = _scan_sel(
                            jnp.zeros(_kcap, jnp.int32), _s, _luma,
                            jnp.ones(_kcap, bool))
                    lv, rec, _ = _tu_roundtrip(
                        origs, mcb, _s, qpv, bitdepth, False,
                        lossless, scan_sel, rdoq, lam,
                        tab(_s, comp, qpv))
                    lv = jnp.where(valid[:, None, None], lv, 0)
                    fl = fl.at[pix.reshape(-1)].set(
                        rec.reshape(-1).astype(jnp.int32))
                    lf = lf.at[pix.reshape(-1)].set(
                        lv.reshape(-1).astype(jnp.int32))
                    if not _luma:
                        return (fl, lf)
                    w8c, h8c = width // 8, height // 8
                    cell8 = jnp.where(
                        valid[:, None],
                        ((y0 // 8) * w8c + x0 // 8)[:, None] + _coff,
                        w8c * h8c)
                    cb = jnp.any(lv != 0, axis=(-1, -2)) \
                        .astype(jnp.int32)
                    up = jnp.broadcast_to(
                        cb[:, None], (cb.shape[0], _c8 * _c8))
                    cbf = cbf.at[cell8.reshape(-1)].max(
                        up.reshape(-1))
                    return (fl, lf, cbf)

                rows = jnp.minimum(cs["rows"].reshape(()),
                                   cs["valid"].shape[0])
                if luma_flag:
                    flat, lflat, cbf_flat = jax.lax.fori_loop(
                        0, rows, row_body, (flat, lflat, cbf_flat))
                else:
                    flat, lflat = jax.lax.fori_loop(
                        0, rows, row_body, (flat, lflat))
            recp = flat[:pw * ph].reshape(ph, pw)
            lvp = lflat[:pw * ph].reshape(ph, pw)
            cbf = (cbf_flat[:(height // 8) * (width // 8)]
                   .reshape(height // 8, width // 8) != 0
                   if luma_flag else None)
            return recp, lvp, cbf

        rec_i_y, lv_i_y, cbf8_direct = direct_pass(
            "iluma", sched["plane_y"].astype(jnp.int32),
            mc_planes[0], qp, True, 0, 1)
        carry0[0] = jnp.concatenate(
            [rec_i_y[7::8, :].reshape(-1), jnp.zeros(1, jnp.int32)])
        carry0[1] = jnp.concatenate(
            [rec_i_y[:, 7::8].T.reshape(-1), jnp.zeros(1, jnp.int32)])
        if chroma:
            rec_i_cb, lv_i_cb, _ = direct_pass(
                "ichroma", sched["plane_cb"].astype(jnp.int32),
                mc_planes[1], qp_c, False, 1, 2)
            rec_i_cr, lv_i_cr, _ = direct_pass(
                "ichroma", sched["plane_cr"].astype(jnp.int32),
                mc_planes[2], qp_c, False, 2, 2)
            hb_cb = rec_i_cb[3::4, :].reshape(-1)
            hb_cr = rec_i_cr[3::4, :].reshape(-1)
            vb_cb = rec_i_cb[:, 3::4].T.reshape(-1)
            vb_cr = rec_i_cr[:, 3::4].T.reshape(-1)
            z1 = jnp.zeros(1, jnp.int32)
            if merge_c:
                carry0[2] = jnp.concatenate([hb_cb, z1, hb_cr, z1])
                carry0[3] = jnp.concatenate([vb_cb, z1, vb_cr, z1])
            else:
                carry0[2] = jnp.concatenate([hb_cb, z1])
                carry0[3] = jnp.concatenate([vb_cb, z1])
                carry0[4] = jnp.concatenate([hb_cr, z1])
                carry0[5] = jnp.concatenate([vb_cr, z1])

    # ---- Flat output carries: recon, level planes and per-cell cbf
    # are scattered INSIDE the loop through the class pixel maps, so
    # the wavefront runs a TRACED number of steps (n_real) with
    # in-place while-carries.  (Stacked per-step outputs forced XLA to
    # copy the whole output buffers every iteration; padded bucket
    # steps each paid a dispatch floor.)
    n_edge = len(carry0)
    h8w8 = (height // 8) * (width // 8)
    z1 = jnp.zeros(1, jnp.int32)

    def flat0(base, n):
        if base is None:
            return jnp.zeros(n + 1, jnp.int32)
        return jnp.concatenate([base.reshape(-1).astype(jnp.int32),
                                z1])

    planes0 = [flat0(rec_i_y if direct else None, width * height),
               flat0(lv_i_y if direct else None, width * height)]
    if chroma:
        planes0 += [
            flat0(rec_i_cb if direct else None, wc * hc),
            flat0(lv_i_cb if direct else None, wc * hc),
            flat0(rec_i_cr if direct else None, wc * hc),
            flat0(lv_i_cr if direct else None, wc * hc)]
    cbf_idx = None
    if inter:
        planes0.append(flat0(
            cbf8_direct.astype(jnp.int32) if cbf8_direct is not None
            else None, h8w8))
        cbf_idx = len(planes0) - 1

    def loop_body(t, carry):
        edge = list(carry[:n_edge])
        planes_c = list(carry[n_edge:])

        def at_t(a):
            return jax.lax.dynamic_index_in_dim(a, t, 0,
                                                keepdims=False)

        def scat(pi, pix, arr):
            planes_c[pi] = planes_c[pi].at[pix.reshape(-1)].set(
                arr.reshape(-1).astype(jnp.int32))

        hy, vy = edge[0], edge[1]
        for i, s in enumerate(lsizes):
            xs_t = tuple(at_t(a) for a in xs[i])
            hy, vy, lv, rec = _class_pass(
                hy, vy, xs_t, s, qp, bitdepth, True, lossless,
                signhide, rdoq, lam, tab(s, 0, qp))
            pix = at_t(sched["luma"][s]["pix"])
            scat(0, pix, rec)
            scat(1, pix, lv)
            if inter:
                cell8 = at_t(sched["luma"][s]["cell8"])
                cbf = jnp.any(lv != 0, axis=(-1, -2)).astype(jnp.int32)
                up = jnp.broadcast_to(cbf[:, None],
                                      cbf.shape + (cell8.shape[-1],))
                planes_c[cbf_idx] = planes_c[cbf_idx].at[
                    cell8.reshape(-1)].max(up.reshape(-1))
        new_edge = [hy, vy]
        if merge_c:
            hc2, vc2 = edge[2], edge[3]
            for j, s in enumerate(csizes):
                xs_t = tuple(at_t(a) for a in xs[len(lsizes) + j])
                hc2, vc2, lv, rec = _class_pass(
                    hc2, vc2, xs_t, s, qp_c, bitdepth, False,
                    lossless, signhide, rdoq, lam, None)
                pix = at_t(sched["chroma"][s]["pix"])
                k = pix.shape[0]
                scat(2, pix, rec[:k])
                scat(3, pix, lv[:k])
                scat(4, pix, rec[k:])
                scat(5, pix, lv[k:])
            new_edge += [hc2, vc2]
        elif chroma:
            bufs = list(edge[2:6])
            for p in range(2):              # cb then cr
                hb, vb = bufs[2 * p], bufs[2 * p + 1]
                for j, s in enumerate(csizes):
                    xs_t = tuple(
                        at_t(a) for a in
                        xs[len(lsizes) + p * len(csizes) + j])
                    hb, vb, lv, rec = _class_pass(
                        hb, vb, xs_t, s, qp_c, bitdepth, False,
                        lossless, signhide, rdoq, lam,
                        tab(s, 1 + p, qp_c))
                    pix = at_t(sched["chroma"][s]["pix"])
                    scat(2 + 2 * p, pix, rec)
                    scat(3 + 2 * p, pix, lv)
                bufs[2 * p], bufs[2 * p + 1] = hb, vb
            new_edge += bufs
        return tuple(new_edge + planes_c)

    n_real = sched.get("n_real")
    t_bucket = (sched["luma"][lsizes[0]]["pix"].shape[0] if lsizes
                else 1)
    trip = (jnp.minimum(n_real.reshape(()), t_bucket)
            if n_real is not None else t_bucket)
    final = jax.lax.fori_loop(0, trip, loop_body,
                              tuple(list(carry0) + planes0))
    planes_f = final[n_edge:]
    rec_y = planes_f[0][:width * height].reshape(height, width)
    lv_y = planes_f[1][:width * height].reshape(height, width)
    rec_cb = rec_cr = lv_cb = lv_cr = None
    if chroma:
        rec_cb = planes_f[2][:wc * hc].reshape(hc, wc)
        lv_cb = planes_f[3][:wc * hc].reshape(hc, wc)
        rec_cr = planes_f[4][:wc * hc].reshape(hc, wc)
        lv_cr = planes_f[5][:wc * hc].reshape(hc, wc)
    levels = (lv_y, lv_cb, lv_cr)
    if not inter:
        return rec_y, rec_cb, rec_cr, levels
    cbf8 = planes_f[cbf_idx][:h8w8].reshape(height // 8,
                                            width // 8) != 0
    return rec_y, rec_cb, rec_cr, levels, cbf8
