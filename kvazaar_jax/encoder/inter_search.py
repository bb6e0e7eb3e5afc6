"""Batched inter search: exhaustive integer ME + subpel SATD refinement.

Reference behavior: search_pu_inter_ref (src/search_inter.c:1134) with
hexbs/tz integer search and search_frac (:965) subpel.  Device design:
every block's full +-R SAD surface is computed densely (ops/inter.py),
the integer winner minimizes SAD + lambda*mvbits against a median
predictor from the pass-1 MV field (two-pass, no sequential deps), and
half- then quarter-pel refinement evaluates 8 MC+SATD candidates per
stage for all blocks at once.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from kvazaar_jax.encoder.geometry import IntraFramePlan
from kvazaar_jax.encoder.intra_search import satd8_batch
from kvazaar_jax.ops.inter import mc_luma, sad_full_search


def _mv_bits_est(dv):
    """Approximate signalling bits of one mvd component (EG1-shaped):
    1 bin for zero, else ~2*log2(|v|)+3."""
    a = jnp.abs(dv)
    nbits = 32 - jax.lax.clz(jnp.maximum(a, 1).astype(jnp.int32))
    return jnp.where(a == 0, 1, 2 * nbits + 1).astype(jnp.float32)


def _median3(a, b, c):
    return a + b + c - jnp.maximum(a, jnp.maximum(b, c)) \
        - jnp.minimum(a, jnp.minimum(b, c))


def _mv_pred_grid(mv_grid):
    """Median MV predictor from left/top/top-right pass-1 decisions
    (classic median predictor; only used for rate estimation)."""
    by, bx, _ = mv_grid.shape
    zero = jnp.zeros_like(mv_grid[:, :1])
    left = jnp.concatenate([zero[:, :1], mv_grid[:, :-1]], axis=1)
    top = jnp.concatenate([jnp.zeros_like(mv_grid[:1]), mv_grid[:-1]],
                          axis=0)
    topright = jnp.concatenate(
        [top[:, 1:], jnp.zeros_like(mv_grid[:, :1])], axis=1)
    return _median3(left, top, topright)


def _int_refine_sads(cur_blocks, ref, x0s, y0s, centers_px, rng: int,
                     size: int, bitdepth: int = 8):
    """(N, (2rng+1)^2) integer-pel SADs around per-block centers:
    one (S+2rng)^2 window gather, then static shifted slices (row-major
    dy, dx offsets -rng..rng)."""
    from kvazaar_jax.ops.inter import gather_windows
    ox = x0s + centers_px[:, 0] - rng
    oy = y0s + centers_px[:, 1] - rng
    win = gather_windows(ref, ox, oy, size + 2 * rng,
                         val_bound=1 << bitdepth)
    outs = []
    for dy in range(2 * rng + 1):
        for dx in range(2 * rng + 1):
            d = win[:, dy:dy + size, dx:dx + size] - cur_blocks
            outs.append(jnp.abs(d).sum(axis=(-2, -1)))
    return jnp.stack(outs, axis=1)


def _refine_offsets(rng: int):
    return np.array([(dx, dy) for dy in range(-rng, rng + 1)
                     for dx in range(-rng, rng + 1)], np.int32)


def search_inter_frame(cur, ref, plan: IntraFramePlan, lambda_satd: float,
                       me_range: int, bitdepth: int = 8,
                       subpel: bool = True, sads=None, mv_hint=None):
    """cur/ref: (H, W) int32 (ref is the deblocked prior recon).

    Returns (mv (By, Bx, 2) int32 qpel, cost (By, Bx) f32 —
    SATD + lambda*mvbits of the winner).

    Device shape: whole-plane shifted-diff SAD surfaces reduced with
    banded matmuls (ops/inter.py sad_surfaces), then a DENSE 7x7
    quarter-pel SATD grid from one window gather per block
    (refine_qpel_dense) — a superset of the reference's
    hexbs + half/quarter refinement candidates evaluated in two fused
    device passes instead of per-candidate gathers."""
    from kvazaar_jax.ops.inter import (QPEL_OFFSETS, refine_qpel_dense,
                                       sad_surfaces)
    s = plan.cu_size
    by, bx = plan.blocks_y, plan.blocks_x
    n = by * bx
    r = me_range
    ys, xs = np.mgrid[0:by, 0:bx]
    x0s = jnp.asarray((xs * s).reshape(-1))
    y0s = jnp.asarray((ys * s).reshape(-1))
    cur_blocks = cur.reshape(by, s, bx, s).transpose(0, 2, 1, 3)
    cur_blocks = cur_blocks.reshape(n, s, s).astype(jnp.int32)
    # Materialize the blocked layout ONCE: without the barrier XLA
    # fuses this transpose into all 81 shifted-SAD consumers and the
    # re-blocked reads multiply the stage's runtime (measured on the
    # earlier hardware; not re-measured on the GPU).
    cur_blocks = jax.lax.optimization_barrier(cur_blocks)

    if mv_hint is not None:
        # Hierarchical stage 2: +-rng full-res SADs around the coarse
        # hint AND around zero (static background safety net), rate-
        # aware re-rank over the candidate set.
        rng = 4
        offs = jnp.asarray(_refine_offsets(rng))           # (K, 2)
        centers = mv_hint.reshape(n, 2) >> 2               # px
        zero = jnp.zeros_like(centers)
        s_h = _int_refine_sads(cur_blocks, ref, x0s, y0s, centers,
                               rng, s, bitdepth)
        s_z = _int_refine_sads(cur_blocks, ref, x0s, y0s, zero,
                               rng, s, bitdepth)
        cands = jnp.concatenate([centers[:, None] + offs[None],
                                 zero[:, None] + offs[None]], axis=1)
        sads_c = jnp.concatenate([s_h, s_z], axis=1)       # (N, 2K)
        i1 = jnp.argmin(sads_c, axis=1)
        mv1 = jnp.take_along_axis(
            cands, i1[:, None, None], axis=1)[:, 0] * 4
        pred = _mv_pred_grid(mv1.reshape(by, bx, 2)).reshape(n, 1, 2)
        q = cands * 4
        bits = (_mv_bits_est(q[..., 0] - pred[..., 0])
                + _mv_bits_est(q[..., 1] - pred[..., 1]))
        cost = sads_c.astype(jnp.float32) + lambda_satd * bits
        idx2 = jnp.argmin(cost, axis=1)
        mv_int = jnp.take_along_axis(
            q, idx2[:, None, None], axis=1)[:, 0].astype(jnp.int32)
        pred_n = pred.reshape(n, 2)
    else:
        if sads is None:
            sads = sad_surfaces(cur, ref, r, s, bitdepth)
        sads = sads.reshape(n, 2 * r + 1, 2 * r + 1)   # (N, Ddy, Ddx)

        # Pass 1: pure-SAD integer winner.
        flat = sads.reshape(n, -1)
        idx1 = jnp.argmin(flat, axis=-1)
        dy1 = idx1 // (2 * r + 1) - r
        dx1 = idx1 % (2 * r + 1) - r
        mv1 = jnp.stack([dx1, dy1], axis=-1).reshape(by, bx, 2) * 4

        # Pass 2: re-minimize with mv-rate vs the median predictor.
        pred = _mv_pred_grid(mv1).reshape(n, 1, 1, 2)
        dxs = (jnp.arange(-r, r + 1) * 4)[None, None, :]
        dys = (jnp.arange(-r, r + 1) * 4)[None, :, None]
        bits = _mv_bits_est(dxs - pred[..., 0]) + \
            _mv_bits_est(dys - pred[..., 1])
        cost = sads.astype(jnp.float32) + lambda_satd * bits
        idx2 = jnp.argmin(cost.reshape(n, -1), axis=-1)
        dy2 = idx2 // (2 * r + 1) - r
        dx2 = idx2 % (2 * r + 1) - r
        mv_int = jnp.stack([dx2, dy2], axis=-1).astype(jnp.int32) * 4
        pred_n = pred.reshape(n, 2)

    if not subpel:
        # Integer-pel only (--subme 0): cost = SATD at the int winner.
        preds = mc_luma(ref, x0s, y0s, mv_int, s, bitdepth)
        satd = satd8_batch(preds.reshape(n, s, s) - cur_blocks)
        rate = _mv_bits_est(mv_int[:, 0] - pred_n[:, 0]) + \
            _mv_bits_est(mv_int[:, 1] - pred_n[:, 1])
        cost_i = satd.astype(jnp.float32) + lambda_satd * rate
        return mv_int.reshape(by, bx, 2), cost_i.reshape(by, bx)

    satd49 = refine_qpel_dense(cur_blocks, ref, x0s, y0s, mv_int, s,
                               bitdepth)             # (N, 49)
    cands = mv_int[:, None, :] + jnp.asarray(QPEL_OFFSETS)[None]
    rate = _mv_bits_est(cands[..., 0] - pred_n[:, None, 0]) + \
        _mv_bits_est(cands[..., 1] - pred_n[:, None, 1])
    c = satd49.astype(jnp.float32) + lambda_satd * rate
    k = jnp.argmin(c, axis=-1)
    mv_q = jnp.take_along_axis(cands, k[:, None, None], axis=1)[:, 0]
    cost_q = jnp.min(c, axis=-1)
    return mv_q.reshape(by, bx, 2), cost_q.reshape(by, bx)


_MC_EXTEND = 72            # covers MV overreach for me_range <= 64


def _luma_hp_blocks(ref_y, x0s, y0s, mvs, size: int, bitdepth: int = 8,
                    ridx=None):
    """14-bit luma MC via precomputed quarter-pel phase planes: 16
    whole-plane separable interpolations + ONE stacked gather — the
    fast path for full-frame MC (per-block tap contractions batch
    poorly).  Bit-exact vs mc_luma_hp while the MV overreach
    beyond the frame stays within _MC_EXTEND pixels (config.validate
    caps me_range at 64)."""
    from kvazaar_jax.ops.inter import (luma_phase_planes,
                                       mc_luma_phases_hp)
    e = _MC_EXTEND
    if ref_y.ndim == 3:
        # Static unroll over the (<=4) references: a vmap here would
        # batch the banded FIR matmuls, and batched bf16 dots are
        # unsupported on the CPU fallback backend.
        planes = jnp.stack([luma_phase_planes(ref_y[r], bitdepth, e)
                            for r in range(ref_y.shape[0])])
    else:
        planes = luma_phase_planes(ref_y, bitdepth, e)
    return mc_luma_phases_hp(planes, x0s, y0s, mvs, size, e, ridx)


def mc_planes_hp(ref_y, ref_cb, ref_cr, mv, plan: IntraFramePlan,
                 bitdepth: int = 8):
    """Full-frame MC at the 14-bit intermediate precision (bipred
    averaging inputs, 8.5.4.2.3.2).  Returns (hp_y (H, W), hp_cb,
    hp_cr) int32 planes."""
    from kvazaar_jax.ops.inter import mc_chroma_hp, mc_luma_hp
    s = plan.cu_size
    by, bx = plan.blocks_y, plan.blocks_x
    n = by * bx
    ys, xs = np.mgrid[0:by, 0:bx]
    x0s = jnp.asarray((xs * s).reshape(-1))
    y0s = jnp.asarray((ys * s).reshape(-1))
    mvs = mv.reshape(n, 2)

    def to_plane(blocks, size, h, w):
        g = blocks.reshape(by, bx, size, size).transpose(0, 2, 1, 3)
        return g.reshape(h, w)

    py = to_plane(_luma_hp_blocks(ref_y, x0s, y0s, mvs, s, bitdepth),
                  s, plan.height, plan.width)
    if ref_cb is None:
        return py, None, None
    s2 = s // 2
    pcb = to_plane(mc_chroma_hp(ref_cb, x0s // 2, y0s // 2, mvs, s2,
                                bitdepth), s2, plan.height // 2,
                   plan.width // 2)
    pcr = to_plane(mc_chroma_hp(ref_cr, x0s // 2, y0s // 2, mvs, s2,
                                bitdepth), s2, plan.height // 2,
                   plan.width // 2)
    return py, pcb, pcr


def bi_mc_planes(ref0, ref1, mv0, mv1, dirs, plan: IntraFramePlan,
                 bitdepth: int = 8):
    """Final prediction planes for a B frame: per-CU L0 / L1 / BI
    select with the spec's rounding (uni: 8.5.4.2.3.1, bi: .2).

    ref0/ref1: (y, cb, cr) int32 planes; mv0/mv1: (By, Bx, 2);
    dirs: (By, Bx) 0/1/2."""
    from kvazaar_jax.ops.inter import bi_average, uni_round
    s = plan.cu_size
    hp0 = mc_planes_hp(*ref0, mv0, plan, bitdepth)
    hp1 = mc_planes_hp(*ref1, mv1, plan, bitdepth)

    def sel(h0, h1, size):
        if h0 is None:
            return None
        d = jnp.kron(dirs, jnp.ones((size, size), dirs.dtype))
        return jnp.where(d == 0, uni_round(h0, bitdepth),
                         jnp.where(d == 1, uni_round(h1, bitdepth),
                                   bi_average(h0, h1, bitdepth)))

    return (sel(hp0[0], hp1[0], s), sel(hp0[1], hp1[1], s // 2),
            sel(hp0[2], hp1[2], s // 2))


def mc_planes(ref_y, ref_cb, ref_cr, mv, plan: IntraFramePlan,
              bitdepth: int = 8, ref_grid=None):
    """Full-frame MC prediction planes for final MVs.

    mv: (By, Bx, 2) qpel.  With stacked references ((R, H, W) planes)
    pass ref_grid (By, Bx) int32 L0 ref indices — each block gathers
    from its selected reference.  Returns (pred_y (H, W), pred_cb,
    pred_cr)."""
    s = plan.cu_size
    by, bx = plan.blocks_y, plan.blocks_x
    n = by * bx
    ys, xs = np.mgrid[0:by, 0:bx]
    x0s = jnp.asarray((xs * s).reshape(-1))
    y0s = jnp.asarray((ys * s).reshape(-1))
    mvs = mv.reshape(n, 2)
    ridx = None if ref_grid is None else ref_grid.reshape(n)
    from kvazaar_jax.ops.inter import uni_round
    py = uni_round(_luma_hp_blocks(ref_y, x0s, y0s, mvs, s, bitdepth,
                                   ridx), bitdepth)

    def blocks_to_plane_j(blocks, size, h, w):
        g = blocks.reshape(by, bx, size, size).transpose(0, 2, 1, 3)
        return g.reshape(h, w)

    out_y = blocks_to_plane_j(py, s, plan.height, plan.width)
    if ref_cb is None:
        return out_y, None, None
    from kvazaar_jax.ops.inter import mc_chroma
    s2 = s // 2
    pcb = mc_chroma(ref_cb, x0s // 2, y0s // 2, mvs, s2, bitdepth, ridx)
    pcr = mc_chroma(ref_cr, x0s // 2, y0s // 2, mvs, s2, bitdepth, ridx)
    out_cb = blocks_to_plane_j(pcb, s2, plan.height // 2, plan.width // 2)
    out_cr = blocks_to_plane_j(pcr, s2, plan.height // 2, plan.width // 2)
    return out_y, out_cb, out_cr


def mc_planes_cells(ref_y, ref_cb, ref_cr, mv_cells, bitdepth: int = 8):
    """Full-frame MC driven by an 8x8-cell motion field (h8, w8, 2) —
    serves every PU shape uniformly (interpolation is position-
    independent, so per-cell MC is bit-identical to per-PU MC).
    Returns (pred_y (H, W), pred_cb, pred_cr)."""
    from kvazaar_jax.ops.inter import mc_chroma, uni_round
    h8, w8 = mv_cells.shape[:2]
    n = h8 * w8
    ys, xs = np.mgrid[0:h8, 0:w8]
    x0s = jnp.asarray((xs * 8).reshape(-1))
    y0s = jnp.asarray((ys * 8).reshape(-1))
    mvs = mv_cells.reshape(n, 2)
    py = uni_round(_luma_hp_blocks(ref_y, x0s, y0s, mvs, 8, bitdepth),
                   bitdepth)

    def to_plane(blocks, size, h, w):
        g = blocks.reshape(h8, w8, size, size).transpose(0, 2, 1, 3)
        return g.reshape(h, w)

    out_y = to_plane(py, 8, h8 * 8, w8 * 8)
    if ref_cb is None:
        return out_y, None, None
    pcb = mc_chroma(ref_cb, x0s // 2, y0s // 2, mvs, 4, bitdepth)
    pcr = mc_chroma(ref_cr, x0s // 2, y0s // 2, mvs, 4, bitdepth)
    return (out_y, to_plane(pcb, 4, h8 * 4, w8 * 4),
            to_plane(pcr, 4, h8 * 4, w8 * 4))



def bi_mc_planes_cells(ref0, ref1, mv0_cells, mv1_cells, dirs8,
                       bitdepth: int = 8):
    """B-frame prediction planes driven by 8x8-cell motion fields —
    the cell form of bi_mc_planes for variable trees.  ref0/ref1:
    (y, cb, cr) planes; mv0/mv1_cells: (h8, w8, 2) qpel; dirs8:
    (h8, w8) 0=L0/1=L1/2=BI."""
    from kvazaar_jax.ops.inter import (bi_average, mc_chroma_hp,
                                       uni_round)
    h8, w8 = dirs8.shape
    n = h8 * w8
    ys, xs = np.mgrid[0:h8, 0:w8]
    x0s = jnp.asarray((xs * 8).reshape(-1))
    y0s = jnp.asarray((ys * 8).reshape(-1))
    mv0 = mv0_cells.reshape(n, 2)
    mv1 = mv1_cells.reshape(n, 2)

    def to_plane(blocks, size, h, w):
        g = blocks.reshape(h8, w8, size, size).transpose(0, 2, 1, 3)
        return g.reshape(h, w)

    def sel(h0, h1, size):
        d = jnp.kron(dirs8, jnp.ones((size, size), dirs8.dtype))
        return jnp.where(d == 0, uni_round(h0, bitdepth),
                         jnp.where(d == 1, uni_round(h1, bitdepth),
                                   bi_average(h0, h1, bitdepth)))

    hp0_y = to_plane(_luma_hp_blocks(ref0[0], x0s, y0s, mv0, 8,
                                     bitdepth), 8, h8 * 8, w8 * 8)
    hp1_y = to_plane(_luma_hp_blocks(ref1[0], x0s, y0s, mv1, 8,
                                     bitdepth), 8, h8 * 8, w8 * 8)
    out_y = sel(hp0_y, hp1_y, 8)
    if ref0[1] is None:
        return out_y, None, None
    hp0_cb = to_plane(mc_chroma_hp(ref0[1], x0s // 2, y0s // 2, mv0,
                                   4, bitdepth), 4, h8 * 4, w8 * 4)
    hp1_cb = to_plane(mc_chroma_hp(ref1[1], x0s // 2, y0s // 2, mv1,
                                   4, bitdepth), 4, h8 * 4, w8 * 4)
    hp0_cr = to_plane(mc_chroma_hp(ref0[2], x0s // 2, y0s // 2, mv0,
                                   4, bitdepth), 4, h8 * 4, w8 * 4)
    hp1_cr = to_plane(mc_chroma_hp(ref1[2], x0s // 2, y0s // 2, mv1,
                                   4, bitdepth), 4, h8 * 4, w8 * 4)
    return out_y, sel(hp0_cb, hp1_cb, 4), sel(hp0_cr, hp1_cr, 4)


def search_inter_frame_smp(cur, ref, plan: IntraFramePlan,
                           lambda_satd: float, me_range: int,
                           bitdepth: int = 8, subpel: bool = True,
                           amp: bool = False):
    """ME + partition decision over {2Nx2N, 2NxN, Nx2N} and, with
    `amp`, the four asymmetric quarter splits — the reference's SMP/AMP
    search (kvz_search_cu_smp, src/search_inter.c:1627) recast as
    sub-block aggregation of ONE dense SAD surface tensor:
    SAD(shape) = sum of its sub-blocks' surfaces, so every partition
    shares the integer search compute.  Sub-block granularity is s/2
    for SMP, 8 for AMP (quarter splits need s/4 rows/cols).

    Returns (part (By, Bx) int32 HEVC PartMode,
             mv_pu (By, Bx, 2, 2) int32 qpel [PU0, PU1],
             cost (By, Bx) f32)."""
    from kvazaar_jax.ops.inter import (QPEL_OFFSETS, refine_qpel_dense,
                                       sad_surfaces)
    s = plan.cu_size
    sub = 8 if amp else s // 2
    g = s // sub
    by, bx = plan.blocks_y, plan.blocks_x
    n = by * bx
    r = me_range
    d = 2 * r + 1
    q = sad_surfaces(cur, ref, r, sub, bitdepth)
    q = q.reshape(by, g, bx, g, d, d)

    def agg(axis, lo, hi):
        if axis == "r":
            return q[:, lo:hi].sum(axis=(1, 3))
        return q[:, :, :, lo:hi].sum(axis=(1, 3))

    h = g // 2
    qt = max(g // 4, 1)
    surf = {"full": q.sum(axis=(1, 3)),
            "top": agg("r", 0, h), "bottom": agg("r", h, g),
            "left": agg("c", 0, h), "right": agg("c", h, g)}
    spans = {"full": ("r", 0, g), "top": ("r", 0, h),
             "bottom": ("r", h, g), "left": ("c", 0, h),
             "right": ("c", h, g)}
    pu_of_part = {1: ("top", "bottom"), 2: ("left", "right")}
    if amp and g >= 4:
        surf.update({
            "u0": agg("r", 0, qt), "u1": agg("r", qt, g),
            "d0": agg("r", 0, g - qt), "d1": agg("r", g - qt, g),
            "l0": agg("c", 0, qt), "l1": agg("c", qt, g),
            "r0": agg("c", 0, g - qt), "r1": agg("c", g - qt, g)})
        spans.update({
            "u0": ("r", 0, qt), "u1": ("r", qt, g),
            "d0": ("r", 0, g - qt), "d1": ("r", g - qt, g),
            "l0": ("c", 0, qt), "l1": ("c", qt, g),
            "r0": ("c", 0, g - qt), "r1": ("c", g - qt, g)})
        pu_of_part.update({4: ("u0", "u1"), 5: ("d0", "d1"),
                           6: ("l0", "l1"), 7: ("r0", "r1")})

    # Pass-1 predictor from the full-shape SAD argmin (rate reference).
    flat = surf["full"].reshape(n, -1)
    idx1 = jnp.argmin(flat, axis=-1)
    mv1 = jnp.stack([idx1 % d - r, idx1 // d - r],
                    axis=-1).reshape(by, bx, 2) * 4
    pred = _mv_pred_grid(mv1).reshape(n, 2)
    dxs = (jnp.arange(-r, r + 1) * 4)[None, None, :]
    dys = (jnp.arange(-r, r + 1) * 4)[None, :, None]
    bits_grid = (_mv_bits_est(dxs - pred[:, None, None, 0])
                 + _mv_bits_est(dys - pred[:, None, None, 1]))

    def int_winner(sads):
        cost = sads.reshape(n, d, d).astype(jnp.float32) \
            + lambda_satd * bits_grid
        i = jnp.argmin(cost.reshape(n, -1), axis=-1)
        return jnp.stack([i % d - r, i // d - r],
                         axis=-1).astype(jnp.int32) * 4

    mv_int = {k: int_winner(v) for k, v in surf.items()}

    # Sub-block geometry (raster over the sub grid).
    sby, sbx = by * g, bx * g
    qys, qxs = np.mgrid[0:sby, 0:sbx]
    qx0 = jnp.asarray((qxs * sub).reshape(-1))
    qy0 = jnp.asarray((qys * sub).reshape(-1))
    cq = cur.reshape(sby, sub, sbx, sub).transpose(0, 2, 1, 3)
    cq = cq.reshape(sby * sbx, sub, sub).astype(jnp.int32)
    qoff = jnp.asarray(QPEL_OFFSETS)

    byi, bxi = np.mgrid[0:by, 0:bx]

    def shape_sub_ids(name):
        axis, lo, hi = spans[name]
        rows = range(lo, hi) if axis == "r" else range(g)
        cols = range(g) if axis == "r" else range(lo, hi)
        ids = [((byi * g + rr) * sbx + bxi * g + cc)
               for rr in rows for cc in cols]
        return np.stack([a.reshape(-1) for a in ids], axis=-1)

    def refine_shape(name):
        mvc = mv_int[name]
        sub_ids = jnp.asarray(shape_sub_ids(name))
        k = sub_ids.shape[1]
        qi = sub_ids.reshape(-1)
        satd = refine_qpel_dense(cq[qi], ref, qx0[qi], qy0[qi],
                                 jnp.repeat(mvc, k, axis=0), sub,
                                 bitdepth)
        satd = satd.reshape(n, k, 49).sum(axis=1)
        cands = mvc[:, None, :] + qoff[None]
        rate = (_mv_bits_est(cands[..., 0] - pred[:, None, 0])
                + _mv_bits_est(cands[..., 1] - pred[:, None, 1]))
        c = satd.astype(jnp.float32) + lambda_satd * rate
        kk = jnp.argmin(c, axis=-1)
        mvq = jnp.take_along_axis(cands, kk[:, None, None],
                                  axis=1)[:, 0]
        return mvq, jnp.min(c, axis=-1)

    if subpel:
        res = {name: refine_shape(name) for name in surf}
    else:
        def int_cost(name):
            cost = surf[name].reshape(n, -1).astype(jnp.float32) \
                + lambda_satd * bits_grid.reshape(n, -1)
            return jnp.min(cost, axis=-1)
        res = {name: (mv_int[name], int_cost(name)) for name in surf}

    # Partition decision: non-2Nx2N pays extra part_mode bins, a second
    # merge flag, and its own mv rate (inside the PU costs).
    parts = [0, 1, 2] + ([4, 5, 6, 7] if (amp and g >= 4) else [])
    costs = [res["full"][1]]
    for p_ in parts[1:]:
        a, b = pu_of_part[p_]
        extra = lambda_satd * (3.0 if p_ in (1, 2) else 4.0)
        costs.append(res[a][1] + res[b][1] + extra)
    costs = jnp.stack(costs)                       # (P, N)
    sel = jnp.argmin(costs, axis=0)
    best = jnp.min(costs, axis=0)
    part = jnp.asarray(np.array(parts, np.int32))[sel]
    mv0 = res["full"][0]
    mv1_ = res["full"][0]
    for i, p_ in enumerate(parts[1:], start=1):
        a, b = pu_of_part[p_]
        m = (sel == i)[:, None]
        mv0 = jnp.where(m, res[a][0], mv0)
        mv1_ = jnp.where(m, res[b][0], mv1_)
    mv_pu = jnp.stack([mv0, mv1_], axis=1).reshape(by, bx, 2, 2)
    return part.reshape(by, bx), mv_pu, best.reshape(by, bx)


# ---------------------------------------------------------------------
# Merge-mode RD evaluation (reference: merge candidates tried as
# prediction hypotheses per PU with merge-skip early termination,
# src/search_inter.c:415-460,1451-1520).  Device recast: after the tree
# choice, ONE device pass MC-predicts every merge candidate hypothesis
# over the whole frame (cell-granularity fields serve every CU size)
# and returns per-cell 8x8 SATD maps; the host aggregates per CU with
# integral images and picks merge-vs-AMVP by SATD + lambda*bits.
# ---------------------------------------------------------------------

def merge_satd_maps_p(yp, ref_y, cand_cells, cur_cells,
                      bitdepth: int = 8):
    """Per-cell SATD of each P merge-candidate hypothesis + the
    searched MV field.  yp: (H, W) int32; cand_cells: (K, h8, w8, 2)
    qpel; cur_cells: (h8, w8, 2).  Returns (K+1, h8, w8) int32,
    last entry = current field."""
    from kvazaar_jax.encoder.intra_search import satd8_batch
    h8, w8 = cur_cells.shape[:2]
    k = cand_cells.shape[0]
    fields = [cand_cells[i] for i in range(k)] + [cur_cells]
    outs = []
    for mv in fields:
        py, _, _ = mc_planes_cells(ref_y, None, None, mv, bitdepth)
        d = (py - yp).reshape(h8, 8, w8, 8).transpose(0, 2, 1, 3)
        outs.append(satd8_batch(d))
    return jnp.stack(outs)


def merge_satd_maps_b(yp, ref0_y, ref1_y, cand_d, cand_m0, cand_m1,
                      cur_d, cur_m0, cur_m1, bitdepth: int = 8):
    """B variant: candidates carry full motion (dir, mv0, mv1).
    cand_d: (K, h8, w8); cand_m0/m1: (K, h8, w8, 2).  Returns
    (K+1, h8, w8) int32 per-cell SATD, last = current."""
    from kvazaar_jax.encoder.intra_search import satd8_batch
    h8, w8 = cur_d.shape[:2]
    k = cand_d.shape[0]
    triples = [(cand_d[i], cand_m0[i], cand_m1[i]) for i in range(k)]
    triples.append((cur_d, cur_m0, cur_m1))
    outs = []
    for dd, m0, m1 in triples:
        py, _, _ = bi_mc_planes_cells(
            (ref0_y, None, None), (ref1_y, None, None), m0, m1, dd,
            bitdepth)
        d = (py - yp).reshape(h8, 8, w8, 8).transpose(0, 2, 1, 3)
        outs.append(satd8_batch(d))
    return jnp.stack(outs)
