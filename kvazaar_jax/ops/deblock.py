"""HEVC deblocking filter (8.7.2) for the all-intra uniform-CU case.

Reference behavior: src/filter.c (kvz_filter_deblock_lcu and the
strong/weak luma + chroma filters at src/filter.c:83-188).  The reference
runs deblock per-LCU inside the job DAG with right/bottom-edge delays;
here the filter is a *frame-level post-pass*: intra prediction reads
unfiltered reconstruction (spec), so deblocking has no feedback into the
wavefront — every vertical edge filters in parallel, then every
horizontal edge on that output.  No scatters: edges live on a static
S-grid, so stripe extraction/insertion is static slicing.

All-intra specifics baked in: boundary strength is always 2 (both sides
intra, 8.7.2.4), every CU-grid line is a TU+PU boundary, uniform QP.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from kvazaar_jax.constants import CHROMA_QP_TAB as _CHROMA_QP_TAB

# Spec Table 8-12 constants.
TC_TABLE = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5,
    6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24], dtype=np.int32)
BETA_TABLE = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 6, 7, 8, 9,
    10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32,
    34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64],
    dtype=np.int32)


def luma_params(qp: int, beta_off2: int, tc_off2: int, bitdepth: int):
    """(beta, tc) for an intra edge (bs=2)."""
    scale = 1 << (bitdepth - 8)
    b_idx = min(max(qp + (beta_off2 << 1), 0), 51)
    t_idx = min(max(qp + 2 + (tc_off2 << 1), 0), 53)
    return int(BETA_TABLE[b_idx]) * scale, int(TC_TABLE[t_idx]) * scale


def _clip(v, lo, hi):
    return jnp.clip(v, lo, hi)


def _filter_luma_stripes(st, beta: int, tc_g, bitdepth: int):
    """Filter across an edge.  st: (..., E, 8, H) int32 — taps
    [p3 p2 p1 p0 q0 q1 q2 q3] on axis -2, edge LINES on the LAST axis
    (lane-rich layout: all the heavy arithmetic runs on (..., E, H)
    tensors; a taps-last layout wastes 94% of the VPU lanes).
    tc_g: (..., E, H//4) per-4-line-group tc.  Returns same shape."""
    p3, p2, p1, p0 = (st[..., 0, :], st[..., 1, :], st[..., 2, :],
                      st[..., 3, :])
    q0, q1, q2, q3 = (st[..., 4, :], st[..., 5, :], st[..., 6, :],
                      st[..., 7, :])
    maxv = (1 << bitdepth) - 1

    def rep(a):                       # group -> per-line broadcast
        return jnp.repeat(a, 4, axis=-1)

    tc_l = rep(tc_g)
    dp = jnp.abs(p2 - 2 * p1 + p0)         # (..., E, H)
    dq = jnp.abs(q2 - 2 * q1 + q0)
    dp03 = dp[..., 0::4] + dp[..., 3::4]   # (..., E, G)
    dq03 = dq[..., 0::4] + dq[..., 3::4]
    d = dp03 + dq03
    filter_on = d < beta

    ap = jnp.abs(p3 - p0) + jnp.abs(q0 - q3)
    apq = jnp.abs(p0 - q0)
    thr_tc = (5 * tc_g + 1) >> 1

    def strong_cond(i):
        return ((2 * (dp[..., i::4] + dq[..., i::4]) < (beta >> 2))
                & (ap[..., i::4] < (beta >> 3))
                & (apq[..., i::4] < thr_tc))

    strong = strong_cond(0) & strong_cond(3)     # (..., E, G)

    # Strong filter (clipped to +-2tc around the originals).
    def sclip(v, orig):
        return _clip(v, orig - 2 * tc_l, orig + 2 * tc_l)

    sp0 = sclip((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3, p0)
    sp1 = sclip((p2 + p1 + p0 + q0 + 2) >> 2, p1)
    sp2 = sclip((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    sq0 = sclip((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3, q0)
    sq1 = sclip((p0 + q0 + q1 + q2 + 2) >> 2, q1)
    sq2 = sclip((p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3, q2)

    # Weak filter.
    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    weak_on = jnp.abs(delta) < 10 * tc_l          # per line
    dlt = _clip(delta, -tc_l, tc_l)
    wp0 = _clip(p0 + dlt, 0, maxv)
    wq0 = _clip(q0 - dlt, 0, maxv)
    side_thr = (beta + (beta >> 1)) >> 3
    filt_p = rep(dp03 < side_thr)
    filt_q = rep(dq03 < side_thr)
    tc2 = tc_l >> 1
    dp1 = _clip((((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1, -tc2, tc2)
    dq1 = _clip((((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1, -tc2, tc2)
    wp1 = _clip(p1 + dp1, 0, maxv)
    wq1 = _clip(q1 + dq1, 0, maxv)

    on = rep(filter_on & (tc_g > 0))
    s_l = rep(strong) & on
    wk = ~rep(strong) & on & weak_on

    return jnp.stack(
        [p3,
         jnp.where(s_l, sp2, p2),
         jnp.where(s_l, sp1, jnp.where(wk & filt_p, wp1, p1)),
         jnp.where(s_l, sp0, jnp.where(wk, wp0, p0)),
         jnp.where(s_l, sq0, jnp.where(wk, wq0, q0)),
         jnp.where(s_l, sq1, jnp.where(wk & filt_q, wq1, q1)),
         jnp.where(s_l, sq2, q2),
         q3], axis=-2)


def _filter_chroma_stripes_tc(st, tc, bitdepth: int):
    """st: (..., E, 4, H) = taps [p1 p0 q0 q1] on axis -2, lines last;
    tc: (..., E, H) per line (tc 0 disables — the clip pins delta to
    0)."""
    p1, p0, q0, q1 = (st[..., 0, :], st[..., 1, :], st[..., 2, :],
                      st[..., 3, :])
    maxv = (1 << bitdepth) - 1
    delta = _clip((((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tc, tc)
    return jnp.stack(
        [p1, _clip(p0 + delta, 0, maxv), _clip(q0 - delta, 0, maxv),
         q1], axis=-2)


def _deblock_plane_vertical(plane, edge_step: int, filt_fn, taps: int,
                            bs_edges):
    """Filter all vertical edges at x = edge_step, 2*edge_step, ...
    plane: (..., H, W).  bs_edges: (E, By) int32 boundary strength per
    edge per block-row (or None for all-bs2 intra frames).

    Stripes never overlap (edge_step >= taps), so extraction and
    write-back are a fixed handful of reshapes/concats over a
    (..., H, W/step, step) block view — not per-edge slicing."""
    w = plane.shape[-1]
    n = w // edge_step
    if n < 2:
        return plane
    half = taps // 2
    blocks = plane.reshape(*plane.shape[:-1], n, edge_step)
    left = blocks[..., :-1, edge_step - half:]     # (..., H, E, half)
    right = blocks[..., 1:, :half]
    stripes = jnp.concatenate([left, right], axis=-1)
    # Lines-last layout for the filter math: (..., E, taps, H).
    st = jnp.moveaxis(stripes, -3, -1)
    filtered = jnp.moveaxis(filt_fn(st, bs_edges), -1, -3)
    first = jnp.concatenate([blocks[..., :1, :half],
                             filtered[..., half:]], axis=-2)
    last = jnp.concatenate([filtered[..., :half],
                            blocks[..., -1:, edge_step - half:]],
                           axis=-2)
    mid = blocks[..., :, half:edge_step - half]
    out = jnp.concatenate([first, mid, last], axis=-1)
    return out.reshape(plane.shape)


def _tc_lookup(qp_plus: int, bs, scale: int):
    """tc per entry from a bs array (0 → tc 0, disabling the filter;
    all clips become +-0 no-ops exactly as the spec skips bs=0)."""
    idx = jnp.clip(qp_plus + 2 * (bs - 1), 0, 53)
    tc = jnp.asarray(TC_TABLE)[idx] * scale
    return jnp.where(bs > 0, tc, 0)


def deblock_plane(plane, qp: int, edge_step: int, bitdepth: int = 8,
                  beta_off2: int = 0, tc_off2: int = 0,
                  chroma: bool = False, bs_v=None, bs_h=None,
                  blk: int = 0, qp_map=None):
    """Deblock one plane: vertical edges pass then horizontal pass.

    plane: (..., H, W) int32; edge_step: S for luma, S/2 for chroma
    (chroma only filters edges on its own 8-grid).  bs_v/bs_h:
    (By, Bx) int32 boundary strength of each block's left/top edge on
    the *block* grid of size `blk` (defaults: all 2 = all-intra).
    qp_map: (By, Bx) int32 LUMA QP per block on the same grid (LCU
    rate control); per-edge QP is the two-sided average of 8.7.2.5.3
    ((QpQ + QpP + 1) >> 1), chroma mapped through Table 8-10."""
    scale = 1 << (bitdepth - 8)
    per_qp = qp_map is not None
    if chroma:
        from kvazaar_jax.encoder.frame_encoder import chroma_qp
        if not per_qp:
            cqp = chroma_qp(qp)
            qp_plus = cqp + (tc_off2 << 1)
        step = max(edge_step, 8)   # chroma filters only its 8-grid
        taps = 4
    else:
        if not per_qp:
            beta, _ = luma_params(qp, beta_off2, tc_off2, bitdepth)
            if beta == 0:
                return plane
            qp_plus = qp + (tc_off2 << 1)
        step = edge_step
        taps = 8
    if blk == 0:
        blk = step

    def edge_of(m, n_edges, transposed, avg):
        # (E, Brows): per-edge value for each block row along edge e
        # (edge coordinate (e+1)*step).  avg: two-sided QP average.
        mm = jnp.swapaxes(m, 0, 1) if transposed else m
        cols = (np.arange(n_edges) + 1) * step // blk
        if avg:
            v = (mm[:, cols - 1] + mm[:, cols] + 1) >> 1
        else:
            v = mm[:, cols]
        return jnp.swapaxes(v, 0, 1)

    def edge_bs(bs_map, n_edges, transposed):
        if bs_map is None:
            return None
        return edge_of(bs_map, n_edges, transposed, avg=False)

    def group_rows(src, n_groups, lines_per_blk):
        # (E, Brows) -> (E, G) per-4-line decision group.
        rows = np.minimum(np.arange(n_groups) * 4 // lines_per_blk,
                          src.shape[1] - 1)
        return src[:, rows]

    def filt_factory(bs_map, transposed, height):
        if chroma:
            def filt(st, _bs):
                # st: (..., E, 4, H); per-line tc from per-block bs
                # (chroma filters only bs==2).
                n_e = st.shape[-3]
                bs_e = edge_bs(bs_map, n_e, transposed)
                if bs_e is None:
                    bs_lines = jnp.full((n_e, height), 2, jnp.int32)
                else:
                    rows = np.minimum(np.arange(height) // blk,
                                      bs_e.shape[1] - 1)
                    bs_lines = bs_e[:, rows]          # (E, H)
                if per_qp:
                    qe = edge_of(qp_map.astype(jnp.int32), n_e,
                                 transposed, avg=True)
                    cq = jnp.take(jnp.asarray(_CHROMA_QP_TAB),
                                  jnp.clip(qe, 0, 51))
                    rows = np.minimum(np.arange(height) // blk,
                                      cq.shape[1] - 1)
                    qpp = cq[:, rows] + (tc_off2 << 1)    # (E, H)
                else:
                    qpp = qp_plus
                tc = _tc_lookup(qpp, jnp.where(bs_lines == 2, 2, 0),
                                scale)
                return _filter_chroma_stripes_tc(st, tc, bitdepth)
            return filt

        def filt(st, _bs):
            n_e = st.shape[-3]
            g = st.shape[-1] // 4
            bs_e = edge_bs(bs_map, n_e, transposed)
            if bs_e is None:
                bs_arr = jnp.full((n_e, g), 2, jnp.int32)
            else:
                bs_arr = group_rows(bs_e, g, blk)
            if per_qp:
                qe = edge_of(qp_map.astype(jnp.int32), n_e, transposed,
                             avg=True)
                qe_g = group_rows(qe, g, blk)              # (E, G)
                b_idx = jnp.clip(qe_g + (beta_off2 << 1), 0, 51)
                beta_l = jnp.asarray(BETA_TABLE)[b_idx] * scale
                qpp = qe_g + (tc_off2 << 1)
            else:
                beta_l = beta
                qpp = qp_plus
            tc = _tc_lookup(qpp, bs_arr, scale)            # (E, G)
            return _filter_luma_stripes(st, beta_l, tc, bitdepth)
        return filt

    h, w = plane.shape[-2], plane.shape[-1]
    plane = _deblock_plane_vertical(
        plane, step, filt_factory(bs_v, False, h), taps, None)
    # Horizontal edges = vertical pass on the transpose.
    planeT = jnp.swapaxes(plane, -1, -2)
    planeT = _deblock_plane_vertical(
        planeT, step, filt_factory(bs_h, True, w), taps, None)
    return jnp.swapaxes(planeT, -1, -2)


def deblock_frame(y, cb, cr, qp: int, cu_size: int, bitdepth: int = 8,
                  beta_off2: int = 0, tc_off2: int = 0,
                  bs_v=None, bs_h=None, qp_map=None):
    """Deblock a full frame (y: (..., H, W); cb/cr half size or None).

    bs_v/bs_h: per-CU-edge boundary strengths on the (By, Bx) grid
    (bs_v[by][bx] = edge at x = bx*S); None = all-intra bs 2.
    qp_map: (By, Bx) int32 per-block luma QP (else uniform `qp`)."""
    y = deblock_plane(y.astype(jnp.int32), qp, cu_size, bitdepth,
                      beta_off2, tc_off2, chroma=False,
                      bs_v=bs_v, bs_h=bs_h, blk=cu_size, qp_map=qp_map)
    if cb is not None:
        cb = deblock_plane(cb.astype(jnp.int32), qp, cu_size // 2,
                           bitdepth, beta_off2, tc_off2, chroma=True,
                           bs_v=bs_v, bs_h=bs_h, blk=cu_size // 2,
                           qp_map=qp_map)
        cr = deblock_plane(cr.astype(jnp.int32), qp, cu_size // 2,
                           bitdepth, beta_off2, tc_off2, chroma=True,
                           bs_v=bs_v, bs_h=bs_h, blk=cu_size // 2,
                           qp_map=qp_map)
    return y, cb, cr
