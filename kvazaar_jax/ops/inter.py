"""Inter prediction ops: fractional-sample interpolation and batched
full-search SAD motion estimation.

Reference behavior: src/strategies/generic/ipol-generic.c (8-tap luma /
4-tap chroma filters), src/inter.c:314 (inter_recon_unipred),
src/search_inter.c:886 (search_mv_full).  Device design notes:

- MC gathers a clamped (S+7)x(S+7) window per block (the gather's index
  clamp IS the spec's edge padding, 8.5.4.2.2) and applies the
  separable filters as per-block 8-tap contractions via the exact
  bf16 einsum layer.
- ME is exhaustive: SAD of every MV in a +-R window, computed as a scan
  over dy with all dx evaluated by static shifts — the reference's
  hexagon/tz searches are branch-and-prune CPU patterns; on the
  accelerator dense evaluation avoids divergence (SURVEY.md §7 stage 5).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from kvazaar_jax.ops.exactmm import einsum_exact

# H.265 Table 8-11: luma 8-tap filters per quarter phase.
LUMA_FILTERS = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
], dtype=np.int32)

# H.265 Table 8-12 (chroma): 4-tap filters per eighth phase.
CHROMA_FILTERS = np.array([
    [0, 64, 0, 0],
    [-2, 58, 10, -2],
    [-4, 54, 16, -2],
    [-6, 46, 28, -4],
    [-4, 36, 36, -4],
    [-4, 28, 46, -6],
    [-2, 16, 54, -4],
    [-2, 10, 58, -2],
], dtype=np.int32)


def gather_windows(plane, x0s, y0s, win: int, ridx=None,
                   val_bound: int = 1 << 15):
    """Clamped window gather: (N, win, win) from (H, W) at per-block
    integer origins (may be out of bounds — clamping implements the
    spec's boundary padding).  With a stacked (R, H, W) plane and
    per-block reference indices `ridx` (N,), each block gathers from
    its own reference picture (multi-ref L0, src/search_inter.c:1134
    per-ref loop collapsed into one batched gather).

    Matrix-unit form: gather aligned 8-px GROUPS row-wise (8x fewer
    gather elements than the naive (N, win, win) gather) and extract
    the mis-aligned window with a per-block one-hot matmul — bit-exact.
    Whether this beats the plain gather on the GPU is not measured
    (ROADMAP A8).
    val_bound: static |value| bound of the plane (<= 256 uses the
    single-pass bf16 product)."""
    h, w = plane.shape[-2], plane.shape[-1]
    if w % 8:
        ys = jnp.clip(y0s[:, None] + jnp.arange(win)[None, :], 0,
                      h - 1)
        xs = jnp.clip(x0s[:, None] + jnp.arange(win)[None, :], 0,
                      w - 1)
        if plane.ndim == 3:
            return plane[ridx[:, None, None], ys[:, :, None],
                         xs[:, None, :]]
        return plane[ys[:, :, None], xs[:, None, :]]
    g = 8
    ng = -(-win // g) + 1
    n = x0s.shape[0]
    ys = jnp.clip(y0s[:, None] + jnp.arange(win)[None, :], 0, h - 1)
    gx0 = jnp.clip(x0s, 0, w - 1) // g
    gx = jnp.clip(gx0[:, None] + jnp.arange(ng)[None, :],
                  0, w // g - 1)
    if plane.ndim == 3:
        rows = plane.reshape(plane.shape[0], h, w // g, g)
        strip = rows[ridx[:, None, None], ys[:, :, None],
                     gx[:, None, :]]
    else:
        rows = plane.reshape(h, w // g, g)
        strip = rows[ys[:, :, None], gx[:, None, :]]
    strip = strip.reshape(n, win, ng * g)
    sx = (jnp.clip(x0s[:, None] + jnp.arange(win)[None, :], 0, w - 1)
          - gx0[:, None] * g)                        # in [0, ng*g)
    oh = (sx[:, None, :]
          == jnp.arange(ng * g)[None, :, None]).astype(jnp.int32)
    return einsum_exact("ncj,nyc->nyj", oh, strip, val_bound)


def _tap_contract(win, coeffs, taps: int, out_len: int, axis_last: bool,
                  x_bound: int):
    """Apply a per-block FIR along the last (or second-to-last) axis.

    win: (N, H, W); coeffs: (N, taps).  Returns (N, H, out_len) for
    axis_last else (N, out_len, W)."""
    if not axis_last:
        return jnp.swapaxes(
            _tap_contract(jnp.swapaxes(win, -1, -2), coeffs, taps,
                          out_len, True, x_bound), -1, -2)
    sl = jnp.stack([win[..., k:k + out_len] for k in range(taps)],
                   axis=1)                      # (N, taps, H, out)
    return einsum_exact("bk,bkyx->byx", coeffs, sl, x_bound)


def mc_luma_hp(plane, x0s, y0s, mvs, size: int, bitdepth: int = 8,
               ridx=None):
    """Luma MC at the 14-bit intermediate precision (8.5.4.2.2.1,
    before the weighted-sample rounding) — the bipred averaging input.

    plane: (H, W) int32 reference (or (R, H, W) with ridx per block);
    x0s/y0s: (N,) block origins; mvs: (N, 2) quarter-pel.
    Returns (N, S, S) int32 14-bit samples."""
    ix = x0s + (mvs[:, 0] >> 2)
    iy = y0s + (mvs[:, 1] >> 2)
    fx = mvs[:, 0] & 3
    fy = mvs[:, 1] & 3
    win = gather_windows(plane, ix - 3, iy - 3, size + 7, ridx,
                         val_bound=1 << bitdepth)
    lf = jnp.asarray(LUMA_FILTERS)
    cfx = lf[fx]                                # (N, 8)
    cfy = lf[fy]
    shift1 = bitdepth - 8
    # Horizontal pass over rows (need size+7 rows for the vertical tap).
    hor = _tap_contract(win, cfx, 8, size, True, 1 << bitdepth)
    hor = hor >> shift1 if shift1 else hor      # 14-bit intermediates
    return _tap_contract(hor, cfy, 8, size, False, 1 << 15) >> 6


def uni_round(hp, bitdepth: int = 8):
    """Default weighted-sample process, uni-pred (8.5.4.2.3.1)."""
    shift = 14 - bitdepth
    off = 1 << (shift - 1)
    return jnp.clip((hp + off) >> shift, 0, (1 << bitdepth) - 1)


def bi_average(hp0, hp1, bitdepth: int = 8):
    """Default weighted-sample process, bi-pred (8.5.4.2.3.2): average
    the two 14-bit predictions with a single final rounding."""
    shift = 15 - bitdepth
    off = 1 << (shift - 1)
    return jnp.clip((hp0 + hp1 + off) >> shift, 0,
                    (1 << bitdepth) - 1)


def mc_luma(plane, x0s, y0s, mvs, size: int, bitdepth: int = 8,
            ridx=None):
    """Motion-compensated luma prediction (uni-pred, 8.5.4.2.2.1).

    plane: (H, W) int32 reference; x0s/y0s: (N,) block origins;
    mvs: (N, 2) quarter-pel (mvx, mvy).  Returns (N, S, S) int32 pixels.
    """
    return uni_round(mc_luma_hp(plane, x0s, y0s, mvs, size, bitdepth,
                                ridx), bitdepth)


def mc_chroma_hp(plane, x0s, y0s, mvs, size: int, bitdepth: int = 8,
                 ridx=None):
    """Chroma MC at 14-bit precision (4-tap, eighth-pel).  mvs are the
    LUMA quarter-pel MVs; chroma MV = luma MV (eighth-pel in chroma
    samples for 4:2:0)."""
    cx = mvs[:, 0]
    cy = mvs[:, 1]
    ix = x0s + (cx >> 3)
    iy = y0s + (cy >> 3)
    fx = cx & 7
    fy = cy & 7
    win = gather_windows(plane, ix - 1, iy - 1, size + 3, ridx,
                         val_bound=1 << bitdepth)
    cf = jnp.asarray(CHROMA_FILTERS)
    shift1 = bitdepth - 8
    hor = _tap_contract(win, cf[fx], 4, size, True, 1 << bitdepth)
    hor = hor >> shift1 if shift1 else hor
    return _tap_contract(hor, cf[fy], 4, size, False, 1 << 15) >> 6


def mc_chroma(plane, x0s, y0s, mvs, size: int, bitdepth: int = 8,
              ridx=None):
    return uni_round(mc_chroma_hp(plane, x0s, y0s, mvs, size, bitdepth,
                                  ridx), bitdepth)


def sad_full_search(cur_blocks, ref_plane, x0s, y0s, radius: int,
                    size: int):
    """Exhaustive integer-pel SAD over a +-radius window.

    cur_blocks: (N, S, S); ref_plane: (H, W); x0s/y0s: (N,).
    Returns sads: (N, 2R+1, 2R+1) int32 indexed [dy+R, dx+R].

    Generic (arbitrary block origins) gather-based form — kept for unit
    tests and odd geometries; the frame search uses sad_surfaces (the
    whole-plane shift + matmul-reduction form).
    """
    r = radius
    n = cur_blocks.shape[0]
    cur = cur_blocks.astype(jnp.int32)

    def row_sads(dy):
        # Rows y0+dy..y0+dy+S-1, columns x0-R..x0+S+R-1 (clamped).
        win = gather_windows(ref_plane, x0s - r, y0s + dy,
                             size + 2 * r)[:, :size, :]
        # (N, S, S+2R) -> SAD for each dx by static shifts.
        sl = jnp.stack([win[..., k:k + size] for k in range(2 * r + 1)],
                       axis=1)                  # (N, 2R+1, S, S)
        return jnp.sum(jnp.abs(sl - cur[:, None]), axis=(-2, -1))

    dys = jnp.arange(-r, r + 1)
    sads = jax.lax.map(row_sads, dys)           # (2R+1, N, 2R+1)
    return jnp.transpose(sads, (1, 0, 2)).astype(jnp.int32)


@functools.lru_cache(maxsize=None)
def _block_reduce_mats(h: int, w: int, size: int):
    """0/1 matrices that sum a plane over size-aligned block rows/cols
    via banded 0/1 matmuls (chosen over reshape-sums for the matrix
    unit; not re-measured on the GPU, ROADMAP A8)."""
    colm = np.zeros((w, w // size), np.int32)
    for b in range(w // size):
        colm[b * size:(b + 1) * size, b] = 1
    rowm = np.zeros((h // size, h), np.int32)
    for b in range(h // size):
        rowm[b, b * size:(b + 1) * size] = 1
    return rowm, colm


def sad_surfaces(cur_plane, ref_plane, radius: int, size: int,
                 bitdepth: int = 8):
    """Exhaustive integer-pel SAD surfaces for every size-aligned block
    of the frame at once: (By, Bx, 2R+1, 2R+1) int32 indexed
    [by, bx, dy+R, dx+R].

    Device design (the search_mv_full capability, src/search_inter.c:886,
    restructured): instead of per-block window gathers, shift the WHOLE
    reference plane (edge padding = the spec's boundary clamp), take
    absolute differences against the current plane, and reduce to
    per-block sums with banded 0/1 matmuls on the matrix unit.  One lax.map
    step per dy keeps peak memory at (2R+1, H, W)."""
    h, w = cur_plane.shape
    r = radius
    cur = cur_plane.astype(jnp.int32)
    pad = jnp.pad(ref_plane.astype(jnp.int32), r, mode="edge")
    rowm, colm = _block_reduce_mats(h, w, size)
    rowmj = jnp.asarray(rowm)
    colmj = jnp.asarray(colm)
    d_bound = (1 << bitdepth) - 1

    def row_sads(dy):
        rows = jax.lax.dynamic_slice(pad, (dy, 0), (h, w + 2 * r))
        sl = jnp.stack([rows[:, k:k + w] for k in range(2 * r + 1)],
                       axis=0)                   # (2R+1, H, W)
        # |diff| fits 2^bitdepth-1: materialize the (2R+1, H, W)
        # intermediate at the narrowest dtype (the stage is
        # HBM-bandwidth-bound; int32 here costs 4x the traffic).
        d = jnp.abs(sl - cur[None])
        d = d.astype(jnp.uint8 if bitdepth <= 8 else jnp.int16)
        colred = einsum_exact("wb,dhw->dhb", colmj, d, d_bound)
        return einsum_exact("yh,dhb->dyb", rowmj, colred,
                            size * d_bound)      # (2R+1, By, Bx)

    sads = jax.lax.map(row_sads, jnp.arange(2 * r + 1))
    return jnp.transpose(sads, (2, 3, 0, 1))     # (By, Bx, Ddy, Ddx)


def sad_surfaces_multi(cur_plane, ref_plane, radius: int, sizes,
                       bitdepth: int = 8):
    """Integer-pel SAD surfaces for SEVERAL block sizes in one plane
    pass.  SAD is additive over sub-blocks, so the surface at the
    smallest size is computed with the banded-matmul reduction and the
    larger sizes are 2x2 block-sums of it at the same displacement —
    the |diff| stage (the dominant cost of sad_surfaces) runs ONCE for
    the whole size ladder instead of once per size (the reference
    searches each depth independently, src/search.c:424; sharing the
    SAD pyramid is the whole-frame restructuring).

    Returns {size: (H//size, W//size, 2R+1, 2R+1) int32}.  Grids use
    floor division: a plane not divisible by a larger size yields the
    aligned-crop grid for that size, with SADs computed against the
    full plane (real pixels beyond the crop instead of the edge
    clamp — a search-quality detail, not a conformance one)."""
    h, w = cur_plane.shape
    r = radius
    szs = sorted(set(int(s) for s in sizes))
    base = szs[0]
    cur = cur_plane.astype(jnp.int32)
    pad = jnp.pad(ref_plane.astype(jnp.int32), r, mode="edge")
    rowm, colm = _block_reduce_mats(h, w, base)
    rowmj = jnp.asarray(rowm)
    colmj = jnp.asarray(colm)
    d_bound = (1 << bitdepth) - 1

    def row_sads(dy):
        rows = jax.lax.dynamic_slice(pad, (dy, 0), (h, w + 2 * r))
        sl = jnp.stack([rows[:, k:k + w] for k in range(2 * r + 1)],
                       axis=0)                   # (2R+1, H, W)
        d = jnp.abs(sl - cur[None])
        d = d.astype(jnp.uint8 if bitdepth <= 8 else jnp.int16)
        colred = einsum_exact("wb,dhw->dhb", colmj, d, d_bound)
        s_now = einsum_exact("yh,dhb->dyb", rowmj, colred,
                             base * d_bound)     # (2R+1, By, Bx)
        outs = []
        sz_now = base
        for s in szs:
            while sz_now < s:
                by2 = s_now.shape[1] // 2
                bx2 = s_now.shape[2] // 2
                s_now = (s_now[:, 0:2 * by2:2, 0:2 * bx2:2]
                         + s_now[:, 1:2 * by2:2, 0:2 * bx2:2]
                         + s_now[:, 0:2 * by2:2, 1:2 * bx2:2]
                         + s_now[:, 1:2 * by2:2, 1:2 * bx2:2])
                sz_now *= 2
            outs.append(s_now)
        return tuple(outs)

    outs = jax.lax.map(row_sads, jnp.arange(2 * r + 1))
    return {s: jnp.transpose(o, (2, 3, 0, 1))
            for s, o in zip(szs, outs)}


def box4_mean(plane):
    """4x4 mean-pool (floor), value range preserved — the coarse level
    of the hierarchical ME pyramid."""
    h, w = plane.shape
    h4, w4 = h // 4, w // 4
    p = plane[:h4 * 4, :w4 * 4].astype(jnp.int32)
    return p.reshape(h4, 4, w4, 4).sum(axis=(1, 3)) >> 4


def coarse_mv_grids(cur, ref, radius: int, sizes, bitdepth: int = 8):
    """Hierarchical ME stage 1: dense SAD surfaces at 4x downsample,
    argmin winners returned as per-size full-res MV hint grids in
    QPEL units ({size: (H/size, W/size, 2) int32, (x, y)}).

    The full-resolution dense surface is HBM-bandwidth-bound (the
    shifted |diff| stacks move ~tens of GB per 1080p frame); at ds4 the
    same logical search touches 1/256 of the bytes.  Sizes < 16 share
    the 16 winner (their ds4 blocks are too small to rank reliably);
    stage 2 (_int_refine_sads in inter_search) re-searches +-rng
    full-res pixels around the hint and around zero, so hints only
    need to be coarse.  Capability parity: the reference's default
    presets use sparse hexbs/tz searches (src/search_inter.c:690,595);
    coarse+refine covers at least the same effective range densely."""
    c4 = box4_mean(cur)
    r4 = box4_mean(ref)
    rad4 = max(radius // 4, 2)
    want = sorted({int(s) for s in sizes if s >= 16}) or [16]
    surf = sad_surfaces_multi(c4, r4, rad4, tuple(s // 4 for s in want),
                              bitdepth)
    d = 2 * rad4 + 1
    out = {}
    for s in want:
        su = surf[s // 4]
        byc, bxc = su.shape[:2]
        idx = jnp.argmin(su.reshape(byc, bxc, d * d), axis=-1)
        mvy = (idx // d - rad4) * 16          # ds4 step = 4 px = 16 qpel
        mvx = (idx % d - rad4) * 16
        out[s] = jnp.stack([mvx, mvy], axis=-1).astype(jnp.int32)
    parent = min(out)
    for s in sizes:
        if s < 16:
            f = parent // s
            out[s] = jnp.repeat(jnp.repeat(out[parent], f, 0), f, 1)
    return out


def refine_qpel_dense(cur_blocks, ref_plane, x0s, y0s, mv_int,
                      size: int, bitdepth: int = 8, ridx=None):
    """Dense quarter-pel refinement: SATD of ALL 49 subpel positions in
    the 7x7 quarter-pel grid around each block's integer-pel winner.

    The reference refines half-then-quarter with 8 positions each
    (search_frac, src/search_inter.c:965); here the full grid is
    evaluated at once instead of in two dependent stages: every candidate
    lies within +-0.75 px of mv_int, so ONE (24, 24) window gather per
    block covers all 49 predictions, which are then computed by static
    slices + 8-tap contractions (no further gathers).

    cur_blocks: (N, S, S) int32; mv_int: (N, 2) qpel, multiples of 4.
    Returns satd: (N, 49) int32 in (qy, qx) row-major order over
    qy, qx in -3..3 (use QPEL_OFFSETS for the mv deltas)."""
    from kvazaar_jax.encoder.intra_search import satd8_batch
    n = cur_blocks.shape[0]
    ox = x0s + (mv_int[:, 0] >> 2) - 4
    oy = y0s + (mv_int[:, 1] >> 2) - 4
    w_ = size + 8
    win = gather_windows(ref_plane, ox, oy, w_, ridx,
                         val_bound=1 << bitdepth)
    shift1 = bitdepth - 8

    # Banded-matmul taps with ALL 7 phases fused per axis: one
    # (W, 7S) block-banded matrix per direction turns 56 tiny
    # (W, S)-output GEMMs into two (W, 7S)-output GEMMs.
    def _bands():
        b = np.zeros((w_, 7 * size), np.int32)
        for qi, q in enumerate(range(-3, 4)):
            iq, fq = q >> 2, q & 3
            c0 = 1 + iq
            for k in range(8):
                for x in range(size):
                    b[c0 + x + k, qi * size + x] = LUMA_FILTERS[fq][k]
        return jnp.asarray(b)

    bands = _bands()
    hv = einsum_exact("wk,nyw->nyk", bands, win,
                      1 << bitdepth)                # (N, W, 7S)
    if shift1:
        hv = hv >> shift1
    # out[n, (qy, y), (qx, x)] — every (qy, qx) phase pair at once.
    v = einsum_exact("wk,nwx->nkx", bands, hv, 1 << 15) >> 6
    v = v.reshape(n, 7, size, 7, size).transpose(0, 1, 3, 2, 4)
    preds = uni_round(v.reshape(n, 49, size, size), bitdepth)
    return satd8_batch(preds - cur_blocks[:, None])


QPEL_OFFSETS = np.array([(qx, qy) for qy in range(-3, 4)
                         for qx in range(-3, 4)], np.int32)


@functools.lru_cache(maxsize=None)
def _fir_band_mat(n_out: int, phase: int):
    """Banded (n_out + 8, n_out) matrix applying the 8-tap luma filter
    of `phase` along an axis padded by 4 on each side:
    out[X] = sum_k LUMA_FILTERS[phase][k] * in[1 + X + k]."""
    m = np.zeros((n_out + 8, n_out), np.int32)
    for k in range(8):
        m[1 + k:1 + k + n_out, :][np.arange(n_out),
                                  np.arange(n_out)] = \
            LUMA_FILTERS[phase][k]
    return m


def luma_phase_planes(ref_plane, bitdepth: int = 8, extend: int = 0):
    """All 16 quarter-pel interpolated planes of a reference at the
    14-bit intermediate precision: (4, 4, He, We) int32 indexed
    [fy, fx], where plane[fy, fx][y, x] is the 8.5.4.2.2.1 sample at
    (y + fy/4, x + fx/4) on an edge-extended grid.

    `extend` replicates the frame border by E pixels BEFORE
    interpolation so that reads at out-of-frame base positions (MC with
    MVs pointing outside, |overreach| <= E) reproduce the per-sample
    clamp of gather-based MC exactly.  Rationale: each separable FIR
    pass is a banded-matrix matmul (shift-stack passes materialize
    (8, H, W) intermediates and are memory-bound); per-block
    MC then needs only ONE stacked gather (mc_luma_phases)."""
    e = extend
    if e:
        ref_plane = jnp.pad(ref_plane, e, mode="edge")
    h, w = ref_plane.shape
    pad = jnp.pad(ref_plane.astype(jnp.int32), 4, mode="edge")
    shift1 = bitdepth - 8
    hors = []
    for fx in range(4):
        a = jnp.asarray(_fir_band_mat(w, fx))     # (W+8, W)
        hv = einsum_exact("xX,yx->yX", a, pad,
                          (1 << bitdepth) - 1)    # (H+8, W)
        hors.append(hv >> shift1 if shift1 else hv)
    planes = []
    for fy in range(4):
        b = jnp.asarray(_fir_band_mat(h, fy))     # (H+8, H)
        row = [einsum_exact("hY,hx->Yx", b, hors[fx], 1 << 15) >> 6
               for fx in range(4)]
        planes.append(jnp.stack(row))
    return jnp.stack(planes)                      # (4, 4, H, W) 14-bit


def mc_luma_phases_hp(planes, x0s, y0s, mvs, size: int,
                      extend: int = 0, ridx=None):
    """14-bit luma MC from precomputed phase planes: one gather.

    planes: (4, 4, He, We) from luma_phase_planes (or (R, 4, 4, He, We)
    stacked references with per-block `ridx`); mvs: (N, 2) qpel.
    Returns (N, S, S) int32 14-bit samples."""
    fx = mvs[:, 0] & 3
    fy = mvs[:, 1] & 3
    ix = x0s + (mvs[:, 0] >> 2) + extend
    iy = y0s + (mvs[:, 1] >> 2) + extend
    if planes.ndim == 5:
        nref = planes.shape[0]
        flat = planes.reshape((nref * 16,) + planes.shape[-2:])
        pidx = ridx * 16 + fy * 4 + fx
    else:
        flat = planes.reshape((16,) + planes.shape[-2:])
        pidx = fy * 4 + fx
    return gather_windows(flat, ix, iy, size, pidx)
