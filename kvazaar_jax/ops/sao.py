"""Sample-adaptive offset (H.265 8.7.3): search statistics, parameter
selection, and reconstruction — frame-batched.

Reference behavior: /root/reference/src/sao.c (kvz_sao_search_lcu:646,
sao_search_best_mode:467, kvz_sao_reconstruct:278) and the boundary
buffering in src/encoderstate.c:245-440.  Device design: SAO is a pure
post-pass over the deblocked frame, so the reference's per-CTU in-place
processing (and its pre-SAO boundary buffers) collapses into whole-frame
elementwise category computation + per-CTU segment sums; offsets are
chosen closed-form from (count, diff-sum) statistics exactly like the
reference's sao_calc_offset.

Conventions: type 0 = OFF, 1 = BAND, 2 = EDGE (matches sao_type_idx
semantics).  Edge offsets are stored signed (+,+,-,-) as applied;
band offsets signed; band_position = first of 4 consecutive bands.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Edge class neighbor directions (8.7.3: 0=0deg, 1=90deg, 2=135deg,
# 3=45deg).
EO_DIRS = ((1, 0), (0, 1), (1, 1), (1, -1))


def _edge_categories(plane, dx: int, dy: int):
    """Per-pixel edge category 0..4 for one class; picture-boundary
    pixels (either neighbor outside) are category 0."""
    h, w = plane.shape[-2:]
    p = plane.astype(jnp.int32)

    def shifted(sx, sy):
        pad = jnp.pad(p, [(0, 0)] * (p.ndim - 2)
                      + [(1, 1), (1, 1)], mode="edge")
        return pad[..., 1 + sy:1 + sy + h, 1 + sx:1 + sx + w]

    a = shifted(-dx, -dy)
    b = shifted(dx, dy)
    sgn_a = jnp.sign(p - a)
    sgn_b = jnp.sign(p - b)
    s = sgn_a + sgn_b
    cat = jnp.where(s == -2, 1,
                    jnp.where(s == -1, 2,
                              jnp.where(s == 1, 3,
                                        jnp.where(s == 2, 4, 0))))
    yy = jnp.arange(h)
    xx = jnp.arange(w)
    inside_y = (yy[:, None] + dy >= 0) & (yy[:, None] + dy < h) & \
               (yy[:, None] - dy >= 0) & (yy[:, None] - dy < h)
    inside_x = (xx[None, :] + dx >= 0) & (xx[None, :] + dx < w) & \
               (xx[None, :] - dx >= 0) & (xx[None, :] - dx < w)
    return jnp.where(inside_y & inside_x, cat, 0)


def _tile_sum(x, ctu: int, cy: int, cx: int):
    """Sum over CTU tiles: (..., Cy*ctu, Cx*ctu) -> (..., Cy, Cx)."""
    sh = x.shape[:-2]
    t = x.reshape(*sh, cy, ctu, cx, ctu)
    return t.sum(axis=(-3, -1))


def sao_stats(orig, rec, ctu: int = 64, bitdepth: int = 8):
    """Per-CTU SAO statistics for one plane.

    orig/rec: (H, W) int32 on the coded size (any multiple of 8);
    partial boundary CTUs are handled by zero-padding the category and
    diff maps (padding contributes nothing).
    Returns (edge_cnt (4, 5, Cy, Cx), edge_sum (4, 5, Cy, Cx),
    band_cnt (32, Cy, Cx), band_sum (32, Cy, Cx))."""
    h, w = rec.shape
    cy, cx = -(-h // ctu), -(-w // ctu)
    ph, pw = cy * ctu - h, cx * ctu - w
    diff = (orig - rec).astype(jnp.int32)
    diff = jnp.pad(diff, ((0, ph), (0, pw)))

    def padcat(c, fill):
        return jnp.pad(c, ((0, ph), (0, pw)), constant_values=fill)

    e_cnt = []
    e_sum = []
    for (dx, dy) in EO_DIRS:
        cat = padcat(_edge_categories(rec, dx, dy), 0)
        cnts = []
        sums = []
        for k in range(5):
            m = (cat == k).astype(jnp.int32)
            cnts.append(_tile_sum(m, ctu, cy, cx))
            sums.append(_tile_sum(diff * m, ctu, cy, cx))
        e_cnt.append(jnp.stack(cnts))
        e_sum.append(jnp.stack(sums))

    shift = bitdepth - 5
    band = padcat((rec >> shift).astype(jnp.int32), -1)
    b_cnt = []
    b_sum = []
    for k in range(32):
        m = (band == k).astype(jnp.int32)
        b_cnt.append(_tile_sum(m, ctu, cy, cx))
        b_sum.append(_tile_sum(diff * m, ctu, cy, cx))
    return (jnp.stack(e_cnt), jnp.stack(e_sum), jnp.stack(b_cnt),
            jnp.stack(b_sum))


def _best_offset(cnt, acc, sign):
    """Closed-form offset choice per category (the reference's
    sao_calc_offset + dist model): offset = clamp(round(acc/cnt)) with
    spec sign constraint; returns (offset, ddist) where ddist =
    cnt*off^2 - 2*off*acc (negative = improvement)."""
    cnt = cnt.astype(np.int64)
    acc = acc.astype(np.int64)
    with np.errstate(divide="ignore", invalid="ignore"):
        off = np.where(cnt > 0,
                       np.round(acc / np.maximum(cnt, 1)), 0)
    off = np.clip(off, -7, 7).astype(np.int64)
    if sign > 0:
        off = np.maximum(off, 0)
    elif sign < 0:
        off = np.minimum(off, 0)
    # refine +-1 around the rounded value (the quadratic is exact)
    best_off = np.zeros_like(off)
    best_d = np.zeros_like(off)
    for delta in (-1, 0, 1):
        o = np.clip(off + delta, -7, 7)
        if sign > 0:
            o = np.maximum(o, 0)
        elif sign < 0:
            o = np.minimum(o, 0)
        d = cnt * o * o - 2 * o * acc
        take = d < best_d
        best_off = np.where(take, o, best_off)
        best_d = np.where(take, d, best_d)
    return best_off, best_d


def _offset_bits(off, edge: bool):
    """Approximate signalling bits of one offset (TR cMax 7 bypass +
    sign for band)."""
    a = np.abs(off)
    bits = np.minimum(a + 1, 7)
    if not edge:
        bits = bits + (a > 0)
    return bits


def choose_sao_params(e_cnt, e_sum, b_cnt, b_sum, lam: float):
    """Per-CTU parameter selection for one component from device stats
    (numpy).  Returns dict with arrays over (Cy, Cx): type (0/1/2),
    eo_class, band_pos, offsets (4,) signed, cost (RD of the choice;
    OFF has cost 0 baseline + ~1 bit)."""
    _, _, cy, cx = e_cnt.shape
    best_type = np.zeros((cy, cx), np.int8)
    best_eo = np.zeros((cy, cx), np.int8)
    best_bp = np.zeros((cy, cx), np.int8)
    best_off = np.zeros((cy, cx, 4), np.int8)
    # OFF: ddist 0, ~1 bit for type.
    best_cost = np.full((cy, cx), lam * 1.0)

    for cls in range(4):
        offs = np.zeros((cy, cx, 4), np.int64)
        dd = np.zeros((cy, cx), np.int64)
        bits = np.full((cy, cx), 4.0)   # type(2) + eo_class(2)
        for k, sign in zip(range(1, 5), (1, 1, -1, -1)):
            o, d = _best_offset(e_cnt[cls, k], e_sum[cls, k], sign)
            offs[:, :, k - 1] = o
            dd += d
            bits += _offset_bits(o, True)
        cost = dd + lam * bits
        take = cost < best_cost
        best_cost = np.where(take, cost, best_cost)
        best_type = np.where(take, 2, best_type)
        best_eo = np.where(take, cls, best_eo)
        best_off = np.where(take[..., None], offs, best_off)

    # Band: best 4-consecutive-band window.
    boffs = np.zeros((32, cy, cx), np.int64)
    bdd = np.zeros((32, cy, cx), np.int64)
    for k in range(32):
        o, d = _best_offset(b_cnt[k], b_sum[k], 0)
        boffs[k] = o
        bdd[k] = d
    for bp in range(32):
        # The 4-band window wraps (8.7.3: bandTable[(bp + i) & 31]).
        idx = [(bp + i) & 31 for i in range(4)]
        dd = sum(bdd[i] for i in idx)
        obits = sum(_offset_bits(boffs[i], False) for i in idx)
        cost = dd + lam * (2.0 + 5.0 + obits)
        take = cost < best_cost
        if not take.any():
            continue
        best_cost = np.where(take, cost, best_cost)
        best_type = np.where(take, 1, best_type)
        best_bp = np.where(take, bp, best_bp)
        woff = np.stack([boffs[i] for i in idx], axis=-1)
        best_off = np.where(take[..., None], woff, best_off)

    return dict(type=best_type, eo_class=best_eo, band_pos=best_bp,
                offsets=best_off.astype(np.int8), cost=best_cost)


def _dd_edge(e_cnt, e_sum, cls, offs, cy, cx):
    dd = np.zeros((cy, cx), np.int64)
    for k in range(1, 5):
        o = offs[..., k - 1].astype(np.int64)
        dd += e_cnt[cls, k] * o * o - 2 * o * e_sum[cls, k]
    return dd


def _dd_band(b_cnt, b_sum, bp, offs, cy, cx):
    dd = np.zeros((cy, cx), np.int64)
    for i in range(4):
        idx = (bp + i) & 31
        o = offs[..., i].astype(np.int64)
        cnt = np.take_along_axis(b_cnt, idx[None], axis=0)[0]
        sm = np.take_along_axis(b_sum, idx[None], axis=0)[0]
        dd += cnt * o * o - 2 * o * sm
    return dd


def sao_decide_frame(stats_y, stats_c, lam: float,
                     tile_col=None, tile_row=None):
    """Full SAO parameter decision for one frame from device stats.

    stats_y: (e_cnt, e_sum, b_cnt, b_sum) luma; stats_c: ((cb...),
    (cr...)) or None.  Returns the FrameData-style arrays: merge
    (Cy,Cx), type (Cy,Cx,2), eo (Cy,Cx,2), bp (Cy,Cx,3),
    off (Cy,Cx,3,4) — resolved post-merge values (reference analogue:
    sao_search_best_mode + merge evaluation, src/sao.c:467-646)."""
    e_cnt, e_sum, b_cnt, b_sum = [np.asarray(a) for a in stats_y]
    _, _, cy, cx = e_cnt.shape
    luma = choose_sao_params(e_cnt, e_sum, b_cnt, b_sum, lam)
    chroma = stats_c is not None
    if chroma:
        scb = [np.asarray(a) for a in stats_c[0]]
        scr = [np.asarray(a) for a in stats_c[1]]
        cpar = _choose_chroma(scb, scr, lam)

    n_t = np.zeros((cy, cx, 2), np.uint8)
    n_eo = np.zeros((cy, cx, 2), np.uint8)
    n_bp = np.zeros((cy, cx, 3), np.uint8)
    n_off = np.zeros((cy, cx, 3, 4), np.int8)
    n_merge = np.zeros((cy, cx), np.uint8)
    n_t[:, :, 0] = luma["type"]
    n_eo[:, :, 0] = luma["eo_class"]
    n_bp[:, :, 0] = luma["band_pos"]
    n_off[:, :, 0] = luma["offsets"]
    own_cost = luma["cost"].copy()
    if chroma:
        n_t[:, :, 1] = cpar["type"]
        n_eo[:, :, 1] = cpar["eo_class"]
        n_bp[:, :, 1] = cpar["bp_cb"]
        n_bp[:, :, 2] = cpar["bp_cr"]
        n_off[:, :, 1] = cpar["off_cb"]
        n_off[:, :, 2] = cpar["off_cr"]
        own_cost = own_cost + cpar["cost"]

    def cost_with(params, yy, xx):
        """RD of applying (t, eo, bp, off) params at CTU (yy, xx)."""
        t2, eo2, bp2, off2 = params
        c = 0.0
        comps = [(0, e_cnt, e_sum, b_cnt, b_sum)]
        if chroma:
            comps += [(1, scb[0], scb[1], scb[2], scb[3]),
                      (2, scr[0], scr[1], scr[2], scr[3])]
        for (ci, ec, es, bc, bs) in comps:
            t = int(t2[0 if ci == 0 else 1])
            offs = off2[ci].astype(np.int64)
            if t == 2:
                cls = int(eo2[0 if ci == 0 else 1])
                dd = 0
                for k in range(1, 5):
                    o = int(offs[k - 1])
                    dd += int(ec[cls, k, yy, xx]) * o * o \
                        - 2 * o * int(es[cls, k, yy, xx])
                c += dd
            elif t == 1:
                bp = int(bp2[ci])
                dd = 0
                for i in range(4):
                    idx = (bp + i) & 31
                    o = int(offs[i])
                    dd += int(bc[idx, yy, xx]) * o * o \
                        - 2 * o * int(bs[idx, yy, xx])
                c += dd
        return c

    # Greedy raster merge decisions (exact RD on the stats).
    # Merge flags exist only toward neighbors in the SAME tile
    # (7.3.8.3 conditions; tile_col/tile_row: tile id per CTU axis).
    def left_ok(yy, xx):
        return xx > 0 and (tile_col is None
                           or tile_col[xx - 1] == tile_col[xx])

    def up_ok(yy, xx):
        return yy > 0 and (tile_row is None
                           or tile_row[yy - 1] == tile_row[yy])

    for yy in range(cy):
        for xx in range(cx):
            best = own_cost[yy, xx] + lam * (left_ok(yy, xx)
                                             + up_ok(yy, xx))
            choice = 0
            if left_ok(yy, xx):
                p = (n_t[yy, xx - 1], n_eo[yy, xx - 1],
                     n_bp[yy, xx - 1], n_off[yy, xx - 1])
                cm = cost_with(p, yy, xx) + lam * 1.0
                if cm < best:
                    best, choice = cm, 1
            if up_ok(yy, xx):
                p = (n_t[yy - 1, xx], n_eo[yy - 1, xx],
                     n_bp[yy - 1, xx], n_off[yy - 1, xx])
                cm = cost_with(p, yy, xx) + lam * (left_ok(yy, xx)
                                                   + 1.0)
                if cm < best:
                    best, choice = cm, 2
            if choice:
                sy, sx = (yy, xx - 1) if choice == 1 else (yy - 1, xx)
                n_t[yy, xx] = n_t[sy, sx]
                n_eo[yy, xx] = n_eo[sy, sx]
                n_bp[yy, xx] = n_bp[sy, sx]
                n_off[yy, xx] = n_off[sy, sx]
                n_merge[yy, xx] = choice
    return dict(merge=n_merge, type=n_t, eo=n_eo, bp=n_bp, off=n_off)


def _choose_chroma(scb, scr, lam):
    """Joint cb+cr choice: shared type and eo_class (7.3.8.3),
    separate offsets and band positions."""
    ecb, esb, bcb, bsb = scb
    ecr, esr, bcr, bsr = scr
    _, _, cy, cx = ecb.shape
    best = dict(type=np.zeros((cy, cx), np.uint8),
                eo_class=np.zeros((cy, cx), np.uint8),
                bp_cb=np.zeros((cy, cx), np.uint8),
                bp_cr=np.zeros((cy, cx), np.uint8),
                off_cb=np.zeros((cy, cx, 4), np.int8),
                off_cr=np.zeros((cy, cx, 4), np.int8),
                cost=np.full((cy, cx), lam * 1.0))
    for cls in range(4):
        offs_b = np.zeros((cy, cx, 4), np.int64)
        offs_r = np.zeros((cy, cx, 4), np.int64)
        dd = np.zeros((cy, cx), np.int64)
        bits = np.full((cy, cx), 4.0)
        for k, sign in zip(range(1, 5), (1, 1, -1, -1)):
            ob, db = _best_offset(ecb[cls, k], esb[cls, k], sign)
            orr, dr = _best_offset(ecr[cls, k], esr[cls, k], sign)
            offs_b[:, :, k - 1] = ob
            offs_r[:, :, k - 1] = orr
            dd += db + dr
            bits += _offset_bits(ob, True) + _offset_bits(orr, True)
        cost = dd + lam * bits
        take = cost < best["cost"]
        best["cost"] = np.where(take, cost, best["cost"])
        best["type"] = np.where(take, 2, best["type"])
        best["eo_class"] = np.where(take, cls, best["eo_class"])
        best["off_cb"] = np.where(take[..., None], offs_b,
                                  best["off_cb"]).astype(np.int8)
        best["off_cr"] = np.where(take[..., None], offs_r,
                                  best["off_cr"]).astype(np.int8)

    def band_best(bc, bs):
        boffs = np.zeros((32, cy, cx), np.int64)
        bdd = np.zeros((32, cy, cx), np.int64)
        for k in range(32):
            o, d = _best_offset(bc[k], bs[k], 0)
            boffs[k] = o
            bdd[k] = d
        bcost = np.full((cy, cx), np.inf)
        bbp = np.zeros((cy, cx), np.uint8)
        boff = np.zeros((cy, cx, 4), np.int64)
        for bp in range(32):
            idx = [(bp + i) & 31 for i in range(4)]
            dd = sum(bdd[i] for i in idx)
            bits = 5.0 + sum(_offset_bits(boffs[i], False) for i in idx)
            cost = dd + lam * bits
            take = cost < bcost
            bcost = np.where(take, cost, bcost)
            bbp = np.where(take, bp, bbp)
            w = np.stack([boffs[i] for i in idx], axis=-1)
            boff = np.where(take[..., None], w, boff)
        return bcost, bbp, boff

    cb_cost, cb_bp, cb_off = band_best(bcb, bsb)
    cr_cost, cr_bp, cr_off = band_best(bcr, bsr)
    cost = cb_cost + cr_cost + lam * 2.0
    take = cost < best["cost"]
    best["cost"] = np.where(take, cost, best["cost"])
    best["type"] = np.where(take, 1, best["type"])
    best["bp_cb"] = np.where(take, cb_bp, best["bp_cb"]).astype(np.uint8)
    best["bp_cr"] = np.where(take, cr_bp, best["bp_cr"]).astype(np.uint8)
    best["off_cb"] = np.where(take[..., None], cb_off,
                              best["off_cb"]).astype(np.int8)
    best["off_cr"] = np.where(take[..., None], cr_off,
                              best["off_cr"]).astype(np.int8)
    return best


def apply_sao_plane(rec, sao_type, eo_class, band_pos, offsets,
                    ctu: int = 64, bitdepth: int = 8):
    """Apply per-CTU SAO params to one plane (device, elementwise).

    rec: (H, W) int; param arrays over (Cy, Cx); offsets (Cy, Cx, 4)
    signed.  Returns the filtered plane (same dtype)."""
    h, w = rec.shape
    cy, cx = sao_type.shape[:2]
    p = rec.astype(jnp.int32)
    ctuy = jnp.arange(h) // ctu
    ctux = jnp.arange(w) // ctu
    t_map = sao_type[ctuy[:, None], ctux[None, :]]
    # Edge: category per chosen class (compute all 4, select).
    cats = jnp.stack([_edge_categories(p, dx, dy)
                      for (dx, dy) in EO_DIRS])      # (4, H, W)
    cls_map = eo_class[ctuy[:, None], ctux[None, :]].astype(jnp.int32)
    cat = jnp.take_along_axis(cats, cls_map[None], axis=0)[0]
    # offsets table per CTU with leading 0 for category 0.
    off5 = jnp.concatenate(
        [jnp.zeros((cy, cx, 1), jnp.int32),
         offsets.astype(jnp.int32)], axis=-1)       # (Cy, Cx, 5)
    eo_off = off5[ctuy[:, None], ctux[None, :], cat]
    # Band.
    shift = bitdepth - 5
    band = p >> shift
    bp_map = band_pos[ctuy[:, None], ctux[None, :]].astype(jnp.int32)
    widx = (band - bp_map) & 31           # window wraps (8.7.3)
    in_win = widx < 4
    b_off = jnp.where(
        in_win,
        off5[ctuy[:, None], ctux[None, :], jnp.clip(widx, 0, 3) + 1],
        0)
    out = jnp.where(t_map == 2, p + eo_off,
                    jnp.where(t_map == 1, p + b_off, p))
    return jnp.clip(out, 0, (1 << bitdepth) - 1).astype(rec.dtype)


# ---------------------------------------------------------------------
# Device-side parameter decision (jnp): the host decide above costs a
# full device sync in the submit path (stats download + per-CTU merge
# loop) — at veryslow 1080p that serialization halved throughput.  The
# same math in jnp keeps recon -> stats -> decide -> apply -> DPB
# entirely device-resident; only the small resolved-params buffer is
# downloaded later by the finalize worker.  Merge decisions keep the
# greedy raster RD semantics via an anti-diagonal wavefront (a cell's
# left/up neighbors sit on the previous diagonal).
# ---------------------------------------------------------------------

def _best_offset_jnp(cnt, acc, sign: int):
    """jnp port of _best_offset: closed-form per-category offset with
    the +-1 quadratic refinement.  cnt/acc int32 -> (off, ddist)."""
    cnt = cnt.astype(jnp.int32)
    acc = acc.astype(jnp.int32)
    off = jnp.where(cnt > 0,
                    jnp.round(acc / jnp.maximum(cnt, 1)), 0)
    off = jnp.clip(off, -7, 7).astype(jnp.int32)
    if sign > 0:
        off = jnp.maximum(off, 0)
    elif sign < 0:
        off = jnp.minimum(off, 0)
    best_off = jnp.zeros_like(off)
    best_d = jnp.zeros_like(off)
    for delta in (-1, 0, 1):
        o = jnp.clip(off + delta, -7, 7)
        if sign > 0:
            o = jnp.maximum(o, 0)
        elif sign < 0:
            o = jnp.minimum(o, 0)
        d = cnt * o * o - 2 * o * acc
        take = d < best_d
        best_off = jnp.where(take, o, best_off)
        best_d = jnp.where(take, d, best_d)
    return best_off, best_d


def _offset_bits_jnp(off, edge: bool):
    a = jnp.abs(off).astype(jnp.float32)
    bits = jnp.minimum(a + 1, 7)
    if not edge:
        bits = bits + (a > 0)
    return bits


def _choose_luma_jnp(e_cnt, e_sum, b_cnt, b_sum, lam):
    """jnp port of choose_sao_params (one component)."""
    _, _, cy, cx = e_cnt.shape
    best_type = jnp.zeros((cy, cx), jnp.int32)
    best_eo = jnp.zeros((cy, cx), jnp.int32)
    best_bp = jnp.zeros((cy, cx), jnp.int32)
    best_off = jnp.zeros((cy, cx, 4), jnp.int32)
    best_cost = jnp.full((cy, cx), 1.0, jnp.float32) * lam

    for cls in range(4):
        offs = []
        dd = jnp.zeros((cy, cx), jnp.int32)
        bits = jnp.full((cy, cx), 4.0, jnp.float32)
        for k, sign in zip(range(1, 5), (1, 1, -1, -1)):
            o, d = _best_offset_jnp(e_cnt[cls, k], e_sum[cls, k], sign)
            offs.append(o)
            dd = dd + d
            bits = bits + _offset_bits_jnp(o, True)
        offs = jnp.stack(offs, axis=-1)
        cost = dd.astype(jnp.float32) + lam * bits
        take = cost < best_cost
        best_cost = jnp.where(take, cost, best_cost)
        best_type = jnp.where(take, 2, best_type)
        best_eo = jnp.where(take, cls, best_eo)
        best_off = jnp.where(take[..., None], offs, best_off)

    boffs, bdd = [], []
    for k in range(32):
        o, d = _best_offset_jnp(b_cnt[k], b_sum[k], 0)
        boffs.append(o)
        bdd.append(d)
    boffs = jnp.stack(boffs)          # (32, cy, cx)
    bdd = jnp.stack(bdd)
    for bp in range(32):
        idx = [(bp + i) & 31 for i in range(4)]
        dd = sum(bdd[i] for i in idx)
        obits = sum(_offset_bits_jnp(boffs[i], False) for i in idx)
        cost = dd.astype(jnp.float32) + lam * (2.0 + 5.0 + obits)
        take = cost < best_cost
        woff = jnp.stack([boffs[i] for i in idx], axis=-1)
        best_cost = jnp.where(take, cost, best_cost)
        best_type = jnp.where(take, 1, best_type)
        best_bp = jnp.where(take, bp, best_bp)
        best_off = jnp.where(take[..., None], woff, best_off)
    return dict(type=best_type, eo_class=best_eo, band_pos=best_bp,
                offsets=best_off, cost=best_cost)


def _choose_chroma_jnp(scb, scr, lam):
    """jnp port of _choose_chroma: shared type/eo, separate offsets."""
    ecb, esb, bcb, bsb = scb
    ecr, esr, bcr, bsr = scr
    _, _, cy, cx = ecb.shape
    b_type = jnp.zeros((cy, cx), jnp.int32)
    b_eo = jnp.zeros((cy, cx), jnp.int32)
    b_bpb = jnp.zeros((cy, cx), jnp.int32)
    b_bpr = jnp.zeros((cy, cx), jnp.int32)
    b_ob = jnp.zeros((cy, cx, 4), jnp.int32)
    b_or = jnp.zeros((cy, cx, 4), jnp.int32)
    b_cost = jnp.full((cy, cx), 1.0, jnp.float32) * lam
    for cls in range(4):
        ob_l, or_l = [], []
        dd = jnp.zeros((cy, cx), jnp.int32)
        bits = jnp.full((cy, cx), 4.0, jnp.float32)
        for k, sign in zip(range(1, 5), (1, 1, -1, -1)):
            ob, db = _best_offset_jnp(ecb[cls, k], esb[cls, k], sign)
            orr, dr = _best_offset_jnp(ecr[cls, k], esr[cls, k], sign)
            ob_l.append(ob)
            or_l.append(orr)
            dd = dd + db + dr
            bits = (bits + _offset_bits_jnp(ob, True)
                    + _offset_bits_jnp(orr, True))
        cost = dd.astype(jnp.float32) + lam * bits
        take = cost < b_cost
        b_cost = jnp.where(take, cost, b_cost)
        b_type = jnp.where(take, 2, b_type)
        b_eo = jnp.where(take, cls, b_eo)
        b_ob = jnp.where(take[..., None], jnp.stack(ob_l, -1), b_ob)
        b_or = jnp.where(take[..., None], jnp.stack(or_l, -1), b_or)

    def band_best(bc, bs):
        boffs, bdd = [], []
        for k in range(32):
            o, d = _best_offset_jnp(bc[k], bs[k], 0)
            boffs.append(o)
            bdd.append(d)
        boffs = jnp.stack(boffs)
        bdd = jnp.stack(bdd)
        bcost = jnp.full((cy, cx), jnp.inf, jnp.float32)
        bbp = jnp.zeros((cy, cx), jnp.int32)
        boff = jnp.zeros((cy, cx, 4), jnp.int32)
        for bp in range(32):
            idx = [(bp + i) & 31 for i in range(4)]
            dd = sum(bdd[i] for i in idx)
            bits = 5.0 + sum(_offset_bits_jnp(boffs[i], False)
                             for i in idx)
            cost = dd.astype(jnp.float32) + lam * bits
            take = cost < bcost
            bcost = jnp.where(take, cost, bcost)
            bbp = jnp.where(take, bp, bbp)
            boff = jnp.where(take[..., None],
                             jnp.stack([boffs[i] for i in idx], -1),
                             boff)
        return bcost, bbp, boff

    cb_cost, cb_bp, cb_off = band_best(bcb, bsb)
    cr_cost, cr_bp, cr_off = band_best(bcr, bsr)
    cost = cb_cost + cr_cost + lam * 2.0
    take = cost < b_cost
    b_cost = jnp.where(take, cost, b_cost)
    b_type = jnp.where(take, 1, b_type)
    b_bpb = jnp.where(take, cb_bp, b_bpb)
    b_bpr = jnp.where(take, cr_bp, b_bpr)
    b_ob = jnp.where(take[..., None], cb_off, b_ob)
    b_or = jnp.where(take[..., None], cr_off, b_or)
    return dict(type=b_type, eo_class=b_eo, bp_cb=b_bpb, bp_cr=b_bpr,
                off_cb=b_ob, off_cr=b_or, cost=b_cost)


def sao_decide_frame_device(stats_y, stats_c, lam):
    """Device greedy-raster SAO decision: vectorized own-params choice
    + an anti-diagonal wavefront for the left/up merge RD (a cell's
    merge candidates are its neighbors' RESOLVED params, which sit on
    the previous diagonal).  Mirrors sao_decide_frame (host) semantics
    without tiles.  Returns FrameData-style int32 arrays."""
    import jax

    e_cnt, e_sum, b_cnt, b_sum = stats_y
    _, _, cy, cx = e_cnt.shape
    luma = _choose_luma_jnp(e_cnt, e_sum, b_cnt, b_sum, lam)
    chroma = stats_c is not None
    n_t = jnp.zeros((cy, cx, 2), jnp.int32)
    n_eo = jnp.zeros((cy, cx, 2), jnp.int32)
    n_bp = jnp.zeros((cy, cx, 3), jnp.int32)
    n_off = jnp.zeros((cy, cx, 3, 4), jnp.int32)
    n_t = n_t.at[:, :, 0].set(luma["type"])
    n_eo = n_eo.at[:, :, 0].set(luma["eo_class"])
    n_bp = n_bp.at[:, :, 0].set(luma["band_pos"])
    n_off = n_off.at[:, :, 0].set(luma["offsets"])
    own_cost = luma["cost"]
    if chroma:
        scb, scr = stats_c
        cpar = _choose_chroma_jnp(scb, scr, lam)
        n_t = n_t.at[:, :, 1].set(cpar["type"])
        n_eo = n_eo.at[:, :, 1].set(cpar["eo_class"])
        n_bp = n_bp.at[:, :, 1].set(cpar["bp_cb"])
        n_bp = n_bp.at[:, :, 2].set(cpar["bp_cr"])
        n_off = n_off.at[:, :, 1].set(cpar["off_cb"])
        n_off = n_off.at[:, :, 2].set(cpar["off_cr"])
        own_cost = own_cost + cpar["cost"]

    # Exact RD of applying arbitrary per-cell params, from the stats.
    ecT = jnp.transpose(e_cnt, (2, 3, 0, 1))     # (cy, cx, 4, 5)
    esT = jnp.transpose(e_sum, (2, 3, 0, 1))
    bcT = jnp.transpose(b_cnt, (1, 2, 0))        # (cy, cx, 32)
    bsT = jnp.transpose(b_sum, (1, 2, 0))
    if chroma:
        comps = [(0, ecT, esT, bcT, bsT),
                 (1, jnp.transpose(scb[0], (2, 3, 0, 1)),
                  jnp.transpose(scb[1], (2, 3, 0, 1)),
                  jnp.transpose(scb[2], (1, 2, 0)),
                  jnp.transpose(scb[3], (1, 2, 0))),
                 (2, jnp.transpose(scr[0], (2, 3, 0, 1)),
                  jnp.transpose(scr[1], (2, 3, 0, 1)),
                  jnp.transpose(scr[2], (1, 2, 0)),
                  jnp.transpose(scr[3], (1, 2, 0)))]
    else:
        comps = [(0, ecT, esT, bcT, bsT)]

    def cost_of(t2, eo2, bp2, off2):
        """(cy, cx) RD ddist of applying candidate params per cell."""
        c = jnp.zeros((cy, cx), jnp.float32)
        for (ci, ec, es, bc, bs) in comps:
            t = t2[:, :, 0 if ci == 0 else 1]
            cls = eo2[:, :, 0 if ci == 0 else 1]
            offs = off2[:, :, ci]                    # (cy, cx, 4)
            # Edge ddist for the candidate class.
            ec_c = jnp.take_along_axis(
                ec, cls[:, :, None, None], axis=2)[:, :, 0]  # (cy,cx,5)
            es_c = jnp.take_along_axis(
                es, cls[:, :, None, None], axis=2)[:, :, 0]
            dd_e = jnp.sum(ec_c[:, :, 1:] * offs * offs
                           - 2 * offs * es_c[:, :, 1:], axis=-1)
            # Band ddist for the candidate window.
            bp = bp2[:, :, ci]
            widx = (bp[:, :, None] + jnp.arange(4)[None, None]) & 31
            bc_c = jnp.take_along_axis(bc, widx, axis=2)
            bs_c = jnp.take_along_axis(bs, widx, axis=2)
            dd_b = jnp.sum(bc_c * offs * offs - 2 * offs * bs_c,
                           axis=-1)
            c = c + jnp.where(t == 2, dd_e,
                              jnp.where(t == 1, dd_b, 0)
                              ).astype(jnp.float32)
        return c

    yy = jnp.arange(cy)[:, None]
    xx = jnp.arange(cx)[None, :]
    left_ok = (xx > 0).astype(jnp.float32) * jnp.ones((cy, cx))
    up_ok = (yy > 0).astype(jnp.float32) * jnp.ones((cy, cx))

    def shift_right(a):   # cell reads its LEFT neighbor
        return jnp.roll(a, 1, axis=1)

    def shift_down(a):    # cell reads its UP neighbor
        return jnp.roll(a, 1, axis=0)

    def body(d, carry):
        r_t, r_eo, r_bp, r_off, merge = carry
        on_diag = (yy + xx) == d
        lt, leo, lbp, loff = (shift_right(r_t), shift_right(r_eo),
                              shift_right(r_bp), shift_right(r_off))
        ut, ueo, ubp, uoff = (shift_down(r_t), shift_down(r_eo),
                              shift_down(r_bp), shift_down(r_off))
        best = own_cost + lam * (left_ok + up_ok)
        choice = jnp.zeros((cy, cx), jnp.int32)
        cl = cost_of(lt, leo, lbp, loff) + lam * 1.0
        tl = (left_ok > 0) & (cl < best)
        best = jnp.where(tl, cl, best)
        choice = jnp.where(tl, 1, choice)
        cu = cost_of(ut, ueo, ubp, uoff) + lam * (left_ok + 1.0)
        tu = (up_ok > 0) & (cu < best)
        choice = jnp.where(tu, 2, choice)

        def pick(cur, lv, uv):
            ch = choice.reshape(choice.shape + (1,) * (cur.ndim - 2))
            od = on_diag.reshape(choice.shape + (1,) * (cur.ndim - 2))
            v = jnp.where(ch == 1, lv, jnp.where(ch == 2, uv, cur))
            return jnp.where(od, v, cur)

        return (pick(r_t, lt, ut), pick(r_eo, leo, ueo),
                pick(r_bp, lbp, ubp), pick(r_off, loff, uoff),
                jnp.where(on_diag, choice, merge))

    carry = (n_t, n_eo, n_bp, n_off, jnp.zeros((cy, cx), jnp.int32))
    r_t, r_eo, r_bp, r_off, merge = jax.lax.fori_loop(
        0, cy + cx - 1, body, carry)
    return dict(merge=merge, type=r_t, eo=r_eo, bp=r_bp, off=r_off)
