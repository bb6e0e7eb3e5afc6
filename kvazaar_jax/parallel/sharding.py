"""Within-frame multi-chip sharding: spatial row-band partitioning with
ICI halo exchange.

The reference scales within a frame via WPP rows and tiles under a
pthread job DAG (src/encoderstate.c:612-965); the boundary data a shard
needs from its neighbors is exactly the reference's hor/ver exchange
set (src/encoderstate.h:170-186).  The device form: `shard_map` over a
device mesh axis, with `jax.lax.ppermute` moving the boundary rows over
ICI — XLA collectives, not host staging (SURVEY.md §7 stage 8).

First shipped unit: the deblocking filter, whose horizontal-edge pass
reads 4 rows across every band boundary.  Each shard receives a one-
block-row halo from both neighbors, filters its extended band with
exact spec semantics, and keeps its interior — bit-identical to the
single-device filter at every mesh size (tests/test_multichip.py sweeps
1/2/4/8-way layouts like the reference's tests/test_owf_wpp_tiles.sh).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P


def _exchange_rows(band, axis: str, halo: int):
    """Send this shard's boundary rows to both neighbors; returns
    (from_above, from_below), zeros past the frame edges."""
    n = jax.lax.axis_size(axis)
    down = [(i, i + 1) for i in range(n - 1)]
    up = [(i + 1, i) for i in range(n - 1)]
    top = jax.lax.ppermute(band[-halo:], axis, down)
    bot = jax.lax.ppermute(band[:halo], axis, up)
    return top, bot


def deblock_plane_rows(plane, bs_v, bs_h, qp: int, edge_step: int,
                       bitdepth: int, chroma: bool, axis: str,
                       blk: int):
    """Deblock one plane whose ROWS are sharded over mesh axis `axis`
    (call inside shard_map; `plane`/`bs_*` are the local band and its
    slice of the frame-level block-grid BS maps)."""
    from kvazaar_jax.ops.deblock import deblock_plane
    halo = blk                       # one block row: >= filter reach
    hs, w = plane.shape
    idx = jax.lax.axis_index(axis)
    n = jax.lax.axis_size(axis)
    top, bot = _exchange_rows(plane, axis, halo)
    ext = jnp.concatenate([top, plane, bot], axis=0)

    bs_v = bs_v.astype(jnp.int32)
    bs_h = bs_h.astype(jnp.int32)
    tv, bv = _exchange_rows(bs_v, axis, 1)
    th, bh = _exchange_rows(bs_h, axis, 1)
    ext_v = jnp.concatenate([tv, bs_v, bv], axis=0)
    ext_h = jnp.concatenate([th, bs_h, bh], axis=0)

    # Disable edges on rows that do not exist in the frame (the zero
    # halos past the picture border); the frame's own row-0 horizontal
    # edge is already 0 in the caller's map.
    cells_local = hs // blk
    rows = jnp.arange(cells_local + 2) + idx * cells_local - 1
    frame_cells = n * cells_local
    in_frame = (rows >= 0) & (rows < frame_cells)
    ext_v = jnp.where(in_frame[:, None], ext_v, 0)
    ext_h = jnp.where(in_frame[:, None], ext_h, 0)

    out = deblock_plane(ext.astype(jnp.int32), qp, edge_step, bitdepth,
                        chroma=chroma, bs_v=ext_v, bs_h=ext_h, blk=blk)
    return out[halo:halo + hs]


def deblock_frame_sharded(rec_y, rec_cb, rec_cr, qp: int, cu_size: int,
                          mesh: Mesh, axis: str = "rows",
                          bitdepth: int = 8, bs_v=None, bs_h=None):
    """Frame deblocking sharded into CTU row bands over `mesh`.

    Full-frame planes in, full-frame filtered planes out; bit-identical
    to ops.deblock.deblock_frame at any mesh size."""
    from jax import shard_map
    n = mesh.shape[axis]
    h, w = rec_y.shape
    assert h % (n * cu_size) == 0, \
        "frame height must split into whole-block row bands"
    blk = cu_size
    if bs_v is None:
        by, bx = h // blk, w // blk
        bs_v = jnp.tile(jnp.arange(bx) > 0, (by, 1)) * 2
        bs_h = (jnp.arange(by)[:, None] > 0) \
            * jnp.ones((by, bx), jnp.int32) * 2
    bs_v = jnp.asarray(bs_v, jnp.int32)
    bs_h = jnp.asarray(bs_h, jnp.int32)
    # Frame borders are never filtered (8.7.2): force row/col 0 off so
    # shard-local processing needs no special cases.
    bs_h = bs_h.at[0, :].set(0)
    bs_v = bs_v.at[:, 0].set(0)

    spec = P(axis, None)

    def fy(y, v, hm):
        return deblock_plane_rows(y, v, hm, qp, cu_size, bitdepth,
                                  False, axis, blk)

    def fc(c, v, hm):
        return deblock_plane_rows(c, v, hm, qp, cu_size // 2, bitdepth,
                                  True, axis, blk // 2)

    y = shard_map(fy, mesh=mesh, in_specs=(spec, spec, spec),
                  out_specs=spec)(rec_y.astype(jnp.int32), bs_v, bs_h)
    cb = cr = None
    if rec_cb is not None:
        cb = shard_map(fc, mesh=mesh, in_specs=(spec, spec, spec),
                       out_specs=spec)(rec_cb.astype(jnp.int32), bs_v,
                                       bs_h)
        cr = shard_map(fc, mesh=mesh, in_specs=(spec, spec, spec),
                       out_specs=spec)(rec_cr.astype(jnp.int32), bs_v,
                                       bs_h)
    return y, cb, cr


def encode_frame_bands_sharded(y, cb, cr, qp: int, qp_c: int,
                               lambda_satd: float, mesh: Mesh,
                               cu: int, tiles_x: int = 1,
                               bitdepth: int = 8,
                               two_pass: bool = True,
                               signhide: bool = False,
                               rdoq: bool = False, lam: float = 0.0,
                               deblock: bool = True,
                               axis: str = "bands"):
    """Full multi-device all-intra frame encode: the frame's TILE-ROW
    bands are sharded over the mesh (tiles cut every prediction/entropy
    dependency, so search + wavefront recon are zero-communication per
    band), then the deblocking filter crosses band boundaries via the
    ppermute halo exchange (loop_filter_across_tiles on, 8.7.2).

    Returns (modes (By, Bx), lv_y (Nb, S, S) raster blocks, lv_cb,
    lv_cr, rec_y (H, W), rec_cb, rec_cr) — bit-identical to the
    single-device encode with a (tiles_x, n_devices) tile plan; the
    caller serializes per-tile substreams into one bitstream (the
    exchange set of the reference, src/encoderstate.h:170-186, plus
    its bitstream splice kvz_bitstream_move)."""
    from jax import shard_map

    from kvazaar_jax.encoder.geometry import make_intra_plan
    from kvazaar_jax.encoder.intra_recon import reconstruct_frames
    from kvazaar_jax.encoder.intra_search import search_frame_modes
    n = mesh.shape[axis]
    h, w = y.shape
    assert h % (n * 64) == 0, "bands must be whole CTU rows"
    chroma = cb is not None
    band_plan = make_intra_plan(w, h // n, cu, chroma,
                                tiles=(tiles_x, 1))

    def band(yb, cbb, crb):
        yb = yb.astype(jnp.int32)
        modes, _cost = search_frame_modes(yb, band_plan, lambda_satd,
                                          bitdepth, two_pass=two_pass)
        out = reconstruct_frames(
            yb[None],
            None if cbb is None else cbb.astype(jnp.int32)[None],
            None if crb is None else crb.astype(jnp.int32)[None],
            modes[None], band_plan, qp, qp_c, bitdepth,
            signhide=signhide, rdoq=rdoq, lam=lam)
        rec_y, lv_y, rec_cb, lv_cb, rec_cr, lv_cr = out
        if chroma:
            return (modes, lv_y[0], lv_cb[0], lv_cr[0], rec_y[0],
                    rec_cb[0], rec_cr[0])
        return modes, lv_y[0], rec_y[0]

    sy = P(axis, None)
    sb = P(axis, None, None)      # raster block tensors
    if chroma:
        outs = shard_map(band, mesh=mesh, in_specs=(sy, sy, sy),
                         out_specs=(sy, sb, sb, sb, sy, sy, sy),
                         check_vma=False)(y, cb, cr)
        modes, lv_y, lv_cb, lv_cr, rec_y, rec_cb, rec_cr = outs
    else:
        modes, lv_y, rec_y = shard_map(
            lambda yb: band(yb, None, None), mesh=mesh,
            in_specs=(sy,), out_specs=(sy, sb, sy),
            check_vma=False)(y)
        lv_cb = lv_cr = rec_cb = rec_cr = None
    if deblock:
        rec_y, rec_cb, rec_cr = deblock_frame_sharded(
            rec_y, rec_cb, rec_cr, qp, cu, mesh, axis=axis,
            bitdepth=bitdepth)
    rdt = jnp.uint8 if bitdepth <= 8 else jnp.uint16
    rec_y = rec_y.astype(rdt)
    if chroma:
        rec_cb = rec_cb.astype(rdt)
        rec_cr = rec_cr.astype(rdt)
    return modes, lv_y, lv_cb, lv_cr, rec_y, rec_cb, rec_cr


def p_search_mc_bands_sharded(cur, ref, mesh: Mesh, axis: str = "rows",
                              cu: int = 16, me_range: int = 8,
                              lambda_satd: float = 20.0,
                              bitdepth: int = 8):
    """P-frame motion search + luma MC with the frame sharded into CTU
    row bands and an ME-WINDOW halo exchange over ICI.

    The reference's inter frames exchange reconstruction rows reaching
    the neighbours' search windows (the hor/ver exchange set,
    src/encoderstate.h:170-186, wired by encoder_state_encode's job
    dependencies).  Device form: each band ppermutes `me_range + 8`
    reference rows to both neighbours (search reach + the 8-tap qpel
    window margin), searches +-me_range integer candidates locally,
    re-ranks with MV rate against a median predictor whose cross-band
    top row rides a second one-row ppermute, quarter-pel-refines on
    the extended band, and motion-compensates from it.  Frame-edge
    halo rows are clamp-replicated (the same padding gather_windows
    applies at picture borders), so the result is BIT-IDENTICAL at
    every mesh size — 1/2/4/8-way sharding must not change a single
    MV or MC pixel (tests/test_multichip.py sweeps this).

    cur/ref: (H, W) int32 full frames.  Returns (mv (By, Bx, 2) int32
    qpel, mc_y (H, W) int32)."""
    from jax import shard_map

    from kvazaar_jax.encoder.inter_search import (_int_refine_sads,
                                                  _median3,
                                                  _mv_bits_est,
                                                  _refine_offsets)
    from kvazaar_jax.ops.inter import (QPEL_OFFSETS, mc_luma,
                                       refine_qpel_dense)
    n = mesh.shape[axis]
    h, w = cur.shape
    s = cu
    assert h % (n * s) == 0, "bands must be whole block rows"
    halo = me_range + 8
    r = me_range

    def band(curb, refb):
        hb = curb.shape[0]
        by, bx = hb // s, w // s
        nblk = by * bx
        idx = jax.lax.axis_index(axis)
        nsh = jax.lax.axis_size(axis)
        top, bot = _exchange_rows(refb, axis, halo)
        # Picture-border semantics: missing halo rows clamp-replicate
        # the band's own edge row (what gather_windows' index clamping
        # produces on the unsharded frame).
        top = jnp.where(idx == 0,
                        jnp.broadcast_to(refb[:1], (halo, w)), top)
        bot = jnp.where(idx == nsh - 1,
                        jnp.broadcast_to(refb[-1:], (halo, w)), bot)
        ext = jnp.concatenate([top, refb, bot], axis=0)

        ys, xs = np.mgrid[0:by, 0:bx]
        x0s = jnp.asarray((xs * s).reshape(-1))
        y0s = jnp.asarray((ys * s).reshape(-1)) + halo
        cur_blocks = curb.reshape(by, s, bx, s).transpose(0, 2, 1, 3)
        cur_blocks = cur_blocks.reshape(nblk, s, s).astype(jnp.int32)

        # Integer full search +-r around zero on the extended band.
        zero = jnp.zeros((nblk, 2), jnp.int32)
        sads = _int_refine_sads(cur_blocks, ext, x0s, y0s, zero, r, s,
                                bitdepth)                  # (N, K)
        offs = jnp.asarray(_refine_offsets(r))             # (K, 2)
        i1 = jnp.argmin(sads, axis=1)
        mv1 = jnp.take_along_axis(
            offs[None].repeat(nblk, 0), i1[:, None, None],
            axis=1)[:, 0] * 4
        g1 = mv1.reshape(by, bx, 2)

        # Median predictor with the top row exchanged across bands
        # (left/top/topright — the band's row 0 reads the neighbour
        # above's last row, zeros at the picture border).
        prev_last = jax.lax.ppermute(
            g1[-1:], axis, [(i, i + 1) for i in range(nsh - 1)])
        prev_last = jnp.where(idx == 0, jnp.zeros_like(prev_last),
                              prev_last)
        gext = jnp.concatenate([prev_last, g1], axis=0)    # (by+1,..)
        zcol = jnp.zeros_like(g1[:, :1])
        left = jnp.concatenate([zcol, g1[:, :-1]], axis=1)
        topg = gext[:-1]
        topright = jnp.concatenate(
            [topg[:, 1:], jnp.zeros_like(topg[:, :1])], axis=1)
        pred = _median3(left, topg, topright).reshape(nblk, 1, 2)

        # Rate-aware re-rank over the same candidate set.
        q = offs[None] * 4
        bits = (_mv_bits_est(q[..., 0] - pred[..., 0])
                + _mv_bits_est(q[..., 1] - pred[..., 1]))
        cost = sads.astype(jnp.float32) + lambda_satd * bits
        i2 = jnp.argmin(cost, axis=1)
        mv_int = jnp.take_along_axis(
            jnp.broadcast_to(q, (nblk, q.shape[1], 2)),
            i2[:, None, None], axis=1)[:, 0].astype(jnp.int32)

        # Dense quarter-pel refinement + MC on the extended band.
        satd49 = refine_qpel_dense(cur_blocks, ext, x0s, y0s, mv_int,
                                   s, bitdepth)
        cands = mv_int[:, None, :] + jnp.asarray(QPEL_OFFSETS)[None]
        pn = pred.reshape(nblk, 2)
        rate = _mv_bits_est(cands[..., 0] - pn[:, None, 0]) + \
            _mv_bits_est(cands[..., 1] - pn[:, None, 1])
        c49 = satd49.astype(jnp.float32) + lambda_satd * rate
        k = jnp.argmin(c49, axis=-1)
        mv_q = jnp.take_along_axis(cands, k[:, None, None],
                                   axis=1)[:, 0]
        mc = mc_luma(ext, x0s, y0s, mv_q, s, bitdepth)
        mc = mc.reshape(by, bx, s, s).transpose(0, 2, 1, 3)
        return mv_q.reshape(by, bx, 2), mc.reshape(hb, w)

    spec = P(axis, None)
    return shard_map(band, mesh=mesh, in_specs=(spec, spec),
                     out_specs=(P(axis, None, None), spec),
                     check_vma=False)(cur.astype(jnp.int32),
                                      ref.astype(jnp.int32))


def intra_encode_tiles_sharded(y, qp: int, lambda_satd: float,
                               mesh: Mesh, axis: str = "rows",
                               bitdepth: int = 8):
    """All-intra luma search + wavefront reconstruction with the frame
    sharded into TILE-ROW bands over the mesh.

    Tile boundaries cut every prediction/entropy dependency (6.4.1), so
    with tiles = (1, n_devices) each device encodes its band with NO
    communication — the tile-thread parallelism of the reference
    (src/encoderstate.c:860-965) becomes pure spatial sharding; only
    the deblocking filter afterwards crosses bands
    (loop_filter_across_tiles) via the ppermute halo exchange.

    Returns (modes (By, Bx), recon_y (H, W)) — bit-identical to the
    single-device encode with a (1, n) tile plan, any mesh size."""
    from jax import shard_map

    from kvazaar_jax.encoder.geometry import make_intra_plan
    from kvazaar_jax.encoder.intra_recon import reconstruct_frames
    from kvazaar_jax.encoder.intra_search import search_frame_modes
    n = mesh.shape[axis]
    h, w = y.shape
    assert h % (n * 64) == 0, "bands must be whole CTU rows"
    band_plan = make_intra_plan(w, h // n, 16, chroma=False)

    def band(yb):
        modes, _cost = search_frame_modes(
            yb.astype(jnp.int32), band_plan, lambda_satd, bitdepth,
            two_pass=False)
        rec = reconstruct_frames(yb.astype(jnp.int32)[None], None,
                                 None, modes[None], band_plan, qp, qp,
                                 bitdepth)
        return modes, rec[0][0]

    spec = P(axis, None)
    # check_vma off: the scan's zero-initialized edge carries are
    # unvarying constants; the body makes them device-varying.
    return shard_map(band, mesh=mesh, in_specs=(spec,),
                     out_specs=(spec, spec), check_vma=False)(y)
