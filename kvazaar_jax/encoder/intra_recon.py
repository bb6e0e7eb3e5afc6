"""Exact wavefront reconstruction pass (device, lax.scan).

Given the chosen intra modes, reconstruct the frame exactly as a decoder
will.  State design is the key decision: the scan carry holds ONLY
the boundary state — bottom-row and right-column edge buffers,
(B, By, W) + (B, Bx, H) — read/written with dynamic slices.  Never a
full frame buffer: a scatter into a large carry copies the buffer every
scan step, and even a block-grid carry moves more per step than edge
buffers.  Reconstructed
blocks stream out through scan ys in compact raster-block order (no pad
slots → minimal device→host traffic).  Spec reference substitution
(8.4.4.2.2) collapses to a 5-region fill chain because neighbor
availability is whole-region for a uniform CU grid.

This replaces the reference's per-LCU recursive reconstruction
(kvz_intra_recon_cu, src/intra.c:652; quantize loop src/transform.c:424);
the edge buffers are the device form of its hor/ver boundary buffers
(src/encoderstate.h:170-186).

The conformance decoder (bitstream/decoder.py) deliberately does NOT use
this code — it reconstructs via independent per-sample gather maps, so
the e2e bit-exactness test cross-validates two implementations.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from kvazaar_jax.encoder.geometry import IntraFramePlan, PlaneMaps
from kvazaar_jax.ops.intra import predict_all_modes
from kvazaar_jax.ops.quant import dequantize, quantize
from kvazaar_jax.ops.transform import forward_transform, inverse_transform


def _blocks_by_step(plane: np.ndarray, maps: PlaneMaps, plan) -> np.ndarray:
    """Rearrange a (H, W) plane into (steps, slots, S, S) with zeros in
    pad slots (host-side, static) — a single gather through the plan's
    scatter indices (pads read the trailing zero element)."""
    s = maps.size
    flat_ext = np.concatenate([plane.reshape(-1),
                               np.zeros(1, plane.dtype)])
    return flat_ext[maps.scatter_idx].reshape(
        plan.n_steps, plan.n_slots, s, s)


def blocks_to_plane(blocks: np.ndarray, plan: IntraFramePlan,
                    size: int, width: int, height: int) -> np.ndarray:
    """(N_blocks, S, S) raster block order -> (H, W) plane.

    int8 inputs (the packed-transfer layout) take the native widening
    copy, which releases the GIL (the numpy gather + astype holds it on
    the finalize path)."""
    if blocks.dtype == np.int8:
        from kvazaar_jax.bitstream import native
        return native.assemble_plane_i8(
            blocks.reshape(-1, size, size), plan.blocks_x,
            plan.blocks_y, size, width, height)
    g = blocks.reshape(plan.blocks_y, plan.blocks_x, size, size)
    return np.ascontiguousarray(
        g.transpose(0, 2, 1, 3).reshape(height, width))


def step_schedule(plan: IntraFramePlan):
    """Static per-(step, slot) tensors: block coords, 5-region neighbor
    availability, pad-slot validity."""
    bos = plan.block_of_slot
    valid = bos >= 0
    bids = np.maximum(bos, 0)
    by = (bids // plan.blocks_x).astype(np.int32)
    bx = (bids % plan.blocks_x).astype(np.int32)
    avail = plan.avail.reshape(-1, 5)[bids.reshape(-1)].reshape(
        plan.n_steps, plan.n_slots, 5)
    avail = avail & valid[..., None]
    return (jnp.asarray(bx), jnp.asarray(by), jnp.asarray(avail),
            jnp.asarray(valid))


def build_refs_edges(hbuf, vbuf, bx, by, avail, s, bitdepth):
    """Reference vector (B, 4S+1) from the edge buffers.

    hbuf: (B, By, W) bottom rows per block-row; vbuf: (B, Bx, H) right
    cols per block-column (the device form of the reference's hor/ver
    boundary buffers, src/encoderstate.h:170-186).  avail: (5,) traced
    [L, A, AR, BL, AL]."""
    b = hbuf.shape[0]
    a_l, a_a, a_ar, a_bl, a_al = (avail[0], avail[1], avail[2],
                                  avail[3], avail[4])
    x0 = bx * s
    y0 = by * s
    w = hbuf.shape[2]
    h = vbuf.shape[2]
    # Separate reads per region: clamped starts only ever shift MASKED
    # (unavailable) regions, never available ones.
    byc = jnp.maximum(by - 1, 0)
    top = jax.lax.dynamic_slice(hbuf, (0, byc, x0),
                                (b, 1, s)).reshape(b, s)
    top_right = jax.lax.dynamic_slice(
        hbuf, (0, byc, jnp.minimum(x0 + s, w - s)),
        (b, 1, s)).reshape(b, s)
    corner = jax.lax.dynamic_slice(
        hbuf, (0, byc, jnp.maximum(x0 - 1, 0)), (b, 1, 1)).reshape(b, 1)
    bxc = jnp.maximum(bx - 1, 0)
    left = jax.lax.dynamic_slice(vbuf, (0, bxc, y0),
                                 (b, 1, s)).reshape(b, s)
    below_left = jax.lax.dynamic_slice(
        vbuf, (0, bxc, jnp.minimum(y0 + s, h - s)),
        (b, 1, s)).reshape(b, s)

    # Vector order: BL (bottom-up), L (bottom-up), corner, T, TR.
    regions = [(a_bl, below_left[:, ::-1]), (a_l, left[:, ::-1]),
               (a_al, corner), (a_a, top), (a_ar, top_right)]
    default = jnp.full((b, 1), 1 << (bitdepth - 1), hbuf.dtype)
    first = default
    for flag, reg in reversed(regions):
        first = jnp.where(flag, reg[:, :1], first)
    out = []
    carry = first
    for flag, reg in regions:
        filled = jnp.where(flag, reg,
                           jnp.broadcast_to(carry, reg.shape))
        out.append(filled)
        carry = filled[:, -1:]
    return jnp.concatenate(out, axis=-1)


def _predict_select(refs, modes, s, luma, bitdepth, fixups=True):
    """All-mode prediction then per-item mode select.  refs: (N, R),
    modes: (N,) → (N, S, S).  The all-modes einsum is one batched
    matmul; it replaces a per-item weight gather."""
    preds = predict_all_modes(refs, s, luma=luma, bitdepth=bitdepth,
                              fixups=fixups)
    sel = jnp.take_along_axis(
        preds, modes[:, None, None, None].astype(jnp.int32), axis=1)
    return sel[:, 0]


def _tu_roundtrip(orig, pred, s, qp, bitdepth, intra=True,
                  lossless=False, scan_sel=None, rdoq=False,
                  lam=0.0, scaling_tab=None, dst=False, tskip=False,
                  rdpcm_modes=None):
    """scaling_tab: (qc_intra, qc_inter, dqc_intra, dqc_inter) (N, N)
    per-position multiplier tables for this size/component/qp%6 when a
    scaling list is active (ops/scaling.py).  dst: DST-VII (4x4 intra
    luma TBs, 8.6.4.1).  tskip: evaluate transform_skip per TB against
    the transform and keep the cheaper (the reference's try-both path,
    quantize_tr_residual src/transform.c:281-404); returns a third
    element, the (N,) int32 skip decisions."""
    resid = orig.astype(jnp.int32) - pred
    if lossless:
        # transquant bypass (cu_transquant_bypass_flag): the residual
        # itself is the coded level array; reconstruction is exact.
        lv = resid
        if rdpcm_modes is not None:
            # Implicit RDPCM (reference rdpcm(),
            # src/transform.c:99-114): hor/ver intra TBs code the
            # residual as a DPCM along the prediction direction.
            # Reconstruction is unchanged (exactly invertible).
            dx = jnp.concatenate(
                [resid[..., :, :1],
                 resid[..., :, 1:] - resid[..., :, :-1]], axis=-1)
            dy_ = jnp.concatenate(
                [resid[..., :1, :],
                 resid[..., 1:, :] - resid[..., :-1, :]], axis=-2)
            m = rdpcm_modes[:, None, None]
            lv = jnp.where(m == 10, dx, jnp.where(m == 26, dy_, resid))
        return lv.astype(jnp.int16), orig.astype(jnp.int32), None

    def roundtrip(coeff, inverse):
        if rdoq:
            from kvazaar_jax.ops.quant import quantize_rdoq
            qc_r = dqc_r = None
            if scaling_tab is not None:
                qc_r = (jnp.asarray(scaling_tab[0]),
                        jnp.asarray(scaling_tab[1]))
                dqc_r = (jnp.asarray(scaling_tab[2]),
                         jnp.asarray(scaling_tab[3]))
            levels = quantize_rdoq(coeff, qp, s, bitdepth, intra=intra,
                                   lam=lam, qc=qc_r, dqc=dqc_r)
        else:
            qc = None if scaling_tab is None else                 (jnp.asarray(scaling_tab[0]),
                 jnp.asarray(scaling_tab[1]))
            levels = quantize(coeff, qp, s, bitdepth, intra=intra,
                              qc=qc)
        if scan_sel is not None:
            from kvazaar_jax.ops.quant import sign_hide
            levels = sign_hide(levels, scan_sel)
        dqc = None if scaling_tab is None else             (jnp.asarray(scaling_tab[2]), jnp.asarray(scaling_tab[3]))
        dq = dequantize(levels, qp, s, bitdepth, dqc=dqc, intra=intra)
        rec = jnp.clip(pred + inverse(dq), 0, (1 << bitdepth) - 1)
        return levels, rec

    levels, rec = roundtrip(
        forward_transform(resid, s, bitdepth, dst=dst),
        lambda dq: inverse_transform(dq, s, bitdepth, dst=dst))
    if not tskip:
        return levels.astype(jnp.int16), rec, None

    # Transform-skip branch (8.6.4.2): coeff = resid << (15 - bd -
    # log2N); inverse r = (dq << 7 + rnd) >> (20 - bd).
    sh_f = 15 - bitdepth - (s.bit_length() - 1)
    sh_i = 20 - bitdepth
    lv_s, rec_s = roundtrip(
        resid << sh_f,
        lambda dq: ((dq << 7) + (1 << (sh_i - 1))) >> sh_i)

    def cost(lv, rc):
        d = (rc - orig.astype(jnp.int32)).astype(jnp.float32)
        ssd = jnp.sum(d * d, axis=(-2, -1))
        a = jnp.abs(lv).astype(jnp.float32)
        bits = jnp.sum(jnp.where(a > 0, 2.0 + 2.0 * jnp.log2(a + 1.0),
                                 0.0), axis=(-2, -1)) + 1.0
        return ssd + lam * bits

    sel = cost(lv_s, rec_s) < cost(levels, rec)
    levels = jnp.where(sel[:, None, None], lv_s, levels)
    rec = jnp.where(sel[:, None, None], rec_s, rec)
    return levels.astype(jnp.int16), rec, sel.astype(jnp.int32)


def _scan_sel(modes, s, luma, is_inter=None):
    """scanIdx per block (7.4.9.11): mode-dependent only for 4x4 and
    8x8-luma intra TBs; inter and large TBs use diagonal."""
    if (luma and s > 8) or (not luma and s > 4):
        return jnp.zeros_like(modes)
    sel = jnp.where((modes >= 6) & (modes <= 14), 2,
                    jnp.where((modes >= 22) & (modes <= 30), 1, 0))
    if is_inter is not None:
        sel = jnp.where(is_inter, 0, sel)
    return sel.astype(jnp.int32)


def _plane_pass(hbuf, vbuf, bxs, bys, avail, valid, origs, modes, s, qp,
                bitdepth, luma, is_inter=None, mc_pred=None,
                lossless=False, signhide=False, rdoq=False, lam=0.0,
                scaling_tab=None, tskip=False, qp_step=None,
                rdpcm=False):
    """One wavefront step for one plane over all slots.

    hbuf: (B, By, W); vbuf: (B, Bx, H) — edge state only (the carry is
    ~100x smaller than a full frame; per-step traffic is what the scan
    pays for).  origs: (slots, B, S, S); modes: (slots, B).
    P frames: is_inter (slots, B) bool, mc_pred (slots, B, S, S) —
    inter blocks take the motion-compensated prediction (computed
    batched outside the scan; it has no wavefront dependency) and the
    inter quantizer rounding.
    Returns (hbuf, vbuf, levels, rec) with levels/rec (slots, B, S, S)."""
    b = hbuf.shape[0]
    n_slots = origs.shape[0]
    refs = []
    for k in range(n_slots):
        refs.append(build_refs_edges(hbuf, vbuf, bxs[k], bys[k],
                                     avail[k], s, bitdepth))
    refs = jnp.stack(refs)                       # (slots, B, R)
    flat_refs = refs.reshape(n_slots * b, -1)
    flat_modes = modes.reshape(n_slots * b)
    pred = _predict_select(flat_refs, flat_modes, s, luma, bitdepth,
                           fixups=not (rdpcm and luma))
    intra_flag = True
    flat_inter = None
    if is_inter is not None:
        flat_inter = is_inter.reshape(n_slots * b)
        pred = jnp.where(flat_inter[:, None, None],
                         mc_pred.reshape(n_slots * b, s, s), pred)
        intra_flag = ~flat_inter
    scan_sel = (_scan_sel(flat_modes, s, luma, flat_inter)
                if signhide else None)
    # 4x4 luma TBs only arise from intra NxN coding here, which is an
    # all-intra path — DST-VII applies uniformly (8.6.4.1).
    dst = luma and s == 4 and is_inter is None
    qp_eff = qp if qp_step is None else \
        qp_step.reshape(n_slots * b).astype(jnp.int32)
    rdpcm_modes = None
    if rdpcm:
        rdpcm_modes = flat_modes
        if flat_inter is not None:
            rdpcm_modes = jnp.where(flat_inter, -1, rdpcm_modes)
    levels, rec, ts = _tu_roundtrip(
        origs.reshape(n_slots * b, s, s), pred, s, qp_eff, bitdepth,
        intra_flag, lossless, scan_sel, rdoq, lam, scaling_tab,
        dst=dst, tskip=tskip and s == 4, rdpcm_modes=rdpcm_modes)
    ts = (jnp.zeros((n_slots, b), jnp.int32) if ts is None
          else ts.reshape(n_slots, b))
    rec = rec.reshape(n_slots, b, s, s)
    for k in range(n_slots):
        x0 = bxs[k] * s
        y0 = bys[k] * s
        brow = rec[k, :, -1:, :].astype(hbuf.dtype)      # (B, 1, S)
        cur_h = jax.lax.dynamic_slice(hbuf, (0, bys[k], x0), (b, 1, s))
        hbuf = jax.lax.dynamic_update_slice(
            hbuf, jnp.where(valid[k], brow, cur_h), (0, bys[k], x0))
        rcol = jnp.swapaxes(rec[k, :, :, -1:], 1, 2).astype(vbuf.dtype)
        cur_v = jax.lax.dynamic_slice(vbuf, (0, bxs[k], y0), (b, 1, s))
        vbuf = jax.lax.dynamic_update_slice(
            vbuf, jnp.where(valid[k], rcol, cur_v), (0, bxs[k], y0))
    return hbuf, vbuf, levels.reshape(n_slots, b, s, s), rec, ts


from kvazaar_jax.constants import CHROMA_QP_TAB as _CHROMA_QP_TAB


def reconstruct_frames(ys, cbs, crs, modes, plan: IntraFramePlan,
                       qp: int, qp_c: int, bitdepth: int = 8,
                       is_inter=None, mc_y=None, mc_cb=None, mc_cr=None,
                       lossless=False, signhide=False, rdoq=False,
                       lam=0.0, scaling=None, tskip=False,
                       qp_map=None, cmodes=None, rdpcm=False):
    """Batched wavefront over all planes.

    ys: (B, H, W) int32; cbs/crs: (B, H/2, W/2) or None;
    modes: (B, By, Bx) int32.
    P frames additionally pass is_inter (B, By, Bx) bool and full-frame
    MC prediction planes mc_y (B, H, W) (+ chroma).
    cmodes: optional (B, By, Bx) int32 explicit chroma prediction modes
    (--rd 3 chroma-mode RDO); None = DM (chroma shares the luma mode).
    Returns (recon_y, levels_y, recon_cb, levels_cb, recon_cr,
    levels_cr); recon as (B, H, W) uint8/16, levels as
    (B, steps, slots, S, S) int16.
    """
    s = plan.cu_size
    chroma = cbs is not None
    inter = is_inter is not None
    b = ys.shape[0]
    bxs, bys, avail, valid = step_schedule(plan)
    slot_ids = jnp.asarray(np.maximum(plan.block_of_slot, 0))

    def to_steps(planes, size):
        by_, bx_ = plan.blocks_y, plan.blocks_x
        blocks = planes.reshape(b, by_, size, bx_, size)
        blocks = blocks.transpose(1, 3, 0, 2, 4).reshape(
            by_ * bx_, b, size, size)
        return blocks[slot_ids]          # (steps, slots, B, S, S)

    oy = to_steps(ys.astype(jnp.int32), s)
    modes_steps = modes.reshape(b, -1).T[slot_ids]   # (steps, slots, B)
    cmodes_steps = (modes_steps if cmodes is None
                    else cmodes.reshape(b, -1).T[slot_ids])
    has_qp = qp_map is not None
    qp_steps = qpc_steps = None
    if has_qp:
        # Per-block QP (LCU rate control / ROI): (B, By, Bx) traced ->
        # per-step arrays like modes; chroma via Table 8-10.
        qpi = jnp.clip(qp_map.astype(jnp.int32), 0, 51)
        qp_steps = qpi.reshape(b, -1).T[slot_ids]
        qpc_steps = jnp.take(jnp.asarray(_CHROMA_QP_TAB),
                             qpi).reshape(b, -1).T[slot_ids]
    if chroma:
        s2 = plan.chroma.size
        ocb = to_steps(cbs.astype(jnp.int32), s2)
        ocr = to_steps(crs.astype(jnp.int32), s2)

    tab_y = tab_cb = tab_cr = None
    if scaling is not None:
        from kvazaar_jax.ops.scaling import ScalingLists  # noqa: F401
        r_, rc_ = qp % 6, qp_c % 6

        def tabs(size, comp, rem):
            return (scaling.qc(size, True, comp)[rem],
                    scaling.qc(size, False, comp)[rem],
                    scaling.dqc(size, True, comp)[rem],
                    scaling.dqc(size, False, comp)[rem])

        tab_y = tabs(s, 0, r_)
        if chroma:
            tab_cb = tabs(plan.chroma.size, 1, rc_)
            tab_cr = tabs(plan.chroma.size, 2, rc_)

    if inter:
        ii = is_inter.reshape(b, -1).T[slot_ids]     # (steps, slots, B)
        my = to_steps(mc_y.astype(jnp.int32), s)
        if chroma:
            mcb = to_steps(mc_cb.astype(jnp.int32), s2)
            mcr = to_steps(mc_cr.astype(jnp.int32), s2)

    # Edge-buffer carries: (B, By, W) bottom rows + (B, Bx, H) right
    # columns per plane (see _plane_pass).
    hb_y0 = jnp.zeros((b, plan.blocks_y, plan.width), jnp.int32)
    vb_y0 = jnp.zeros((b, plan.blocks_x, plan.height), jnp.int32)
    if chroma:
        hb_c0 = jnp.zeros((b, plan.blocks_y, plan.width // 2), jnp.int32)
        vb_c0 = jnp.zeros((b, plan.blocks_x, plan.height // 2),
                          jnp.int32)

    def step_fn(carry, xs):
        qp_t = qpc_t = None
        if has_qp:
            xs, qp_t, qpc_t = xs[:-2], xs[-2], xs[-1]
        if chroma:
            if inter:
                (hy, vy, hcb, vcb, hcr, vcr) = carry
                (bx_t, by_t, av_t, va_t, o_y, o_cb, o_cr, m, cm, ii_t,
                 my_t, mcb_t, mcr_t) = xs
            else:
                (hy, vy, hcb, vcb, hcr, vcr) = carry
                bx_t, by_t, av_t, va_t, o_y, o_cb, o_cr, m, cm = xs
                ii_t = my_t = mcb_t = mcr_t = None
            hy, vy, lv_y, r_y, ts_y = _plane_pass(
                hy, vy, bx_t, by_t, av_t, va_t, o_y, m, s, qp,
                bitdepth, True, ii_t, my_t, lossless, signhide, rdoq,
                lam, tab_y, tskip, qp_step=qp_t, rdpcm=rdpcm)
            hcb, vcb, lv_cb, r_cb, _ = _plane_pass(
                hcb, vcb, bx_t, by_t, av_t, va_t, o_cb, cm, s2, qp_c,
                bitdepth, False, ii_t, mcb_t, lossless, signhide,
                rdoq, lam, tab_cb, qp_step=qpc_t, rdpcm=rdpcm)
            hcr, vcr, lv_cr, r_cr, _ = _plane_pass(
                hcr, vcr, bx_t, by_t, av_t, va_t, o_cr, cm, s2, qp_c,
                bitdepth, False, ii_t, mcr_t, lossless, signhide,
                rdoq, lam, tab_cr, qp_step=qpc_t, rdpcm=rdpcm)
            return (hy, vy, hcb, vcb, hcr, vcr), \
                (lv_y, lv_cb, lv_cr, r_y, r_cb, r_cr, ts_y)
        if inter:
            (hy, vy) = carry
            bx_t, by_t, av_t, va_t, o_y, m, ii_t, my_t = xs
        else:
            (hy, vy) = carry
            bx_t, by_t, av_t, va_t, o_y, m = xs
            ii_t = my_t = None
        hy, vy, lv_y, r_y, ts_y = _plane_pass(
            hy, vy, bx_t, by_t, av_t, va_t, o_y, m, s, qp, bitdepth,
            True, ii_t, my_t, lossless, signhide, rdoq, lam, tab_y,
            tskip, qp_step=qp_t, rdpcm=rdpcm)
        return (hy, vy), (lv_y, r_y, ts_y)

    if chroma:
        xs = (bxs, bys, avail, valid, oy, ocb, ocr, modes_steps,
              cmodes_steps)
        if inter:
            xs = xs + (ii, my, mcb, mcr)
        carry0 = (hb_y0, vb_y0, hb_c0, vb_c0, hb_c0, vb_c0)
    else:
        xs = (bxs, bys, avail, valid, oy, modes_steps)
        if inter:
            xs = xs + (ii, my)
        carry0 = (hb_y0, vb_y0)
    if has_qp:
        xs = xs + (qp_steps, qpc_steps if qpc_steps is not None
                   else qp_steps)
    _, outs = jax.lax.scan(step_fn, carry0, xs)

    if chroma:
        lv_y, lv_cb, lv_cr, r_y, r_cb, r_cr, ts_y = outs
        out = _assemble_outputs(
            (lv_y, (lv_cb, lv_cr), r_y, (r_cb, r_cr)), plan, s, s2, b,
            bitdepth, chroma=True)
    else:
        lv_y, r_y, ts_y = outs
        out = _assemble_outputs((lv_y, None, r_y, None), plan, s, None,
                                b, bitdepth, chroma=False)
    if not tskip:
        return out
    return out + (_flags_to_blocks(ts_y, plan, b),)


def _flags_to_blocks(flags, plan, b):
    """(steps, slots, B) per-block flags -> (B, N_blocks) raster block
    order (the ordering of _assemble_outputs' lv_out)."""
    order = np.zeros(plan.blocks_y * plan.blocks_x, np.int64)
    bos = plan.block_of_slot
    for st in range(plan.n_steps):
        for sl in range(plan.n_slots):
            if bos[st, sl] >= 0:
                order[bos[st, sl]] = st * plan.n_slots + sl
    flat = flags.reshape(plan.n_steps * plan.n_slots,
                         flags.shape[2])[jnp.asarray(order)]
    return flat.T.astype(jnp.int32)          # (B, N_blocks)


def _assemble_outputs(outs, plan, s, s2, b, bitdepth, chroma):
    """(steps, slots, B, S, S) tensors -> frame planes + raster-block
    level tensors."""
    rdt = jnp.uint8 if bitdepth <= 8 else jnp.uint16
    # Static order: flat (step*slots + slot) index of each block id.
    order = np.zeros(plan.blocks_y * plan.blocks_x, np.int64)
    bos = plan.block_of_slot
    for st in range(plan.n_steps):
        for sl in range(plan.n_slots):
            if bos[st, sl] >= 0:
                order[bos[st, sl]] = st * plan.n_slots + sl
    order_j = jnp.asarray(order)

    def steps_to_plane(rblocks, size):
        flat = rblocks.reshape(plan.n_steps * plan.n_slots, b, size,
                               size)[order_j]
        grid = flat.reshape(plan.blocks_y, plan.blocks_x, b, size, size)
        return grid.transpose(2, 0, 3, 1, 4).reshape(
            b, plan.blocks_y * size, plan.blocks_x * size).astype(rdt)

    def lv_out(lv, size):
        # (steps, slots, B, S, S) -> (B, N_blocks, S, S) in raster block
        # order: drops pad slots (1.9x less device->host traffic) and
        # makes host reassembly a plain reshape.
        flat = lv.reshape(plan.n_steps * plan.n_slots, b, size,
                          size)[order_j].astype(jnp.int16)
        return flat.transpose(1, 0, 2, 3)

    lv_y, lvc, r_y, rc = outs
    if chroma:
        return (steps_to_plane(r_y, s), lv_out(lv_y, s),
                steps_to_plane(rc[0], s2), lv_out(lvc[0], s2),
                steps_to_plane(rc[1], s2), lv_out(lvc[1], s2))
    return (steps_to_plane(r_y, s), lv_out(lv_y, s), None, None, None,
            None)


def reconstruct_chroma_frames(cbs, crs, dm_modes, plan: IntraFramePlan,
                              qp_c: int, bitdepth: int = 8,
                              lossless=False, signhide=False,
                              rdoq=False, lam=0.0, scaling=None):
    """Chroma-only wavefront pass over a cu=8-granularity plan.

    Serves the intra-4x4 (PART_NxN) operating point: luma reconstructs
    on its own 4x4-granularity plan while each 8x8 CU keeps one 4x4
    chroma TB predicted with the DM mode of its first PU (8.4.3;
    reference TU-tree recursion kvz_intra_recon_cu, src/intra.c:652).
    cbs/crs: (B, H/2, W/2); dm_modes: (B, By8, Bx8) int32.
    Returns (rec_cb, lv_cb, rec_cr, lv_cr) — levels in raster block
    order like reconstruct_frames."""
    s2 = plan.chroma.size
    b = cbs.shape[0]
    bxs, bys, avail, valid = step_schedule(plan)
    slot_ids = jnp.asarray(np.maximum(plan.block_of_slot, 0))

    def to_steps(planes):
        by_, bx_ = plan.blocks_y, plan.blocks_x
        blocks = planes.reshape(b, by_, s2, bx_, s2)
        blocks = blocks.transpose(1, 3, 0, 2, 4).reshape(
            by_ * bx_, b, s2, s2)
        return blocks[slot_ids]

    # cb and cr share geometry/modes/QP: one scan over a 2B batch.
    oc = jnp.concatenate([to_steps(cbs.astype(jnp.int32)),
                          to_steps(crs.astype(jnp.int32))], axis=2)
    m2 = dm_modes.reshape(b, -1).T[slot_ids]
    m2 = jnp.concatenate([m2, m2], axis=2)

    tab_c = None
    if scaling is not None:
        r_ = qp_c % 6
        tab_c = (scaling.qc(s2, True, 1)[r_],
                 scaling.qc(s2, False, 1)[r_],
                 scaling.dqc(s2, True, 1)[r_],
                 scaling.dqc(s2, False, 1)[r_])

    hb0 = jnp.zeros((2 * b, plan.blocks_y, plan.width // 2), jnp.int32)
    vb0 = jnp.zeros((2 * b, plan.blocks_x, plan.height // 2), jnp.int32)

    def step_fn(carry, xs):
        hc, vc = carry
        bx_t, by_t, av_t, va_t, o_c, m = xs
        hc, vc, lv, rc, _ = _plane_pass(
            hc, vc, bx_t, by_t, av_t, va_t, o_c, m, s2, qp_c, bitdepth,
            False, None, None, lossless, signhide, rdoq, lam, tab_c)
        return (hc, vc), (lv, rc)

    _, (lv_c, r_c) = jax.lax.scan(
        step_fn, (hb0, vb0), (bxs, bys, avail, valid, oc, m2))

    outs_cb = (lv_c[:, :, :b], None, r_c[:, :, :b], None)
    outs_cr = (lv_c[:, :, b:], None, r_c[:, :, b:], None)
    rec_cb, lv_cb = _assemble_chroma(outs_cb, plan, s2, b, bitdepth)
    rec_cr, lv_cr = _assemble_chroma(outs_cr, plan, s2, b, bitdepth)
    return rec_cb, lv_cb, rec_cr, lv_cr


def _assemble_chroma(outs, plan, s2, b, bitdepth):
    rec, lv, _, _ = _assemble_outputs(
        (outs[0], None, outs[2], None), plan, s2, None, b, bitdepth,
        chroma=False)[:4]
    return rec, lv


def reconstruct_frame(y, cb, cr, modes, plan: IntraFramePlan, qp: int,
                      qp_c: int, bitdepth: int = 8, lossless=False,
                      signhide=False):
    """Single-frame wrapper over reconstruct_frames."""
    chroma = cb is not None
    out = reconstruct_frames(
        y[None], None if not chroma else cb[None],
        None if not chroma else cr[None], modes[None], plan, qp, qp_c,
        bitdepth, lossless=lossless, signhide=signhide)
    rec_y, lv_y, rec_cb, lv_cb, rec_cr, lv_cr = out
    if chroma:
        return (rec_y[0], lv_y[0], rec_cb[0], lv_cb[0], rec_cr[0],
                lv_cr[0])
    return rec_y[0], lv_y[0], None, None, None, None
