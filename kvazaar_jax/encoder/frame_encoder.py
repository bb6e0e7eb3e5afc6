"""All-intra frame encoder: device search + wavefront recon + host CABAC.

Orchestration analogue of the reference's kvz_encode_one_frame
(src/encoderstate.c:1287) for I-frames: device programs produce modes,
levels, and reconstruction; the host serializes headers + slice data and
assembles Annex-B output.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp

import numpy as np

from kvazaar_jax.bitstream.bits import BitWriter, nal_unit
from kvazaar_jax.bitstream.cabac import CabacEncoder
from kvazaar_jax.bitstream.contexts import Contexts
from kvazaar_jax.bitstream.headers import (StreamParams,
                                           compute_level_idc, write_pps,
                                           write_slice_header, write_sps,
                                           write_vps)
from kvazaar_jax.bitstream import native
from kvazaar_jax.bitstream.syntax import FrameData, SliceDataEncoder

from kvazaar_jax.config import Config
from kvazaar_jax.constants import (NAL_IDR_W_RADL, NAL_TRAIL_R, SLICE_I, SLICE_P)
from kvazaar_jax.encoder.geometry import make_intra_plan
from kvazaar_jax.profiler import phase
from kvazaar_jax.ops.deblock import deblock_frame
from kvazaar_jax.encoder.inter_cands import (amvp_candidates,
                                             merge_candidates)
from kvazaar_jax.encoder.inter_search import mc_planes, search_inter_frame
from kvazaar_jax.encoder.intra_recon import (blocks_to_plane,
                                             reconstruct_frame,
                                             reconstruct_frames)
from kvazaar_jax.encoder.intra_search import search_frame_modes

def chroma_qp(qp: int) -> int:
    """H.265 Table 8-10 chroma QP (4:2:0) — backed by the single
    shared table in constants.py."""
    from kvazaar_jax.constants import CHROMA_QP_TAB
    return int(CHROMA_QP_TAB[min(max(qp, 0), 51)])


def qp_to_lambda(qp: int) -> float:
    """I-frame lambda, the reference's model (src/rate_control.c:176
    family): lambda = 0.57 * 2^((qp-12)/3)."""
    return 0.57 * 2.0 ** ((qp - 12) / 3.0)


def frame_lambda(qp: int, slice_type: int, gop_len: int = 0,
                 intra_period: int = 0, qp_factor=None,
                 keyframe: bool = False) -> float:
    """Per-picture lambda — the reference's qp_to_lamba
    (src/rate_control.c:176-207): 2^((qp-12)/3) scaled by the slice
    kind (I: 0.57 with a refs-count reduction; GOP pictures: the gop
    entry's qp_factor; plain P: 0.4624), then the non-keyframe boost
    clip(2, 4, (qp-12)/6)."""
    from kvazaar_jax.constants import SLICE_I
    period = gop_len if gop_len > 0 else intra_period
    lam = 2.0 ** ((qp - 12) / 3.0)
    if slice_type == SLICE_I:
        lam *= 0.57
        if period == 0:
            lam *= 0.5
        else:
            lam *= 1.0 - min(max(0.05 * (period - 1), 0.0), 0.5)
    elif gop_len > 0 and qp_factor is not None:
        lam *= qp_factor
    else:
        lam *= 0.4624
    if period > 0 and not keyframe:
        lam *= min(max((qp - 12) / 6.0, 2.0), 4.0)
    return lam


def _pack_device_tree(tree):
    """ONE-download packing of a pytree of device arrays: flatten into
    a single int32 vector (f32 leaves bitcast, bool/narrow leaves
    widened).  A var search returns ~20 per-size grids; one packed
    vector costs one transfer call instead of ~20 (xfer.py rule: one
    buffer per direction, written for a host link with a high per-call
    cost; its cost on PCIe is not measured)."""
    leaves, treedef = jax.tree.flatten(tree)
    spec = (treedef, [(tuple(x.shape), str(x.dtype)) for x in leaves])
    flat = []
    for x in leaves:
        if x.dtype == jnp.float32:
            x = jax.lax.bitcast_convert_type(x, jnp.int32)
        else:
            x = x.astype(jnp.int32)
        flat.append(x.reshape(-1))
    return jnp.concatenate(flat), spec


def _unpack_host_tree(buf, spec):
    """Host inverse of _pack_device_tree (one np.asarray download)."""
    treedef, shapes = spec
    buf = np.asarray(buf)
    out = []
    off = 0
    for shape, dt in shapes:
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        a = buf[off:off + n].reshape(shape)
        off += n
        if dt == "float32":
            a = a.view(np.float32)
        elif dt == "bool":
            a = a != 0
        elif dt != "int32":
            a = a.astype(np.dtype(dt))
        out.append(a)
    return jax.tree.unflatten(treedef, out)


class _LazySaoParams:
    """Deferred download of device-decided SAO params (see
    _sao_device_fn): the packed (B, Cy, Cx, 20) int32 buffer stays on
    device until the finalize worker indexes it, so the submit path
    never syncs on SAO."""

    def __init__(self, packed_dev):
        self._dev = packed_dev
        self._list = None

    def _resolve(self):
        if self._list is None:
            buf = np.asarray(self._dev)
            out = []
            for i in range(buf.shape[0]):
                b = buf[i]
                cy, cx = b.shape[:2]
                out.append(dict(
                    merge=b[..., 0].astype(np.uint8),
                    type=b[..., 1:3].astype(np.uint8),
                    eo=b[..., 3:5].astype(np.uint8),
                    bp=b[..., 5:8].astype(np.uint8),
                    off=b[..., 8:20].reshape(cy, cx, 3, 4)
                    .astype(np.int8)))
            self._list = out
            self._dev = None
        return self._list

    def __getitem__(self, i):
        return self._resolve()[i]

    def __len__(self):
        return (len(self._list) if self._list is not None
                else int(self._dev.shape[0]))


def pad_to_multiple(plane: np.ndarray, mult: int) -> np.ndarray:
    h, w = plane.shape
    h2 = -(-h // mult) * mult
    w2 = -(-w // mult) * mult
    if (h2, w2) == (h, w):
        return plane
    return np.pad(plane, ((0, h2 - h), (0, w2 - w)), mode="edge")


@dataclasses.dataclass
class FrameResult:
    nals: bytes              # slice NAL (headers are emitted separately)
    recon_y: np.ndarray      # coded-size reconstruction (None when the
                             # caller skipped the pixel transfer)
    recon_cb: np.ndarray | None
    recon_cr: np.ndarray | None
    frame_data: FrameData
    bits: int
    sse: tuple = None        # (sse_y, sse_cb, sse_cr) device-computed


class PFrameMixin:
    """P-frame device programs + host decision logic, mixed into the
    frame encoder (orchestration analogue of the reference's inter path
    under encoder_state_worker_encode_lcu)."""

    def _setup_p(self):
        self.lambda_me = self.lambda_satd
        self._device_search_b = jax.jit(self._search_b_impl)
        self._device_recon_b = jax.jit(self._recon_b_impl)
        self._p_fused_cache = {}   # R -> fused jit

    # ---- Fused single-dispatch P path.  The whole P frame (intra+inter
    # search, decision, MC, reconstruction, deblock) runs as ONE device
    # program whose host-relevant outputs come back in ONE packed uint8
    # buffer; reconstruction planes stay on device as the next frame's
    # reference (the OWF dependency chain, src/encoderstate.c:790,
    # becomes XLA async dispatch order). ----

    # ---- Per-CTU QP support (LCU rate control / ROI / AQ): QP enters
    # the device programs as DATA on the CTU grid; the quantizer and
    # deblock take per-block maps; the effective-QP chain (8.6.1 with
    # QG = CTU) is derived on device so deblocking matches what the
    # cu_qp_delta syntax will make a decoder reconstruct. ----

    def _qp_grid_idx(self):
        """Static block-grid -> CTU-grid index vectors."""
        ctus_y = -(-self.coded_h // 64)
        ctus_x = -(-self.coded_w // 64)
        by = np.minimum(np.arange(self.plan.blocks_y) * self.cu // 64,
                        ctus_y - 1)
        bx = np.minimum(np.arange(self.plan.blocks_x) * self.cu // 64,
                        ctus_x - 1)
        return ctus_y, ctus_x, by, bx

    def _qp_blk_of(self, qp_ctu):
        """(B, Cy, Cx) -> (B, By, Bx) block-grid gather."""
        _, _, by, bx = self._qp_grid_idx()
        return qp_ctu[:, jnp.asarray(by)][:, :, jnp.asarray(bx)]

    def _cbf_ctu_of(self, lv_y, lv_cb, lv_cr):
        """Per-CTU coded-coefficient flag from raster-order level
        tensors (B, N_blocks, S, S)."""
        b = lv_y.shape[0]
        cy, cx, byi, bxi = self._qp_grid_idx()
        shape = (b, self.plan.blocks_y, self.plan.blocks_x)
        cbf = jnp.any(lv_y != 0, axis=(-1, -2)).reshape(shape)
        for lv in (lv_cb, lv_cr):
            if lv is not None:
                cbf = cbf | jnp.any(lv != 0, axis=(-1, -2)).reshape(shape)
        return jnp.zeros((b, cy, cx), jnp.int32).at[
            :, byi[:, None], bxi[None, :]].max(
                cbf.astype(jnp.int32)).astype(bool)

    def _effective_qp_ctu(self, qp_ctu, cbf_ctu):
        """Intended (B, Cy, Cx) + cbf -> effective map: a CTU with no
        coded coefficients cannot signal cu_qp_delta, so it inherits
        the predictor chain (slice QP at the start of each slice, and
        of each CTU row under WPP — 8.6.1)."""
        b, cy, cx = qp_ctu.shape
        if self.params.wpp:
            q, c = qp_ctu, cbf_ctu
        else:
            q = qp_ctu.reshape(b, 1, cy * cx)
            c = cbf_ctu.reshape(b, 1, cy * cx)
        idx = jnp.broadcast_to(jnp.arange(q.shape[2])[None, None, :],
                               q.shape)
        last = jax.lax.cummax(jnp.where(c, idx, -1), axis=2)
        eff = jnp.where(last >= 0,
                        jnp.take_along_axis(q, jnp.maximum(last, 0),
                                            axis=2),
                        jnp.int32(self.cfg.qp))
        return eff.reshape(b, cy, cx)

    def _p_fused_fns(self, nref: int, with_qp: bool = False):
        key = (nref, with_qp)
        if key not in self._p_fused_cache:
            def fused(yp, cbp, crp, refs_y, refs_cb, refs_cr,
                      qp_ctu=None):
                yp = yp.astype(jnp.int32)
                if cbp is not None:
                    cbp = cbp.astype(jnp.int32)
                    crp = crp.astype(jnp.int32)
                modes, intra_cost = search_frame_modes(
                    yp, self.plan, self.lambda_satd, self.bitdepth,
                    two_pass=self.cfg.rd >= 1)
                part = mv_pu = mv_cells = None
                if self.cfg.smp:
                    from kvazaar_jax.encoder.inter_search import (
                        mc_planes_cells, search_inter_frame_smp)
                    part, mv_pu, inter_cost = search_inter_frame_smp(
                        yp, refs_y[0].astype(jnp.int32), self.plan,
                        self.lambda_me, self.cfg.me_range,
                        self.bitdepth, subpel=self.cfg.me_subpel,
                        amp=self.cfg.amp)
                    inter_map = inter_cost <= intra_cost * 1.02
                    part = jnp.where(inter_map, part, 0)
                    mv_pu = jnp.where(inter_map[..., None, None],
                                      mv_pu, 0).astype(jnp.int32)
                    # Cell-granularity motion field: PU1 region select.
                    cells = self.cu // 8
                    half = cells // 2
                    quarter = max(cells // 4, 1)

                    def up(a):
                        return jnp.repeat(jnp.repeat(a, cells, 0),
                                          cells, 1)

                    h8 = self.coded_h // 8
                    w8 = self.coded_w // 8
                    row_in = (jnp.arange(h8) % cells)[:, None]
                    col_in = (jnp.arange(w8) % cells)[None, :]
                    partc = up(part)
                    pu1 = (((partc == 1) & (row_in >= half))
                           | ((partc == 2) & (col_in >= half))
                           | ((partc == 4) & (row_in >= quarter))
                           | ((partc == 5)
                              & (row_in >= cells - quarter))
                           | ((partc == 6) & (col_in >= quarter))
                           | ((partc == 7)
                              & (col_in >= cells - quarter)))
                    mv_cells = jnp.where(
                        pu1[..., None], up(mv_pu[:, :, 1]),
                        up(mv_pu[:, :, 0]))
                    mv = mv_pu[:, :, 0]      # block-grid rep for SSE
                    ref_sel = jnp.zeros_like(part)
                    mc_y, mc_cb, mc_cr = mc_planes_cells(
                        refs_y[0].astype(jnp.int32),
                        None if refs_cb is None else
                        refs_cb[0].astype(jnp.int32),
                        None if refs_cr is None else
                        refs_cr[0].astype(jnp.int32),
                        mv_cells, self.bitdepth)
                else:
                    mvs, costs = [], []
                    for ri in range(nref):
                        mv_r, c_r = search_inter_frame(
                            yp, refs_y[ri].astype(jnp.int32),
                            self.plan, self.lambda_me,
                            self.cfg.me_range, self.bitdepth,
                            subpel=self.cfg.me_subpel)
                        rb = 0 if nref == 1 else \
                            (ri + 1 if ri < nref - 1 else ri)
                        mvs.append(mv_r)
                        costs.append(c_r + self.lambda_me * rb)
                    costs = jnp.stack(costs)
                    mvs = jnp.stack(mvs)
                    sel = jnp.argmin(costs, axis=0).astype(jnp.int32)
                    idx = jnp.broadcast_to(sel[None, ..., None],
                                           (1,) + sel.shape + (2,))
                    mv = jnp.take_along_axis(mvs, idx, axis=0)[0]
                    inter_cost = jnp.min(costs, axis=0)
                    # Mode decision on device (slight inter bias covers
                    # un-modeled merge savings, legacy 1.02).
                    inter_map = inter_cost <= intra_cost * 1.02
                    mv = jnp.where(inter_map[..., None], mv,
                                   0).astype(jnp.int32)
                    ref_sel = jnp.where(inter_map, sel, 0)
                    mc_y, mc_cb, mc_cr = mc_planes(
                        refs_y.astype(jnp.int32),
                        None if refs_cb is None else
                        refs_cb.astype(jnp.int32),
                        None if refs_cr is None else
                        refs_cr.astype(jnp.int32),
                        mv, self.plan, self.bitdepth,
                        ref_grid=ref_sel)
                qp_blk_b = None if qp_ctu is None else \
                    self._qp_blk_of(qp_ctu[None])
                rec_y, lv_y, rec_cb, lv_cb, rec_cr, lv_cr = \
                    reconstruct_frames(
                        yp[None], None if cbp is None else cbp[None],
                        None if crp is None else crp[None],
                        modes[None], self.plan, self.cfg.qp, self.qp_c,
                        self.bitdepth, is_inter=inter_map[None],
                        mc_y=mc_y[None],
                        mc_cb=None if mc_cb is None else mc_cb[None],
                        mc_cr=None if mc_cr is None else mc_cr[None],
                        lossless=self.cfg.lossless,
                        signhide=self.cfg.signhide,
                        rdoq=self.cfg.rdoq,
                        lam=qp_to_lambda(self.cfg.qp),
                        scaling=self.scaling, qp_map=qp_blk_b)
                dqp_blk = None
                if qp_ctu is not None:
                    eff = self._effective_qp_ctu(
                        qp_ctu[None],
                        self._cbf_ctu_of(lv_y, lv_cb, lv_cr))
                    dqp_blk = self._qp_blk_of(eff)[0]
                rec_y, lv_y = rec_y[0], lv_y[0]
                if cbp is not None:
                    rec_cb, lv_cb = rec_cb[0], lv_cb[0]
                    rec_cr, lv_cr = rec_cr[0], lv_cr[0]
                cbf_blk = jnp.any(lv_y != 0, axis=(-1, -2)).reshape(
                    self.plan.blocks_y, self.plan.blocks_x)
                if self.cfg.deblock and self.cfg.smp:
                    cells = self.cu // 8

                    def up(a):
                        return jnp.repeat(jnp.repeat(a, cells, 0),
                                          cells, 1)

                    bs_v8, bs_h8 = compute_bs_maps_smp(
                        up(inter_map), up(cbf_blk), mv_cells, self.cu,
                        part8=up(part))
                    dy, dcb, dcr = deblock_frame(
                        rec_y, rec_cb, rec_cr, self.cfg.qp, 8,
                        self.bitdepth, bs_v=bs_v8, bs_h=bs_h8,
                        qp_map=None if dqp_blk is None else
                        up(dqp_blk))
                elif self.cfg.deblock:
                    bs_v, bs_h = compute_bs_maps(inter_map, cbf_blk,
                                                 mv, ref=ref_sel)
                    dy, dcb, dcr = deblock_frame(
                        rec_y, rec_cb, rec_cr, self.cfg.qp, self.cu,
                        self.bitdepth, bs_v=bs_v, bs_h=bs_h,
                        qp_map=dqp_blk)
                if self.cfg.deblock:
                    rdt = jnp.uint8 if self.bitdepth <= 8 else \
                        jnp.uint16
                    rec_y = dy.astype(rdt)
                    if rec_cb is not None:
                        rec_cb = dcb.astype(rdt)
                        rec_cr = dcr.astype(rdt)

                def sse(a, b):
                    # Conformance window only (padding would inflate
                    # PSNR).
                    f = a.shape[0] * 2 // self.coded_h
                    hh = self.cfg.height * f // 2
                    ww = self.cfg.width * f // 2
                    d = (a[:hh, :ww].astype(jnp.float32)
                         - b[:hh, :ww].astype(jnp.float32))
                    return jnp.sum(d * d)

                sses = jnp.stack(
                    [sse(rec_y, yp),
                     sse(rec_cb, cbp) if cbp is not None else
                     jnp.float32(0),
                     sse(rec_cr, crp) if crp is not None else
                     jnp.float32(0)])
                packed = self._p_pack(lv_y, lv_cb, lv_cr, modes,
                                      inter_map, ref_sel, mv, sses,
                                      part=part, mv_pu=mv_pu)
                return (packed, (lv_y, lv_cb, lv_cr),
                        (rec_y, rec_cb, rec_cr))

            if with_qp:
                self._p_fused_cache[key] = jax.jit(fused)
            else:
                self._p_fused_cache[key] = jax.jit(
                    lambda yp, cbp, crp, ry, rcb, rcr: fused(
                        yp, cbp, crp, ry, rcb, rcr))
        return self._p_fused_cache[key]

    def _p_lv_sizes(self):
        s = self.cu
        nb = self.plan.blocks_y * self.plan.blocks_x
        lv_sizes = [nb * s * s]
        if self.chroma:
            lv_sizes += [nb * (s // 2) ** 2] * 2
        return s, nb, lv_sizes

    def _p_pack(self, lv_y, lv_cb, lv_cr, modes, inter_map, ref_sel,
                mv, sses, part=None, mv_pu=None):
        """One transfer buffer (ops/xfer.py): [nibbles][escape records]
        [modes u8][inter u8][ref u8][mv i16 | part u8 + mv_pu i16]
        [meta: esc i32, sse f32 x3]."""
        from kvazaar_jax.ops.xfer import pack_levels
        u8 = lambda x: jax.lax.bitcast_convert_type(x, jnp.uint8)
        lvs = [lv.astype(jnp.int16).reshape(-1)
               for lv in (lv_y, lv_cb, lv_cr) if lv is not None]
        nib, esc, esc_count = pack_levels(jnp.concatenate(lvs),
                                          self.cfg.qp)
        parts = [nib, esc, modes.astype(jnp.uint8).reshape(-1),
                 inter_map.astype(jnp.uint8).reshape(-1),
                 ref_sel.astype(jnp.uint8).reshape(-1)]
        if part is not None:
            parts.append(part.astype(jnp.uint8).reshape(-1))
            parts.append(u8(mv_pu.astype(jnp.int16)).reshape(-1))
        else:
            parts.append(u8(mv.astype(jnp.int16)).reshape(-1))
        parts.append(u8(esc_count[None]).reshape(-1))
        parts.append(u8(sses).reshape(-1))
        return jnp.concatenate(parts)

    def _p_unpack(self, buf: np.ndarray, dense):
        from kvazaar_jax.ops import xfer
        s, nb, lv_sizes = self._p_lv_sizes()
        by, bx = self.plan.blocks_y, self.plan.blocks_x
        smp = self.cfg.smp
        total = sum(lv_sizes)
        cap = xfer.esc_capacity(total, self.cfg.qp)
        sizes = [(total + 1) // 2, cap * 8]
        sizes += [nb, nb, nb]
        sizes += [nb, nb * 8] if smp else [nb * 4]
        sizes += [4, 12]
        offs = np.cumsum([0] + sizes)
        nib = buf[offs[0]:offs[1]]
        escb = buf[offs[1]:offs[2]]
        modes = buf[offs[2]:offs[3]].reshape(by, bx)
        inter_map = buf[offs[3]:offs[4]].reshape(by, bx).astype(bool)
        ref_sel = buf[offs[4]:offs[5]].reshape(by, bx).astype(np.int32)
        k = 5
        part = None
        mv_pu = None
        if smp:
            part = buf[offs[k]:offs[k + 1]].reshape(
                by, bx).astype(np.int32)
            mv_pu = buf[offs[k + 1]:offs[k + 2]].copy() \
                .view(np.int16).astype(np.int32).reshape(by, bx, 2, 2)
            mv = mv_pu[:, :, 0]
            k += 2
        else:
            mv = buf[offs[k]:offs[k + 1]].copy().view(np.int16) \
                .astype(np.int32).reshape(by, bx, 2)
            k += 1
        esc_count = int(buf[offs[k]:offs[k + 1]].copy()
                        .view(np.int32)[0])
        sses = buf[offs[k + 1]:].copy().view(np.float32)
        if esc_count > cap:
            out_lv = [None if d is None else
                      np.asarray(d).astype(np.int32) for d in dense]
        else:
            flat = xfer.unpack_levels(nib, escb, esc_count, total)
            loffs = np.cumsum([0] + lv_sizes)
            out_lv = []
            for k2 in range(3 if self.chroma else 1):
                size = s if k2 == 0 else s // 2
                out_lv.append(
                    flat[loffs[k2]:loffs[k2 + 1]].astype(np.int32)
                    .reshape(nb, size, size))
            while len(out_lv) < 3:
                out_lv.append(None)
        return (out_lv, modes, inter_map, ref_sel, mv, sses, part,
                mv_pu)

    def submit_p(self, y, cb, cr, refs, qp_ctu=None):
        """Dispatch the fused P program (async).  refs: [(ref_poc,
        (y, cb, cr) device planes), ...] in L0 order.  qp_ctu:
        (Cy, Cx) int32 per-CTU QP (LCU rate control)."""
        s = self.cu
        sdt = np.uint8 if self.bitdepth <= 8 else np.uint16
        yp = jnp.asarray(pad_to_multiple(np.asarray(y, sdt), s))
        cbp = crp = None
        if self.chroma:
            cbp = jnp.asarray(
                pad_to_multiple(np.asarray(cb, sdt), s // 2))
            crp = jnp.asarray(
                pad_to_multiple(np.asarray(cr, sdt), s // 2))
        refs_y = jnp.stack([pl[0] for _rp, pl in refs])
        refs_cb = refs_cr = None
        if self.chroma:
            refs_cb = jnp.stack([pl[1] for _rp, pl in refs])
            refs_cr = jnp.stack([pl[2] for _rp, pl in refs])
        if qp_ctu is not None:
            packed, dense, recs = self._p_fused_fns(
                len(refs), with_qp=True)(
                    yp, cbp, crp, refs_y, refs_cb, refs_cr,
                    jnp.asarray(np.asarray(qp_ctu, np.int32)))
        else:
            packed, dense, recs = self._p_fused_fns(len(refs))(
                yp, cbp, crp, refs_y, refs_cb, refs_cr)
        return packed, dense, recs

    def download_p(self, handle):
        """The ONE device->host transfer + host unpack (GIL released;
        call from a worker thread to overlap the next frame's device
        compute)."""
        packed, dense, recs = handle
        return self._p_unpack(np.asarray(packed), dense), recs

    def download_p_many(self, handles):
        """Fetch several submitted P frames in ONE device->host
        transfer: a cached jitted stack of their packed buffers, then
        per-frame unpacks: one transfer call for all the frames already
        in flight (written for a host link where the per-call cost
        dominated the low-delay path)."""
        if len(handles) == 1:
            return [self.download_p(handles[0])]
        k = len(handles)
        if not hasattr(self, "_stack_cache"):
            self._stack_cache = {}
        if k not in self._stack_cache:
            self._stack_cache[k] = jax.jit(
                lambda *bufs: jnp.stack(bufs))
        big = np.asarray(self._stack_cache[k](*[h[0] for h in handles]))
        return [(self._p_unpack(big[i], h[1]), h[2])
                for i, h in enumerate(handles)]

    def finalize_p_downloaded(self, downloaded, poc: int, ref_pocs,
                              retained=(), tctx=None,
                              need_recon: bool = True,
                              multi: bool = True, qp_ctu=None):
        """Host stage: merge/AMVP signalling decisions + CABAC.

        multi: emit the explicit multi-ref RPS / ref-aware candidate
        derivation (the encode_p_frame_multi contract) even with one
        active reference; False = the plain IPPP single-ref stream
        shape."""
        ((lv_y, lv_cb, lv_cr), modes, inter_map, ref_sel, mv, sses,
         part, mv_pu), recs = downloaded
        nref = len(ref_pocs)
        if self.cfg.smp:
            mv8, merge8, mvp8, mvd8 = self._merge_amvp_smp(
                inter_map, part, mv_pu)
            fd = self._assemble_p_frame_data_smp(
                modes, inter_map, part, mv8, merge8, mvp8, mvd8,
                lv_y, lv_cb, lv_cr)
        else:
            if not multi:
                merge_idx, mvp_idx, mvd = self._merge_amvp_fast(
                    inter_map, mv)
            else:
                merge_idx, mvp_idx, mvd = self._merge_amvp_multi(
                    inter_map, ref_sel, mv, nref, poc, ref_pocs, tctx)
            fd = self._assemble_p_frame_data(
                modes, inter_map, mv, merge_idx, mvp_idx, mvd, lv_y,
                lv_cb, lv_cr, ref_sel=ref_sel if multi else None)
        if qp_ctu is not None:
            fd.qp_ctu = np.asarray(qp_ctu, np.int32).copy()
        deltas = [poc - rp for rp in ref_pocs]
        nal = self._serialize_p(
            fd, poc, deltas[0],
            ref_list_l0=deltas if multi else None,
            retained_l0=retained, tmvp=self.cfg.tmvp)
        rec_np = (None, None, None)
        if need_recon or self.cfg.hash in ("md5", "checksum"):
            rec_np = (np.asarray(recs[0]),
                      None if recs[1] is None else np.asarray(recs[1]),
                      None if recs[2] is None else np.asarray(recs[2]))
        if self.cfg.hash in ("md5", "checksum"):
            from kvazaar_jax.bitstream.headers import \
                write_picture_hash_sei
            nal += write_picture_hash_sei(rec_np, self.bitdepth,
                                          kind=self.cfg.hash)
        res = FrameResult(
            nals=nal, recon_y=rec_np[0], recon_cb=rec_np[1],
            recon_cr=rec_np[2], frame_data=fd, bits=len(nal) * 8,
            sse=tuple(float(v) for v in sses))
        return res, recs

    def _cu_decode_order(self):
        """Fixed-grid CU decode order: CTUs in raster order, CUs in
        z-order within each CTU (6.5.1)."""
        from kvazaar_jax.encoder.geometry import z_order_index
        by, bx = self.plan.blocks_y, self.plan.blocks_x
        per_ctu = max(64 // self.cu, 1)
        zs = sorted(((z_order_index(zx, zy), zy, zx)
                     for zy in range(per_ctu)
                     for zx in range(per_ctu)))
        order = []
        for ty in range(-(-by // per_ctu)):
            for tx in range(-(-bx // per_ctu)):
                for _z, zy, zx in zs:
                    cy, cx = ty * per_ctu + zy, tx * per_ctu + zx
                    if cy < by and cx < bx:
                        order.append((cy, cx))
        return order

    def _merge_amvp_smp(self, inter_map, part, mv_pu):
        """Per-PU merge/AMVP signalling for SMP frames: scalar CU loop
        in decode order over the 8-cell motion field (PU-level
        candidate rules of inter_cands.merge_list_pu_at / 6.4.2).

        Returns (mv8 cell field, merge8, mvp8, mvd8) — motion at PU
        marker cells, mv8 region-filled."""
        from kvazaar_jax.encoder.inter_cands import (amvp_pair_pu_at,
                                                     merge_list_pu_at)
        cells = self.cu // 8
        by, bx = inter_map.shape
        h8, w8 = by * cells, bx * cells
        from kvazaar_jax.encoder.inter_cands import pu_cell_rects
        inter8 = np.kron(inter_map, np.ones((cells, cells), bool))
        half = cells // 2
        quarter = max(cells // 4, 1)
        # Final cell-granularity motion field (candidates only read
        # decode-order-previous cells, enforced by _pu_nbr).
        partc = np.kron(part, np.ones((cells, cells), np.int32))
        ri = np.arange(h8)[:, None] % cells
        ci = np.arange(w8)[None, :] % cells
        pu1 = (((partc == 1) & (ri >= half))
               | ((partc == 2) & (ci >= half))
               | ((partc == 4) & (ri >= quarter))
               | ((partc == 5) & (ri >= cells - quarter))
               | ((partc == 6) & (ci >= quarter))
               | ((partc == 7) & (ci >= cells - quarter)))
        up0 = np.kron(mv_pu[:, :, 0],
                      np.ones((cells, cells, 1),
                              np.int32)).reshape(h8, w8, 2)
        up1 = np.kron(mv_pu[:, :, 1],
                      np.ones((cells, cells, 1),
                              np.int32)).reshape(h8, w8, 2)
        mv8 = np.where(pu1[..., None], up1, up0)
        mv8 = np.where(inter8[..., None], mv8, 0)
        merge8 = np.full((h8, w8), -1, np.int32)
        mvp8 = np.zeros((h8, w8), np.uint8)
        mvd8 = np.zeros((h8, w8, 2), np.int32)
        for (cy, cx) in self._cu_decode_order():
            if not inter_map[cy, cx]:
                continue
            p = int(part[cy, cx])
            by8, bx8 = cy * cells, cx * cells
            rects = [r + (i,) for i, r in
                     enumerate(pu_cell_rects(by8, bx8, cells, p))]
            for (ry, rx, rh, rw, pu_idx) in rects:
                mine = (int(mv8[ry, rx, 0]), int(mv8[ry, rx, 1]))
                mlist = merge_list_pu_at(inter8, mv8, ry, rx, rh, rw,
                                         p, pu_idx, cells,
                                         cu_yx=(by8, bx8))
                if mine in mlist:
                    merge8[ry, rx] = mlist.index(mine)
                    continue
                pair = amvp_pair_pu_at(inter8, mv8, ry, rx, rh, rw,
                                       p, pu_idx, cells,
                                       cu_yx=(by8, bx8))
                d0 = abs(mine[0] - pair[0][0]) + abs(mine[1]
                                                     - pair[0][1])
                d1 = abs(mine[0] - pair[1][0]) + abs(mine[1]
                                                     - pair[1][1])
                i = 1 if d1 < d0 else 0
                mvp8[ry, rx] = i
                mvd8[ry, rx] = (mine[0] - pair[i][0],
                                mine[1] - pair[i][1])
        return mv8, merge8, mvp8, mvd8

    def _merge_amvp_fast(self, inter_map, mv):
        """Vectorized single-ref merge/AMVP signalling decisions (all
        MVs are final before this runs — no decode-order recurrence)."""
        mcands = merge_candidates(inter_map, mv, self.plan.avail)
        eq = np.all(mcands == mv[:, :, None, :], axis=-1)
        has_merge = eq.any(axis=-1)
        merge_idx = np.where(has_merge, eq.argmax(axis=-1), -1)
        acands = amvp_candidates(inter_map, mv, self.plan.avail)
        d0 = np.abs(mv - acands[:, :, 0]).sum(axis=-1)
        d1 = np.abs(mv - acands[:, :, 1]).sum(axis=-1)
        mvp_idx = (d1 < d0).astype(np.uint8)
        mvd = mv - np.take_along_axis(
            acands, mvp_idx[..., None, None].astype(np.int64),
            axis=2)[:, :, 0]
        return merge_idx, mvp_idx, mvd

    def _merge_amvp_multi(self, inter_map, ref_sel, mv, nref, poc,
                          ref_pocs, tctx):
        """Scalar decode-order loop for multi-ref / TMVP candidate
        lists (shared with the oracle decoder's derivation)."""
        from kvazaar_jax.encoder.inter_cands import (
            amvp_pair_p_multiref_at, merge_list_p_multiref_at)
        s = self.cu
        if tctx is not None:
            tctx = dict(tctx, cur_poc=poc, w=self.coded_w,
                        h=self.coded_h)
        by, bx = self.plan.blocks_y, self.plan.blocks_x
        merge_idx = np.full((by, bx), -1, np.int32)
        mvp_idx = np.zeros((by, bx), np.uint8)
        mvd = np.zeros((by, bx, 2), np.int32)
        order = np.argsort(self.plan.step_of_block.ravel() * (by * bx)
                           + np.arange(by * bx), kind="stable")
        for bid in order:
            yy, xx = divmod(int(bid), bx)
            if not inter_map[yy, xx]:
                continue
            mine = (int(ref_sel[yy, xx]),
                    (int(mv[yy, xx, 0]), int(mv[yy, xx, 1])))
            mlist = merge_list_p_multiref_at(
                inter_map, ref_sel, mv, self.plan.avail, yy, xx, nref,
                tctx=tctx, ref_pocs=ref_pocs, cu=s)
            if mine in mlist:
                merge_idx[yy, xx] = mlist.index(mine)
                continue
            pair = amvp_pair_p_multiref_at(
                inter_map, ref_sel, mv, self.plan.avail, yy, xx,
                int(ref_sel[yy, xx]), poc, ref_pocs, tctx=tctx, cu=s)
            d0 = sum(abs(int(mv[yy, xx, k]) - pair[0][k])
                     for k in range(2))
            d1 = sum(abs(int(mv[yy, xx, k]) - pair[1][k])
                     for k in range(2))
            idx = 1 if d1 < d0 else 0
            mvp_idx[yy, xx] = idx
            mvd[yy, xx] = (mv[yy, xx, 0] - pair[idx][0],
                           mv[yy, xx, 1] - pair[idx][1])
        return merge_idx, mvp_idx, mvd

    def encode_p_frame_multi(self, y, cb=None, cr=None, poc: int = 1,
                             refs=None, retained=(), tctx=None):
        """P frame against multiple L0 references via the fused
        single-dispatch path.

        refs: [(ref_poc, (y, cb, cr) device planes), ...] in L0 order
        (increasing POC delta); retained: extra POC deltas kept in the
        DPB for later pictures (signalled in the RPS, unused here).
        Reference behavior: per-ref search loop
        (src/search_inter.c:1134) + ref-list RPS emission
        (src/encoderstate.c:990)."""
        handle = self.submit_p(y, cb, cr, refs)
        res, recs = self.finalize_p_downloaded(
            self.download_p(handle), poc, [rp for rp, _pl in refs],
            retained=retained, tctx=tctx)
        return res, recs

    def encode_p_frame(self, y, cb=None, cr=None, poc: int = 1,
                       ref_poc: int = 0, qp_ctu=None, qp=None,
                       qp_factor=None):
        """Plain IPPP P frame against the DPB via the fused path.
        qp_ctu: optional (Cy, Cx) per-CTU QP (LCU rate control);
        qp/qp_factor: per-layer GOP QP + lambda factor (var path)."""
        if self._var_inter_active and qp_ctu is None:
            return self.encode_frame_var_p(y, cb, cr, poc=poc,
                                           ref_poc=ref_poc, qp=qp,
                                           qp_factor=qp_factor)
        handle = self.submit_p(y, cb, cr, [(ref_poc, self._dpb)],
                               qp_ctu=qp_ctu)
        res, recs = self.finalize_p_downloaded(
            self.download_p(handle), poc, [ref_poc], multi=False,
            qp_ctu=qp_ctu)
        self._dpb = recs
        return res

    # ---- Variable-CU quadtree P/B frames (encoder/quadtree.py
    # search_quadtree_p/_b + the data-driven wavefront recon with MC
    # prediction for inter CUs) — the inter half of the reference's
    # recursive search_cu (src/search.c:424-757). ----

    @property
    def _var_inter_active(self) -> bool:
        """P/B frames run the variable quadtree when either tool's CU
        range is non-degenerate, or a degenerate inter size differs
        from the fixed working grid (single-ref-per-list structures;
        the multi-ref/TMVP/SMP paths keep the fixed grid — a
        documented degradation, not a no-op: the ranges still shape
        I-frames and single-ref streams)."""
        cfg = self.cfg
        fixed_cu = min(max(cfg.intra_max_cu, 8), 32)
        return ((cfg.intra_min_cu != cfg.intra_max_cu
                 or cfg.inter_min_cu != cfg.inter_max_cu
                 or cfg.inter_max_cu != fixed_cu)
                and not cfg.smp and cfg.ref_frames == 1
                and cfg.lp_gop is None and not cfg.tmvp)

    def _var_rngs(self):
        return ((self.cfg.intra_min_cu, self.cfg.intra_max_cu),
                (self.cfg.inter_min_cu, self.cfg.inter_max_cu))

    def _var_dconsts(self):
        """Device-resident big static tensors (intra mode weights +
        per-plan ref-gather maps), threaded into every variable-tree
        program as jit ARGUMENTS via ops/devconst.  Inlined, these were
        ~130 MB of HLO constants per program — 100 MB serialized
        executables that were slow to compile and to load from the
        persistent cache."""
        if hasattr(self, "_dconsts_cache"):
            return self._dconsts_cache
        from kvazaar_jax.encoder.geometry import (make_intra_plan,
                                                  plan_flat_gather,
                                                  plan_gidx_key)
        from kvazaar_jax.ops.devconst import POOL
        from kvazaar_jax.ops.intra import mode_weights_np, weight_key
        d = {}
        for n in (4, 8, 16, 32):
            k = weight_key(n, True)
            d[k] = POOL.get(k, lambda n=n: mode_weights_np(n, True)[0])
            if n <= 16:
                k = weight_key(n, False)
                d[k] = POOL.get(
                    k, lambda n=n: mode_weights_np(n, False)[0])
        for s_ in (8, 16, 32):
            # Plans exactly as the search functions build them
            # (quadtree.py: chroma=False, default tiles) — a key the
            # fetch site never asks for is harmless but wasted, and a
            # size that does not tile the coded frame has no plan.
            if self.coded_w % s_ or self.coded_h % s_:
                continue
            plan = make_intra_plan(self.coded_w, self.coded_h, s_,
                                   chroma=False)
            k = plan_gidx_key(plan, True)
            d[k] = POOL.get(k, lambda p=plan: plan_flat_gather(p, True))
            if self.chroma:
                planc = make_intra_plan(self.coded_w, self.coded_h,
                                        s_, chroma=True)
                k = plan_gidx_key(planc, False)
                d[k] = POOL.get(
                    k, lambda p=planc: plan_flat_gather(p, False))
        self._dconsts_cache = d
        return d

    def _var_p_search(self):
        if not hasattr(self, "_qt_search_p"):
            from kvazaar_jax.encoder.quadtree import search_quadtree_p
            intra_rng, inter_rng = self._var_rngs()

            def s(yp, ref_y, lam_satd, qp, lam_rd, dc):
                from kvazaar_jax.ops.devconst import bound
                with bound(dc):
                    outs = search_quadtree_p(
                        yp, ref_y.astype(jnp.int32), self.coded_w,
                        self.coded_h, lam_satd, self.cfg.me_range,
                        self.bitdepth, intra_rng, inter_rng,
                        self.cfg.rd >= 1, subpel=self.cfg.me_subpel,
                        qp=qp, lam_rd=lam_rd)
                vec, self._qt_search_p_spec = _pack_device_tree(outs)
                return vec

            self._qt_search_p = jax.jit(s)
        return self._qt_search_p

    def _var_b_search(self):
        if not hasattr(self, "_qt_search_b"):
            from kvazaar_jax.encoder.quadtree import search_quadtree_b
            intra_rng, inter_rng = self._var_rngs()

            def s(yp, r0, r1, lam_satd, qp, lam_rd, dc):
                from kvazaar_jax.ops.devconst import bound
                with bound(dc):
                    outs = search_quadtree_b(
                        yp, r0.astype(jnp.int32), r1.astype(jnp.int32),
                        self.coded_w, self.coded_h, lam_satd,
                        self.cfg.me_range, self.bitdepth, intra_rng,
                        inter_rng, self.cfg.rd >= 1,
                        subpel=self.cfg.me_subpel,
                        bipred=self.cfg.bipred, qp=qp, lam_rd=lam_rd)
                vec, self._qt_search_b_spec = _pack_device_tree(outs)
                return vec

            self._qt_search_b = jax.jit(s)
        return self._qt_search_b

    @functools.lru_cache(maxsize=8)
    def _var_recon_inter_fn(self, n_steps: int, bi: bool):
        """Fused MC + wavefront recon + deblock for a variable P/B
        tree.  refs enter as device planes; the schedule (incl.
        mv_cells / edge masks) is traced data."""
        from kvazaar_jax.encoder.quadtree import (reconstruct_frame_var,
                                                  var_bs_maps)

        def run(sched, ref0, ref1, dc):
            from kvazaar_jax.ops.devconst import bound
            with bound(dc):
                return run_inner(sched, ref0, ref1)

        def run_inner(sched, ref0, ref1):
            from kvazaar_jax.encoder.inter_search import (
                bi_mc_planes_cells, mc_planes_cells)
            if bi:
                mc = bi_mc_planes_cells(
                    tuple(None if p is None else p.astype(jnp.int32)
                          for p in ref0),
                    tuple(None if p is None else p.astype(jnp.int32)
                          for p in ref1),
                    sched["mv_cells"], sched["mv1_cells"],
                    sched["dirs8"], self.bitdepth)
            else:
                mc = mc_planes_cells(
                    ref0[0].astype(jnp.int32),
                    None if ref0[1] is None else
                    ref0[1].astype(jnp.int32),
                    None if ref0[2] is None else
                    ref0[2].astype(jnp.int32),
                    sched["mv_cells"], self.bitdepth)
            # Frame QP / lambda ride the schedule as traced data: one
            # compiled program serves every GOP layer QP and every
            # rate-control QP (the reference re-inits per frame,
            # kvz_set_picture_lambda_and_qp src/rate_control.c:213;
            # here recompiling per QP would cost minutes).  Scaling
            # lists keep host-baked qp%6 tables -> constants.
            if self.scaling is None and "qp" in sched:
                from kvazaar_jax.constants import CHROMA_QP_TAB
                qp = sched["qp"]
                qp_c = jnp.take(
                    jnp.asarray(np.asarray(CHROMA_QP_TAB, np.int32)),
                    jnp.clip(qp, 0, 51))
                lam = sched["lam"]
                qp_map = jnp.full((self.coded_h // 8,
                                   self.coded_w // 8), qp, jnp.int32)
            else:
                qp, qp_c = self.cfg.qp, self.qp_c
                lam = qp_to_lambda(self.cfg.qp)
                qp_map = None
            (rec_y, rec_cb, rec_cr, levels,
             cbf8) = reconstruct_frame_var(
                sched, qp, qp_c, self.coded_w,
                self.coded_h, self.chroma, self.bitdepth,
                self.cfg.lossless, self.cfg.signhide,
                rdoq=self.cfg.rdoq, lam=lam,
                scaling=self.scaling, mc_planes=mc)
            if self.cfg.deblock:
                bs_v, bs_h = var_bs_maps(
                    sched["inter8"], cbf8, sched["mv_cells"],
                    sched["edge_v"], sched["edge_h"],
                    mv1_cells=sched.get("mv1_cells") if bi else None,
                    dirs8=sched.get("dirs8") if bi else None)
                dy, dcb, dcr = deblock_frame(
                    rec_y, rec_cb, rec_cr, self.cfg.qp, 8,
                    self.bitdepth, bs_v=bs_v, bs_h=bs_h,
                    qp_map=qp_map)
            else:
                dy, dcb, dcr = rec_y, rec_cb, rec_cr
            rdt = jnp.uint8 if self.bitdepth <= 8 else jnp.uint16
            dy = dy.astype(rdt)
            if dcb is not None:
                dcb, dcr = dcb.astype(rdt), dcr.astype(rdt)
            # Levels arrive as pixel-layout planes (scattered on
            # device) — one compact int16 buffer to download.
            lv_flat = jnp.concatenate(
                [lv.reshape(-1) for lv in levels
                 if lv is not None])
            return dy, dcb, dcr, lv_flat.astype(jnp.int16)

        return jax.jit(run)

    def _var_inter_plan(self, size8, mode_maps, imaps, mvs,
                        extra_grids=()):
        """Host planning shared by var P/B: patch 64-CU intra modes
        onto the 32 grid, expand decisions to cells, build the
        schedule + edge masks.  Returns (vp, sched_size8, inter8,
        mv_cells, extras, mode_maps)."""
        from kvazaar_jax.encoder.quadtree import (build_cell_fields,
                                                  var_edge_masks)
        from kvazaar_jax.encoder.var_schedule import build_var_plan
        mode_maps = {k: np.asarray(v) for k, v in mode_maps.items()}
        sched_size8 = np.minimum(size8, 32).astype(size8.dtype)
        if 64 in mode_maps and (size8 == 64).any():
            m32 = mode_maps[32].copy()
            up = np.kron(mode_maps[64], np.ones((2, 2),
                                                m32.dtype))
            mask32 = size8[::4, ::4] == 64
            region = m32[:up.shape[0], :up.shape[1]]
            m32[:up.shape[0], :up.shape[1]] = np.where(
                mask32[:up.shape[0], :up.shape[1]], up, region)
            mode_maps = dict(mode_maps)
            mode_maps[32] = m32
        fields = build_cell_fields(size8, imaps, mvs, extra_grids)
        inter8, mv_cells = fields[0], fields[1]
        vp = build_var_plan(sched_size8, mode_maps, self.coded_w,
                            self.coded_h, self.chroma,
                            inter8_map=inter8)
        return (vp, sched_size8, inter8, mv_cells, fields[2:],
                mode_maps)

    def _var_inter_sched(self, vp, yp, cbp, crp, size8, inter8,
                         mv_cells):
        """Schedule arrays for a var inter frame: the intra var arrays
        + per-class inter masks / cell maps + frame-level motion and
        edge tensors."""
        from kvazaar_jax.encoder.quadtree import var_edge_masks
        sched, lv_shapes = self._var_sched_arrays(vp, yp, cbp, crp,
                                                  size8)
        ev, eh = var_edge_masks(size8)
        sched["edge_v"] = jnp.asarray(ev)
        sched["edge_h"] = jnp.asarray(eh)
        sched["inter8"] = jnp.asarray(inter8)
        sched["mv_cells"] = jnp.asarray(mv_cells)
        del sched["bs_v"], sched["bs_h"]
        return sched, lv_shapes

    def _merge_amvp_var(self, size8, inter8, mv8):
        """Decode-order merge/AMVP signalling for variable 2Nx2N inter
        CUs (cell-granularity candidate rules, 6.4.2/8.5.3.2) —
        frame-wide vectorized (scalar oracle: merge_amvp_var_scalar,
        equivalence-tested in tests/test_var_vec.py)."""
        from kvazaar_jax.encoder.inter_cands import merge_amvp_var_vec
        return merge_amvp_var_vec(size8, inter8, mv8)

    def _merge_amvp_var_b(self, size8, inter8, dirs8, mv08, mv18,
                          poc, ref_poc):
        """B-slice variant: full-motion merge candidates + per-list
        AMVP (8.5.3.2.3/.6) at cell granularity, vectorized."""
        from kvazaar_jax.encoder.inter_cands import \
            merge_amvp_var_b_vec
        return merge_amvp_var_b_vec(size8, inter8, dirs8, mv08, mv18,
                                    poc, ref_poc)

    def _var_skip8(self, fd, size8, inter8, merge8):
        """cu_skip_flag per CU: 2Nx2N merge CUs with no coded
        coefficients in any plane (cell-filled), vectorized."""
        from kvazaar_jax.encoder.inter_cands import var_skip8_vec
        return var_skip8_vec(size8, inter8, merge8, fd.coeff_y,
                             fd.coeff_cb if self.chroma else None,
                             fd.coeff_cr if self.chroma else None)

    @staticmethod
    def _mvd_bits_np(v):
        """Host form of the search's EG1-shaped mvd bit estimate."""
        a = np.abs(v).astype(np.int64)
        nbits = np.zeros_like(a)
        nz = a > 0
        nbits[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
        return np.where(a == 0, 1, 2 * nbits + 1).astype(np.float64)

    # Truncated-unary merge_idx bin counts (max_num_merge_cand 5).
    _MERGE_IDX_BITS = np.array([1.0, 2.0, 3.0, 4.0, 4.0])

    def _cu_sums(self, maps, cy, cx, cells):
        """Per-CU sums of per-cell maps (K, h8, w8) via integral
        images: (K, n)."""
        from kvazaar_jax.encoder.inter_cands import _integral
        out = np.empty((maps.shape[0], cy.size), np.int64)
        for k in range(maps.shape[0]):
            icum = _integral(maps[k])
            out[k] = (icum[cy + cells, cx + cells] - icum[cy, cx + cells]
                      - icum[cy + cells, cx] + icum[cy, cx])
        return out

    def _merge_rd_p(self, yp, ref_y, size8, inter8, mv_cells,
                    lam_satd):
        """Merge-mode RD for a P variable tree: evaluate the 5 merge
        candidates as MC hypotheses per CU (one device pass, per-cell
        SATD maps) against the searched MV + its mvd rate; adopt the
        winning candidate's MV (signalling is re-derived from the
        final field, so the stream stays decode-exact).  Reference:
        src/search_inter.c:415-460,1451-1520."""
        from kvazaar_jax.encoder.inter_cands import (var_origin_maps,
                                                     var_p_derive)
        d = var_p_derive(size8, inter8, mv_cells)
        cy, cx, cells = d["cy"], d["cx"], d["cells"]
        n = cy.size
        if n == 0:
            return mv_cells
        oy, ox = var_origin_maps(size8)
        h8, w8 = inter8.shape
        cand_cells = np.empty((5, h8, w8, 2), np.int32)
        for k in range(5):
            g = mv_cells.copy()
            g[cy, cx] = d["cands"][:, k]
            cand_cells[k] = g[oy, ox]
        if not hasattr(self, "_merge_rd_jit_p"):
            from kvazaar_jax.encoder.inter_search import \
                merge_satd_maps_p
            self._merge_rd_jit_p = jax.jit(functools.partial(
                merge_satd_maps_p, bitdepth=self.bitdepth))
        maps = np.asarray(self._merge_rd_jit_p(
            jnp.asarray(yp), ref_y.astype(jnp.int32),
            jnp.asarray(cand_cells), jnp.asarray(mv_cells)))
        sums = self._cu_sums(maps, cy, cx, cells)      # (6, n)
        mine, p0, p1 = d["mine"], d["p0"], d["p1"]
        amvp_bits = 1.0 + np.minimum(
            self._mvd_bits_np(mine - p0).sum(axis=1),
            self._mvd_bits_np(mine - p1).sum(axis=1))
        costs = np.empty((6, n))
        for k in range(5):
            costs[k] = sums[k] + lam_satd * self._MERGE_IDX_BITS[k]
        costs[5] = sums[5] + lam_satd * amvp_bits
        win = costs.argmin(axis=0)
        upd = win < 5
        if not upd.any():
            return mv_cells
        g = mv_cells.copy()
        g[cy[upd], cx[upd]] = d["cands"][upd, win[upd]]
        return g[oy, ox]

    def _merge_rd_b(self, yp, r0_y, r1_y, size8, inter8, dirs8,
                    emv0, emv1, poc, ref_poc, lam_satd):
        """B variant: candidates carry (dir, mv0, mv1) incl. combined
        bi-pred entries; the winner's full motion replaces the CU's."""
        from kvazaar_jax.encoder.inter_cands import (var_b_derive,
                                                     var_origin_maps)
        d = var_b_derive(size8, inter8, dirs8, emv0, emv1, poc,
                         ref_poc)
        cy, cx, cells = d["cy"], d["cx"], d["cells"]
        n = cy.size
        if n == 0:
            return dirs8, emv0, emv1
        oy, ox = var_origin_maps(size8)
        h8, w8 = inter8.shape
        cd = np.empty((5, h8, w8), np.int32)
        cm0 = np.empty((5, h8, w8, 2), np.int32)
        cm1 = np.empty((5, h8, w8, 2), np.int32)
        for k in range(5):
            gd = dirs8.astype(np.int32).copy()
            g0 = emv0.copy()
            g1 = emv1.copy()
            gd[cy, cx] = d["cd"][:, k]
            g0[cy, cx] = d["c0"][:, k]
            g1[cy, cx] = d["c1"][:, k]
            cd[k] = gd[oy, ox]
            cm0[k] = g0[oy, ox]
            cm1[k] = g1[oy, ox]
        if not hasattr(self, "_merge_rd_jit_b"):
            from kvazaar_jax.encoder.inter_search import \
                merge_satd_maps_b
            self._merge_rd_jit_b = jax.jit(functools.partial(
                merge_satd_maps_b, bitdepth=self.bitdepth))
        maps = np.asarray(self._merge_rd_jit_b(
            jnp.asarray(yp), r0_y.astype(jnp.int32),
            r1_y.astype(jnp.int32), jnp.asarray(cd),
            jnp.asarray(cm0), jnp.asarray(cm1),
            jnp.asarray(dirs8.astype(np.int32)), jnp.asarray(emv0),
            jnp.asarray(emv1)))
        sums = self._cu_sums(maps, cy, cx, cells)
        md, mm0, mm1 = d["md"], d["mm0"], d["mm1"]
        amvp_bits = np.full(n, 2.0)            # inter_pred_idc
        for lst, mmv in ((0, mm0), (1, mm1)):
            p0, p1 = d["amvp"][lst]
            used = (md != 1) if lst == 0 else (md != 0)
            b = 1.0 + np.minimum(
                self._mvd_bits_np(mmv - p0).sum(axis=1),
                self._mvd_bits_np(mmv - p1).sum(axis=1))
            amvp_bits += np.where(used, b, 0.0)
        costs = np.empty((6, n))
        for k in range(5):
            costs[k] = sums[k] + lam_satd * self._MERGE_IDX_BITS[k]
        costs[5] = sums[5] + lam_satd * amvp_bits
        win = costs.argmin(axis=0)
        upd = win < 5
        if not upd.any():
            return dirs8, emv0, emv1
        gd = dirs8.astype(np.int32).copy()
        g0 = emv0.copy()
        g1 = emv1.copy()
        gd[cy[upd], cx[upd]] = d["cd"][upd, win[upd]]
        g0[cy[upd], cx[upd]] = d["c0"][upd, win[upd]]
        g1[cy[upd], cx[upd]] = d["c1"][upd, win[upd]]
        gd, g0, g1 = gd[oy, ox], g0[oy, ox], g1[oy, ox]
        # Keep unused-list normalization on the final field.
        g0 = np.where((gd != 1)[..., None] & inter8[..., None], g0, 0)
        g1 = np.where((gd != 0)[..., None] & inter8[..., None], g1, 0)
        return gd.astype(dirs8.dtype), g0.astype(np.int32), \
            g1.astype(np.int32)

    def _var_frame_qp_lam(self, qp, qp_factor, slice_type):
        """(frame_qp, lam_rd, lam_satd) for a var P/B frame.  Default
        (no override) keeps the instance's baked lambda; a GOP layer
        override applies the reference's per-picture lambda model
        (qp_to_lamba, src/rate_control.c:176)."""
        if qp is None and qp_factor is None:
            return self.cfg.qp, qp_to_lambda(self.cfg.qp), \
                self.lambda_satd
        frame_qp = self.cfg.qp if qp is None else int(qp)
        if self.scaling is not None and frame_qp != self.cfg.qp:
            # Scaling-list quant tables are host-baked per QP: layer
            # QP overrides need a per-QP instance (api falls back).
            raise ValueError("per-frame qp override requires "
                             "scaling=None")
        lam = frame_lambda(frame_qp, slice_type,
                           gop_len=self.cfg.gop_len,
                           intra_period=self.cfg.intra_period,
                           qp_factor=qp_factor, keyframe=False)
        return frame_qp, lam, math.sqrt(lam)

    def encode_frame_var_p(self, y, cb=None, cr=None, poc: int = 1,
                           ref_poc: int = 0, qp=None, qp_factor=None):
        """Variable-quadtree P frame: per-size dense ME + intra search,
        bottom-up tree argmin, MC-aware direct/wavefront recon, per-CU
        merge/AMVP signalling (reference inter quadtree:
        src/search.c:424 + src/search_inter.c:1588)."""
        return self.finalize_var_p(self.submit_var_p(
            y, cb, cr, poc=poc, ref_poc=ref_poc, qp=qp,
            qp_factor=qp_factor))

    def submit_var_p(self, y, cb=None, cr=None, poc: int = 1,
                     ref_poc: int = 0, qp=None, qp_factor=None):
        """Device half of a var P frame: search + tree + plan + merge
        RD + recon/SAO dispatch.  Updates the device DPB immediately
        (async arrays), so the NEXT frame's submit chains on-device
        while this frame's finalize (downloads + host CABAC) runs on a
        worker — the OWF overlap of the reference
        (src/encoderstate.c:790-806) recast as submit/finalize."""
        from kvazaar_jax.constants import SLICE_P
        from kvazaar_jax.encoder.quadtree import choose_tree
        frame_qp, lam_rd, lam_satd = self._var_frame_qp_lam(
            qp, qp_factor, SLICE_P)
        yp = pad_to_multiple(np.asarray(y, np.int32), max(self.cu, 8))
        cbp = crp = None
        if self.chroma:
            cbp = pad_to_multiple(np.asarray(cb, np.int32),
                                  max(self.cu, 8) // 2)
            crp = pad_to_multiple(np.asarray(cr, np.int32),
                                  max(self.cu, 8) // 2)
        refs = self._dpb
        with phase("varp.search"):
            vec = self._var_p_search()(jnp.asarray(yp), refs[0],
                                       jnp.float32(lam_satd),
                                       jnp.int32(frame_qp),
                                       jnp.float32(lam_rd),
                                       self._var_dconsts())
            costs, modes_d, mvs_d, imaps_d = _unpack_host_tree(
                vec, self._qt_search_p_spec)
        # Costs are RD units (roundtrip SSD + lam*modeled bits incl.
        # per-CU syntax bins — quadtree.intra_rd_recost/inter_rd_grid):
        # the tree argmin adds only the split-flag bins.
        from kvazaar_jax.encoder.quadtree import SPLIT_FLAG_BINS
        size8 = choose_tree(costs, self.coded_w, self.coded_h,
                            lam_rd, percu_bits=0.0,
                            split_bits=SPLIT_FLAG_BINS)
        imaps = {k: np.asarray(v) for k, v in imaps_d.items()}
        mvs = {k: np.asarray(v) for k, v in mvs_d.items()}
        (vp, sched_size8, inter8, mv_cells, _extras,
         mode_maps) = self._var_inter_plan(size8, modes_d, imaps, mvs)
        with phase("varp.mergerd"):
            mv_cells = self._merge_rd_p(yp, refs[0], size8, inter8,
                                        mv_cells, lam_satd)
        sched, lv_shapes = self._var_inter_sched(
            vp, yp, cbp, crp, size8, inter8, mv_cells)
        if self.scaling is None:
            sched["qp"] = jnp.int32(frame_qp)
            sched["lam"] = jnp.float32(lam_rd)
        dy, dcb, dcr, lv_flat = self._var_recon_inter_fn(
            vp.n_steps, False)(sched, refs, refs,
                               self._var_dconsts())
        sao = None
        if self.cfg.sao:
            (ry, rcb, rcr), sao_list = self._sao_stage(
                (yp[None],
                 None if cbp is None else cbp[None],
                 None if crp is None else crp[None]),
                (dy[None],
                 None if dcb is None else dcb[None],
                 None if dcr is None else dcr[None]), lam=lam_rd)
            # Defer the params download to the finalize worker (the
            # lazy handle resolves on first index).
            sao = sao_list
            dy = ry[0]
            if self.chroma:
                dcb, dcr = rcb[0], rcr[0]
        self._dpb = (dy, dcb, dcr)
        return dict(kind="p", poc=poc, ref_poc=ref_poc,
                    frame_qp=frame_qp, vp=vp, size8=size8,
                    sched_size8=sched_size8, mode_maps=mode_maps,
                    inter8=inter8, mv_cells=mv_cells,
                    lv_shapes=lv_shapes, lv_flat=lv_flat,
                    dy=dy, dcb=dcb, dcr=dcr, sao=sao)

    def finalize_var_p(self, h) -> FrameResult:
        """Host half of a var P frame: level/recon downloads, frame
        data assembly, signalling derivation, CABAC serialize."""
        vp, size8, inter8 = h["vp"], h["size8"], h["inter8"]
        mv_cells = h["mv_cells"]
        fd = self._var_frame_data(vp, size8, h["mode_maps"],
                                  np.asarray(h["lv_flat"]),
                                  h["lv_shapes"],
                                  sched_size8=h["sched_size8"])
        fd.inter8[:] = inter8.astype(np.uint8)
        fd.mv8[:] = mv_cells
        merge8, mvp8, mvd8 = self._merge_amvp_var(size8, inter8,
                                                  mv_cells)
        fd.merge8[:] = np.clip(merge8, -1, 4).astype(np.int8)
        fd.mvp8[:] = mvp8
        fd.mvd8[:] = mvd8
        fd.skip8[:] = self._var_skip8(fd, size8, inter8, merge8)
        sao = h["sao"]
        if sao is not None:
            if isinstance(sao, _LazySaoParams):
                sao = sao[0]            # one-buffer download, here
            fd.sao_merge[:] = sao["merge"]
            fd.sao_type[:] = sao["type"]
            fd.sao_eo[:] = sao["eo"]
            fd.sao_bp[:] = sao["bp"]
            fd.sao_off[:] = sao["off"]
        rec_y = np.asarray(h["dy"])
        rec_cb = np.asarray(h["dcb"]) if self.chroma else None
        rec_cr = np.asarray(h["dcr"]) if self.chroma else None
        nal = self._serialize_p(fd, h["poc"], h["poc"] - h["ref_poc"],
                               qp=h["frame_qp"])
        if self.cfg.hash in ("md5", "checksum"):
            from kvazaar_jax.bitstream.headers import \
                write_picture_hash_sei
            nal += write_picture_hash_sei((rec_y, rec_cb, rec_cr),
                                          self.bitdepth,
                                          kind=self.cfg.hash)
        return FrameResult(nals=nal, recon_y=rec_y, recon_cb=rec_cb,
                           recon_cr=rec_cr, frame_data=fd,
                           bits=len(nal) * 8)

    def encode_frame_var_b(self, y, cb, cr, poc: int, ref0, ref1,
                           qp=None, qp_factor=None):
        """Variable-quadtree B frame (one reference per list)."""
        h = self.submit_var_b(y, cb, cr, poc, ref0, ref1, qp=qp,
                              qp_factor=qp_factor)
        return self.finalize_var_b(h), (h["dy"], h["dcb"], h["dcr"])

    def submit_var_b(self, y, cb, cr, poc: int, ref0, ref1,
                     qp=None, qp_factor=None, nal_type=None):
        """Device half of a var B frame (see submit_var_p).
        nal_type: RASL_R for open-GOP leading pictures."""
        from kvazaar_jax.constants import SLICE_B
        from kvazaar_jax.encoder.quadtree import choose_tree
        frame_qp, lam_rd, lam_satd = self._var_frame_qp_lam(
            qp, qp_factor, SLICE_B)
        yp = pad_to_multiple(np.asarray(y, np.int32), max(self.cu, 8))
        cbp = crp = None
        if self.chroma:
            cbp = pad_to_multiple(np.asarray(cb, np.int32),
                                  max(self.cu, 8) // 2)
            crp = pad_to_multiple(np.asarray(cr, np.int32),
                                  max(self.cu, 8) // 2)
        poc0, r0 = ref0
        poc1, r1 = ref1
        with phase("varb.search"):
            vec = self._var_b_search()(jnp.asarray(yp), r0[0], r1[0],
                                       jnp.float32(lam_satd),
                                       jnp.int32(frame_qp),
                                       jnp.float32(lam_rd),
                                       self._var_dconsts())
            (costs, modes_d, mv0_d, mv1_d, dirs_d,
             imaps_d) = _unpack_host_tree(vec, self._qt_search_b_spec)
        with phase("varb.tree"):
            from kvazaar_jax.encoder.quadtree import SPLIT_FLAG_BINS
            size8 = choose_tree(costs, self.coded_w, self.coded_h,
                                lam_rd, percu_bits=0.0,
                                split_bits=SPLIT_FLAG_BINS)
        imaps, mv0s, mv1s, dirss = imaps_d, mv0_d, mv1_d, dirs_d
        with phase("varb.plan"):
            (vp, sched_size8, inter8, mv0_cells, extras,
             mode_maps) = self._var_inter_plan(size8, modes_d, imaps,
                                               mv0s, (mv1s, dirss))
            mv1_cells, dirs8 = extras
        # Effective per-list fields (zero for unused lists — the form
        # candidates and the decoder reconstruct).
        emv0 = np.where((dirs8 != 1)[..., None] & inter8[..., None],
                        mv0_cells, 0)
        emv1 = np.where((dirs8 != 0)[..., None] & inter8[..., None],
                        mv1_cells, 0)
        with phase("varb.mergerd"):
            dirs8, emv0, emv1 = self._merge_rd_b(
                yp, r0[0], r1[0], size8, inter8, dirs8, emv0, emv1,
                poc, (poc0, poc1), lam_satd)
        with phase("varb.sched"):
            sched, lv_shapes = self._var_inter_sched(
                vp, yp, cbp, crp, size8, inter8, emv0)
            sched["mv1_cells"] = jnp.asarray(emv1)
            sched["dirs8"] = jnp.asarray(np.where(inter8, dirs8, 0)
                                         .astype(np.int32))
            if self.scaling is None:
                sched["qp"] = jnp.int32(frame_qp)
                sched["lam"] = jnp.float32(lam_rd)
        with phase("varb.recon"):
            dy, dcb, dcr, lv_flat = self._var_recon_inter_fn(
                vp.n_steps, True)(sched, r0, r1,
                                  self._var_dconsts())
        sao = None
        if self.cfg.sao:
          with phase("varb.sao"):
            (ry, rcb, rcr), sao_list = self._sao_stage(
                (yp[None],
                 None if cbp is None else cbp[None],
                 None if crp is None else crp[None]),
                (dy[None],
                 None if dcb is None else dcb[None],
                 None if dcr is None else dcr[None]), lam=lam_rd)
            # Defer the params download to the finalize worker (the
            # lazy handle resolves on first index).
            sao = sao_list
            dy = ry[0]
            if self.chroma:
                dcb, dcr = rcb[0], rcr[0]
        return dict(kind="b", poc=poc, poc0=poc0, poc1=poc1,
                    nal_type=nal_type,
                    frame_qp=frame_qp, vp=vp, size8=size8,
                    sched_size8=sched_size8, mode_maps=mode_maps,
                    inter8=inter8, dirs8=dirs8, emv0=emv0, emv1=emv1,
                    lv_shapes=lv_shapes, lv_flat=lv_flat,
                    dy=dy, dcb=dcb, dcr=dcr, sao=sao)

    def finalize_var_b(self, h) -> FrameResult:
        """Host half of a var B frame."""
        vp, size8, inter8 = h["vp"], h["size8"], h["inter8"]
        dirs8, emv0, emv1 = h["dirs8"], h["emv0"], h["emv1"]
        poc, poc0, poc1 = h["poc"], h["poc0"], h["poc1"]
        with phase("varb.framedata"):
            fd = self._var_frame_data(vp, size8, h["mode_maps"],
                                      np.asarray(h["lv_flat"]),
                                      h["lv_shapes"],
                                      sched_size8=h["sched_size8"])
        fd.inter8[:] = inter8.astype(np.uint8)
        fd.mv8[:] = emv0
        fd.mv8_l1[:] = emv1
        fd.dir8[:] = np.where(inter8, dirs8, 0).astype(np.uint8)
        with phase("varb.mergeamvp"):
            merge8, mvp8, mvd8, mvp8_l1, mvd8_l1 = \
                self._merge_amvp_var_b(
                    size8, inter8, dirs8, emv0, emv1, poc,
                    (poc0, poc1))
        fd.merge8[:] = np.clip(merge8, -1, 4).astype(np.int8)
        fd.mvp8[:] = mvp8
        fd.mvd8[:] = mvd8
        fd.mvp8_l1[:] = mvp8_l1
        fd.mvd8_l1[:] = mvd8_l1
        fd.skip8[:] = self._var_skip8(fd, size8, inter8, merge8)
        sao = h["sao"]
        if sao is not None:
            if isinstance(sao, _LazySaoParams):
                sao = sao[0]            # one-buffer download, here
            fd.sao_merge[:] = sao["merge"]
            fd.sao_type[:] = sao["type"]
            fd.sao_eo[:] = sao["eo"]
            fd.sao_bp[:] = sao["bp"]
            fd.sao_off[:] = sao["off"]
        with phase("varb.recon_dl"):
            rec_y = np.asarray(h["dy"])
            rec_cb = np.asarray(h["dcb"]) if self.chroma else None
            rec_cr = np.asarray(h["dcr"]) if self.chroma else None
        with phase("varb.serialize"):
            nal = self._serialize_b(
                fd, poc, poc - poc0, poc1 - poc, qp=h["frame_qp"],
                nal_type=h.get("nal_type") or NAL_TRAIL_R)
        if self.cfg.hash in ("md5", "checksum"):
            from kvazaar_jax.bitstream.headers import \
                write_picture_hash_sei
            nal += write_picture_hash_sei((rec_y, rec_cb, rec_cr),
                                          self.bitdepth,
                                          kind=self.cfg.hash)
        return FrameResult(nals=nal, recon_y=rec_y, recon_cb=rec_cb,
                           recon_cr=rec_cr, frame_data=fd,
                           bits=len(nal) * 8)

    def _assemble_p_frame_data_smp(self, modes, inter_map, part, mv8,
                                   merge8, mvp8, mvd8, lv_y, lv_cb,
                                   lv_cr):
        """FrameData for an SMP P frame: part mode + PU-marker motion
        on the 8-cell grid."""
        s = self.cu
        cells = s // 8
        fd = FrameData.empty(self.coded_w, self.coded_h, self.chroma)
        fd.depth8[:] = 6 - int(math.log2(s))
        fd.mode4[:] = np.kron(modes.astype(np.uint8),
                              np.ones((s // 4, s // 4), np.uint8))
        fd.coeff_y[:] = blocks_to_plane(lv_y, self.plan, s,
                                        self.coded_w, self.coded_h)
        if self.chroma:
            fd.coeff_cb[:] = blocks_to_plane(lv_cb, self.plan, s // 2,
                                             self.coded_w // 2,
                                             self.coded_h // 2)
            fd.coeff_cr[:] = blocks_to_plane(lv_cr, self.plan, s // 2,
                                             self.coded_w // 2,
                                             self.coded_h // 2)
        ones = np.ones((cells, cells), np.uint8)
        fd.inter8[:] = np.kron(inter_map.astype(np.uint8), ones)
        fd.mv8[:] = mv8
        fd.part8[::cells, ::cells] = np.where(inter_map, part,
                                              0).astype(np.uint8)
        fd.merge8[:] = np.clip(merge8, -1, 4).astype(np.int8)
        fd.mvp8[:] = mvp8
        fd.mvd8[:] = mvd8
        # Skip: 2Nx2N merge CUs with no coefficients anywhere.
        by, bx = inter_map.shape
        czero = ~np.any(fd.coeff_y.reshape(by, s, bx, s), axis=(1, 3))
        if self.chroma:
            s2 = s // 2
            czero &= ~np.any(fd.coeff_cb.reshape(by, s2, bx, s2),
                             axis=(1, 3))
            czero &= ~np.any(fd.coeff_cr.reshape(by, s2, bx, s2),
                             axis=(1, 3))
        skip = (inter_map & (part == 0)
                & (merge8[::cells, ::cells] >= 0) & czero)
        fd.skip8[:] = np.kron(skip.astype(np.uint8), ones)
        return fd

    def _assemble_p_frame_data(self, modes, inter_map, mv, merge_idx,
                               mvp_idx, mvd, lv_y, lv_cb, lv_cr,
                               ref_sel=None):
        s = self.cu
        c8 = s // 8
        fd = FrameData.empty(self.coded_w, self.coded_h, self.chroma)
        fd.depth8[:] = 6 - int(math.log2(s))
        fd.mode4[:] = np.kron(modes.astype(np.uint8),
                              np.ones((s // 4, s // 4), np.uint8))
        fd.coeff_y[:] = blocks_to_plane(lv_y, self.plan, s,
                                        self.coded_w, self.coded_h)
        if self.chroma:
            fd.coeff_cb[:] = blocks_to_plane(lv_cb, self.plan, s // 2,
                                             self.coded_w // 2,
                                             self.coded_h // 2)
            fd.coeff_cr[:] = blocks_to_plane(lv_cr, self.plan, s // 2,
                                             self.coded_w // 2,
                                             self.coded_h // 2)

        ones = np.ones((c8, c8), np.uint8)
        fd.inter8[:] = np.kron(inter_map.astype(np.uint8), ones)
        fd.mv8[:] = np.kron(mv, np.ones((c8, c8, 1), np.int32)) \
            .reshape(fd.mv8.shape)

        # Per-CU zero-coefficient detection → skip (merge CUs only).
        by, bx = inter_map.shape
        czero = np.ones((by, bx), bool)
        ys = fd.coeff_y.reshape(by, s, bx, s)
        czero &= ~np.any(ys, axis=(1, 3))
        if self.chroma:
            s2 = s // 2
            cbs = fd.coeff_cb.reshape(by, s2, bx, s2)
            crs = fd.coeff_cr.reshape(by, s2, bx, s2)
            czero &= ~np.any(cbs, axis=(1, 3))
            czero &= ~np.any(crs, axis=(1, 3))

        skip = inter_map & (merge_idx >= 0) & czero
        fd.skip8[:] = np.kron(skip.astype(np.uint8), ones)
        # merge8/mvp8/mvd8 live at CU marker cells.
        fd.merge8[::c8, ::c8] = np.where(inter_map, merge_idx,
                                         -1).astype(np.int8)
        use_amvp = inter_map & (merge_idx < 0)
        fd.mvp8[::c8, ::c8] = np.where(use_amvp, mvp_idx, 0)
        fd.mvd8[::c8, ::c8] = np.where(use_amvp[..., None], mvd, 0)
        if ref_sel is not None:
            fd.ref8[:] = np.kron(
                np.where(inter_map, ref_sel, 0),
                np.ones((c8, c8), np.int32)).astype(np.uint8)
        return fd

    # ---- B frames (hierarchical GOP; H.265 B slices with one
    # reference per list, explicit L0/L1/BI signalling) ----

    def _search_b_impl(self, y, r0, r1):
        from kvazaar_jax.encoder.inter_search import (_mv_bits_est,
                                                      _mv_pred_grid)
        from kvazaar_jax.encoder.intra_search import satd8_batch
        from kvazaar_jax.ops.inter import bi_average, mc_luma_hp
        modes, intra_cost = search_frame_modes(
            y, self.plan, self.lambda_satd, self.bitdepth,
            two_pass=self.cfg.rd >= 1)
        mv0, c0 = search_inter_frame(
            y, r0.astype(jnp.int32), self.plan, self.lambda_me,
            self.cfg.me_range, self.bitdepth,
            subpel=self.cfg.me_subpel)
        mv1, c1 = search_inter_frame(
            y, r1.astype(jnp.int32), self.plan, self.lambda_me,
            self.cfg.me_range, self.bitdepth,
            subpel=self.cfg.me_subpel)
        s = self.cu
        by, bx = self.plan.blocks_y, self.plan.blocks_x
        n = by * bx
        ys_, xs_ = np.mgrid[0:by, 0:bx]
        x0s = jnp.asarray((xs_ * s).reshape(-1))
        y0s = jnp.asarray((ys_ * s).reshape(-1))
        hp0 = mc_luma_hp(r0.astype(jnp.int32), x0s, y0s,
                         mv0.reshape(n, 2), s, self.bitdepth)
        hp1 = mc_luma_hp(r1.astype(jnp.int32), x0s, y0s,
                         mv1.reshape(n, 2), s, self.bitdepth)
        bi = bi_average(hp0, hp1, self.bitdepth)
        cur = y.reshape(by, s, bx, s).transpose(0, 2, 1, 3)
        cur = cur.reshape(n, s, s).astype(jnp.int32)
        satd_bi = satd8_batch(bi - cur).reshape(by, bx)
        p0 = _mv_pred_grid(mv0)
        p1 = _mv_pred_grid(mv1)
        rate_bi = (_mv_bits_est(mv0[..., 0] - p0[..., 0])
                   + _mv_bits_est(mv0[..., 1] - p0[..., 1])
                   + _mv_bits_est(mv1[..., 0] - p1[..., 0])
                   + _mv_bits_est(mv1[..., 1] - p1[..., 1]))
        cbi = satd_bi.astype(jnp.float32) + self.lambda_me * rate_bi
        if not self.cfg.bipred:
            # --no-bipred (reference --bipred 0 default below
            # veryslow): uni-prediction only.
            cbi = jnp.full_like(cbi, jnp.inf)
        costs = jnp.stack([c0, c1, cbi])
        dirs = jnp.argmin(costs, axis=0).astype(jnp.int32)
        inter_cost = jnp.min(costs, axis=0)
        return modes, intra_cost, mv0, mv1, dirs, inter_cost

    def _recon_b_impl(self, y, cb, cr, ref0, ref1, modes, mv0, mv1,
                      dirs, is_inter):
        from kvazaar_jax.encoder.inter_search import bi_mc_planes
        r0 = tuple(None if p is None else p.astype(jnp.int32)
                   for p in ref0)
        r1 = tuple(None if p is None else p.astype(jnp.int32)
                   for p in ref1)
        mc_y, mc_cb, mc_cr = bi_mc_planes(r0, r1, mv0, mv1, dirs,
                                          self.plan, self.bitdepth)
        rec_y, lv_y, rec_cb, lv_cb, rec_cr, lv_cr = reconstruct_frames(
            y[None], None if cb is None else cb[None],
            None if cr is None else cr[None], modes[None], self.plan,
            self.cfg.qp, self.qp_c, self.bitdepth,
            is_inter=is_inter[None], mc_y=mc_y[None],
            mc_cb=None if mc_cb is None else mc_cb[None],
            mc_cr=None if mc_cr is None else mc_cr[None],
            lossless=self.cfg.lossless, signhide=self.cfg.signhide,
            rdoq=self.cfg.rdoq, lam=qp_to_lambda(self.cfg.qp),
            scaling=self.scaling)
        rec_y, lv_y = rec_y[0], lv_y[0]
        if cb is not None:
            rec_cb, lv_cb = rec_cb[0], lv_cb[0]
            rec_cr, lv_cr = rec_cr[0], lv_cr[0]
        cbf_blk = jnp.any(lv_y != 0, axis=(-1, -2)).reshape(
            self.plan.blocks_y, self.plan.blocks_x)
        if self.cfg.deblock:
            bs_v, bs_h = compute_bs_maps_b(is_inter, cbf_blk, dirs,
                                           mv0, mv1)
            dy, dcb, dcr = deblock_frame(
                rec_y, rec_cb, rec_cr, self.cfg.qp, self.cu,
                self.bitdepth, bs_v=bs_v, bs_h=bs_h)
            rdt = rec_y.dtype
            rec_y = dy.astype(rdt)
            if rec_cb is not None:
                rec_cb, rec_cr = dcb.astype(rdt), dcr.astype(rdt)
        return rec_y, lv_y, rec_cb, lv_cb, rec_cr, lv_cr

    def encode_b_frame(self, y, cb, cr, poc: int, ref0, ref1,
                       slice_qp: int = None, qp: int = None,
                       qp_factor: float = None):
        """ref0/ref1: (ref_poc, (y, cb, cr) device planes), past and
        future references.  qp/qp_factor: per-layer GOP QP offset +
        lambda factor (traced through the var path — one compiled
        program serves all layers)."""
        if self._var_inter_active:
            return self.encode_frame_var_b(y, cb, cr, poc, ref0, ref1,
                                           qp=qp, qp_factor=qp_factor)
        from kvazaar_jax.encoder.inter_cands import amvp_pair_b_at
        s = self.cu
        yp = jnp.asarray(pad_to_multiple(np.asarray(y, np.int32), s))
        cbp = crp = None
        if self.chroma:
            cbp = jnp.asarray(
                pad_to_multiple(np.asarray(cb, np.int32), s // 2))
            crp = jnp.asarray(
                pad_to_multiple(np.asarray(cr, np.int32), s // 2))
        poc0, r0 = ref0
        poc1, r1 = ref1
        modes, intra_cost, mv0, mv1, dirs, inter_cost = \
            self._device_search_b(yp, r0[0], r1[0])
        modes = np.asarray(modes)
        mv0 = np.asarray(mv0)
        mv1 = np.asarray(mv1)
        dirs = np.asarray(dirs)
        inter_map = np.asarray(inter_cost) <= np.asarray(intra_cost) \
            * 1.02
        mv0 = np.where(inter_map[..., None], mv0, 0).astype(np.int32)
        mv1 = np.where(inter_map[..., None], mv1, 0).astype(np.int32)
        dirs = np.where(inter_map, dirs, 0).astype(np.int32)

        rec_y, lv_y, rec_cb, lv_cb, rec_cr, lv_cr = \
            self._device_recon_b(yp, cbp, crp, r0, r1,
                                 jnp.asarray(modes), jnp.asarray(mv0),
                                 jnp.asarray(mv1), jnp.asarray(dirs),
                                 jnp.asarray(inter_map))

        # merge/mvd/mvp per list against spec candidates in z-scan
        # decode order.
        from kvazaar_jax.encoder.inter_cands import merge_list_b_at
        by, bx = self.plan.blocks_y, self.plan.blocks_x
        mvd0 = np.zeros((by, bx, 2), np.int32)
        mvd1 = np.zeros((by, bx, 2), np.int32)
        mvp0 = np.zeros((by, bx), np.uint8)
        mvp1 = np.zeros((by, bx), np.uint8)
        merge_idx = np.full((by, bx), -1, np.int32)
        order = np.argsort(self.plan.step_of_block.ravel()
                           * (by * bx)
                           + np.arange(by * bx), kind="stable")
        # Effective per-list MV fields as the decoder reconstructs them
        # (zero for unused lists).
        emv0 = np.where((dirs != 1)[..., None] & inter_map[..., None],
                        mv0, 0)
        emv1 = np.where((dirs != 0)[..., None] & inter_map[..., None],
                        mv1, 0)
        for bid in order:
            yy, xx = divmod(int(bid), bx)
            if not inter_map[yy, xx]:
                continue
            d = int(dirs[yy, xx])
            mine = (d, (int(emv0[yy, xx, 0]), int(emv0[yy, xx, 1])),
                    (int(emv1[yy, xx, 0]), int(emv1[yy, xx, 1])))
            mlist = merge_list_b_at(inter_map, dirs, emv0, emv1,
                                    self.plan.avail, yy, xx,
                                    (poc0, poc1))
            if mine in mlist:
                merge_idx[yy, xx] = mlist.index(mine)
                continue
            if d != 1:
                pair = amvp_pair_b_at(inter_map, dirs, emv0, emv1,
                                      self.plan.avail, yy, xx, 0, poc,
                                      (poc0, poc1))
                d0 = sum(abs(int(mv0[yy, xx, k]) - pair[0][k])
                         for k in range(2))
                d1 = sum(abs(int(mv0[yy, xx, k]) - pair[1][k])
                         for k in range(2))
                idx = 1 if d1 < d0 else 0
                mvp0[yy, xx] = idx
                mvd0[yy, xx] = (mv0[yy, xx, 0] - pair[idx][0],
                                mv0[yy, xx, 1] - pair[idx][1])
            if d != 0:
                pair = amvp_pair_b_at(inter_map, dirs, emv0, emv1,
                                      self.plan.avail, yy, xx, 1, poc,
                                      (poc0, poc1))
                d0 = sum(abs(int(mv1[yy, xx, k]) - pair[0][k])
                         for k in range(2))
                d1 = sum(abs(int(mv1[yy, xx, k]) - pair[1][k])
                         for k in range(2))
                idx = 1 if d1 < d0 else 0
                mvp1[yy, xx] = idx
                mvd1[yy, xx] = (mv1[yy, xx, 0] - pair[idx][0],
                                mv1[yy, xx, 1] - pair[idx][1])

        fd = self._assemble_b_frame_data(
            modes, inter_map, dirs, emv0, emv1, mvd0, mvd1, mvp0,
            mvp1, merge_idx, np.asarray(lv_y),
            None if lv_cb is None else np.asarray(lv_cb),
            None if lv_cr is None else np.asarray(lv_cr))
        nal = self._serialize_b(fd, poc, poc - poc0, poc1 - poc)
        if self.cfg.hash in ("md5", "checksum"):
            from kvazaar_jax.bitstream.headers import \
                write_picture_hash_sei
            nal += write_picture_hash_sei(
                (np.asarray(rec_y), np.asarray(rec_cb),
                 np.asarray(rec_cr)), self.bitdepth,
                kind=self.cfg.hash)
        return FrameResult(
            nals=nal, recon_y=np.asarray(rec_y),
            recon_cb=None if rec_cb is None else np.asarray(rec_cb),
            recon_cr=None if rec_cr is None else np.asarray(rec_cr),
            frame_data=fd, bits=len(nal) * 8), (rec_y, rec_cb, rec_cr)

    def _assemble_b_frame_data(self, modes, inter_map, dirs, mv0, mv1,
                               mvd0, mvd1, mvp0, mvp1, merge_idx,
                               lv_y, lv_cb, lv_cr):
        s = self.cu
        c8 = s // 8
        fd = FrameData.empty(self.coded_w, self.coded_h, self.chroma)
        fd.depth8[:] = 6 - int(math.log2(s))
        fd.mode4[:] = np.kron(modes.astype(np.uint8),
                              np.ones((s // 4, s // 4), np.uint8))
        fd.coeff_y[:] = blocks_to_plane(lv_y, self.plan, s,
                                        self.coded_w, self.coded_h)
        if self.chroma:
            fd.coeff_cb[:] = blocks_to_plane(lv_cb, self.plan, s // 2,
                                             self.coded_w // 2,
                                             self.coded_h // 2)
            fd.coeff_cr[:] = blocks_to_plane(lv_cr, self.plan, s // 2,
                                             self.coded_w // 2,
                                             self.coded_h // 2)
        ones = np.ones((c8, c8), np.uint8)
        fd.inter8[:] = np.kron(inter_map.astype(np.uint8), ones)
        fd.dir8[:] = np.kron(dirs.astype(np.uint8), ones)
        fd.mv8[:] = np.kron(mv0, np.ones((c8, c8, 1), np.int32)) \
            .reshape(fd.mv8.shape)
        fd.mv8_l1[:] = np.kron(mv1, np.ones((c8, c8, 1), np.int32)) \
            .reshape(fd.mv8_l1.shape)

        # Per-CU zero-coefficient detection → skip (merge CUs only),
        # same as the P path.
        by, bx = inter_map.shape
        czero = np.ones((by, bx), bool)
        ys = fd.coeff_y.reshape(by, s, bx, s)
        czero &= ~np.any(ys, axis=(1, 3))
        if self.chroma:
            s2 = s // 2
            czero &= ~np.any(fd.coeff_cb.reshape(by, s2, bx, s2),
                             axis=(1, 3))
            czero &= ~np.any(fd.coeff_cr.reshape(by, s2, bx, s2),
                             axis=(1, 3))
        skip = inter_map & (merge_idx >= 0) & czero
        fd.skip8[:] = np.kron(skip.astype(np.uint8), ones)
        fd.merge8[::c8, ::c8] = np.where(inter_map, merge_idx,
                                         -1).astype(np.int8)
        use_amvp = inter_map & (merge_idx < 0)
        fd.mvp8[::c8, ::c8] = np.where(use_amvp, mvp0, 0)
        fd.mvp8_l1[::c8, ::c8] = np.where(use_amvp, mvp1, 0)
        fd.mvd8[::c8, ::c8] = np.where(use_amvp[..., None], mvd0, 0)
        fd.mvd8_l1[::c8, ::c8] = np.where(use_amvp[..., None], mvd1, 0)
        return fd

    def _islice_nal_poc(self):
        """(nal_type, poc) for the current intra picture: the open-GOP
        CRA override set by encode_frame, else IDR at POC 0."""
        ctx = getattr(self, "_islice_ctx", None)
        return ctx if ctx is not None else (NAL_IDR_W_RADL, 0)

    def _slice_nals(self, fd, slice_type, nal_type, hdr_kwargs,
                    nref_l0: int = 1, qp=None) -> bytes:
        """--slices emission: one NAL per slice segment (reference
        per-child slice headers, src/encoder_state-bitstream.c:964-980).
        wpp mode: CTU rows as dependent segments of one slice; tiles
        mode: independent slice per tile."""
        qp = self.cfg.qp if qp is None else qp
        enc = SliceDataEncoder(self.params, fd,
                               Contexts(slice_type, qp),
                               CabacEncoder(BitWriter()),
                               nref_l0=nref_l0)
        self._apply_crypto_iv(enc)
        if self.params.slices == "wpp":
            segs = enc.encode_row_slices()
            ctus_x = self.params.width_in_ctus
            addrs = [r * ctus_x for r in range(len(segs))]
            dep = True
        else:
            segs = enc.encode_tile_slices()
            # slice_segment_address is in TILE-scan CTB order
            # (7.4.7.1): cumulative CTB count of preceding tiles.
            addrs = []
            acc = 0
            for ctus in enc._tile_ctus:
                addrs.append(acc)
                acc += len(ctus)
            dep = False
        out = b""
        for i, (seg, a) in enumerate(zip(segs, addrs)):
            w = BitWriter()
            write_slice_header(w, self.params, slice_type, nal_type,
                               qp, first_seg=(i == 0),
                               dependent=dep and i > 0, seg_address=a,
                               **hdr_kwargs)
            out += nal_unit(w.get_bytes() + seg, nal_type)
        return out

    def _serialize_b(self, fd, poc, rpd0, rpd1, qp=None,
                     nal_type=NAL_TRAIL_R):
        qp = self.cfg.qp if qp is None else qp
        if self.params.slices != "none":
            from kvazaar_jax.constants import SLICE_B
            return self._slice_nals(
                fd, SLICE_B, nal_type,
                dict(poc=poc, ref_poc_diff=rpd0, ref_poc_diff_l1=rpd1),
                qp=qp)
        from kvazaar_jax.constants import SLICE_B
        if not self.params.transquant_bypass \
                and self.params.max_tr_depth_intra == 0 \
                and self.params.crypto_key is None \
                and self.params.slices == "none" \
                and not self.params.tiles_enabled:
            data, sizes = native.encode_slice_data_native_p(
                self.params, fd, qp, self.params.wpp,
                slice_type=SLICE_B, nthreads=self.cfg.threads or 4)
        else:
            sizes = []
            dw = BitWriter()
            enc = SliceDataEncoder(self.params, fd,
                                   Contexts(SLICE_B, qp),
                                   CabacEncoder(dw))
            self._apply_crypto_iv(enc)
            if self.params.tiles_enabled and self.params.wpp:
                sizes = enc.encode_slice_data_tiles_wpp()
            elif self.params.tiles_enabled:
                sizes = enc.encode_slice_data_tiles()
            elif self.params.wpp:
                sizes = enc.encode_slice_data_wpp()
            else:
                enc.encode_slice_data()
                dw.align_zero()
            data = dw.get_bytes()
        w = BitWriter()
        write_slice_header(w, self.params, SLICE_B, nal_type,
                           qp, poc=poc, ref_poc_diff=rpd0,
                           ref_poc_diff_l1=rpd1,
                           num_entry_points=max(len(sizes) - 1, 0),
                           entry_point_offsets=sizes[:-1])
        return nal_unit(w.get_bytes() + data, nal_type)

    def _serialize_p(self, fd, poc, ref_poc_diff, ref_list_l0=None,
                     retained_l0=(), tmvp: bool = False, qp=None):
        qp = self.cfg.qp if qp is None else qp
        nref = 1 if ref_list_l0 is None else len(ref_list_l0)
        if self.params.slices != "none":
            return self._slice_nals(
                fd, SLICE_P, NAL_TRAIL_R,
                dict(poc=poc, ref_poc_diff=ref_poc_diff,
                     ref_list_l0=ref_list_l0, retained_l0=retained_l0,
                     tmvp=tmvp), nref_l0=nref, qp=qp)
        if not self.params.transquant_bypass \
                and self.params.max_tr_depth_intra == 0 \
                and self.params.crypto_key is None \
                and self.params.slices == "none" \
                and not self.params.tiles_enabled:
            # Single-frame path: row-parallel CABAC (the batch paths
            # instead parallelize across frames in the host pool).
            data, sizes = native.encode_slice_data_native_p(
                self.params, fd, qp, self.params.wpp,
                nthreads=self.cfg.threads or 4, nref_l0=nref)
        else:
            sizes = []
            dw = BitWriter()
            enc = SliceDataEncoder(self.params, fd,
                                   Contexts(SLICE_P, qp),
                                   CabacEncoder(dw), nref_l0=nref)
            self._apply_crypto_iv(enc)
            if self.params.tiles_enabled and self.params.wpp:
                sizes = enc.encode_slice_data_tiles_wpp()
            elif self.params.tiles_enabled:
                sizes = enc.encode_slice_data_tiles()
            elif self.params.wpp:
                sizes = enc.encode_slice_data_wpp()
            else:
                enc.encode_slice_data()
                dw.align_zero()
            data = dw.get_bytes()
        w = BitWriter()
        write_slice_header(w, self.params, SLICE_P, NAL_TRAIL_R,
                           qp, poc=poc,
                           ref_poc_diff=ref_poc_diff,
                           ref_list_l0=ref_list_l0,
                           retained_l0=retained_l0, tmvp=tmvp,
                           num_entry_points=max(len(sizes) - 1, 0),
                           entry_point_offsets=sizes[:-1])
        return nal_unit(w.get_bytes() + data, NAL_TRAIL_R)


class IntraFrameEncoder(PFrameMixin):
    """Encodes I- and P-frames for a fixed geometry/config (the name
    is historical; P support lives in PFrameMixin)."""

    def __init__(self, cfg: Config):
        import kvazaar_jax
        kvazaar_jax.enable_compile_cache()
        cfg.validate()
        self.cfg = cfg
        self.chroma = cfg.chroma_format == 420
        # Fixed-grid CU size (the variable-quadtree path schedules its
        # own per-size plans; 64x64 CUs reconstruct as 32x32 TBs so
        # the working granularity caps at 32).
        self.cu = min(cfg.intra_max_cu, 32)
        self.bitdepth = cfg.input_bitdepth
        # cu = 4 is the intra-NxN operating point: 8x8 CUs coded
        # PART_NxN with four 4x4 PUs/TUs (DST-VII luma) — luma runs on
        # a 4x4-granularity plan, chroma keeps one 4x4 TB per CU on an
        # 8x8-granularity plan (reference NxN search
        # src/search_intra.c:189 + intra CU src/encode_coding_tree.c:683).
        pad = max(self.cu, 8)
        self.coded_w = -(-cfg.width // pad) * pad
        self.coded_h = -(-cfg.height // pad) * pad
        self.tiles = (cfg.tiles_x, cfg.tiles_y)
        self.plan_c = None
        if self.cu == 4:
            self.plan = make_intra_plan(self.coded_w, self.coded_h, 4,
                                        chroma=False)
            if self.chroma:
                self.plan_c = make_intra_plan(self.coded_w,
                                              self.coded_h, 8, True)
        else:
            self.plan = make_intra_plan(self.coded_w, self.coded_h,
                                        self.cu, self.chroma,
                                        tiles=self.tiles)
        if cfg.lossless:
            # Deblocking would break bit-exactness of bypass blocks;
            # the reference's --lossless implies the same choice.
            cfg.deblock = False
        self.scaling = None
        _sl_mode = 0
        _sl_custom = None
        if cfg.scaling_list != "off":
            from kvazaar_jax.ops.scaling import (ScalingLists,
                                                 parse_cqmfile)
            if cfg.scaling_list == "custom":
                self.scaling = parse_cqmfile(cfg.cqmfile)
                _sl_mode = 1
                _sl_custom = (self.scaling.custom, self.scaling.dc)
            else:
                self.scaling = ScalingLists("default")
                _sl_mode = 2
        _ckey = None
        if cfg.crypto is not None:
            from kvazaar_jax.bitstream.crypto import key_from_string
            _ckey = key_from_string(cfg.crypto)
        self.params = StreamParams(
            width=self.coded_w, height=self.coded_h,
            bitdepth=self.bitdepth,
            chroma_format_idc=1 if self.chroma else 0,
            qp=cfg.qp,
            deblock_enabled=cfg.deblock,
            sao_enabled=cfg.sao,
            transquant_bypass=cfg.lossless,
            implicit_rdpcm=cfg.implicit_rdpcm,
            transform_skip=cfg.transform_skip,
            cu_qp_delta=cfg.cu_qp_delta_active,
            slices=cfg.slices,
            source_scan_type=cfg.source_scan_type,
            sign_hiding=cfg.signhide and not cfg.lossless,
            wpp=cfg.wpp,
            conf_win=(0, self.coded_w - cfg.width, 0,
                      self.coded_h - cfg.height),
            scaling_list_mode=_sl_mode,
            scaling_custom=_sl_custom,
            tmvp_enabled=cfg.tmvp,
            amp=cfg.amp,
            max_tr_depth_intra=cfg.tr_depth_intra,
            crypto_key=_ckey,
            tiles=self.tiles,
            framerate=(cfg.framerate_num, cfg.framerate_denom),
            sar=(cfg.sar_width, cfg.sar_height),
            overscan=cfg.overscan, videoformat=cfg.videoformat,
            fullrange=cfg.fullrange, colorprim=cfg.colorprim,
            transfer=cfg.transfer, colormatrix=cfg.colormatrix,
            chroma_loc=cfg.chromaloc,
            tier=1 if cfg.tier == "high" else 0,
            level_idc=int(round(float(cfg.level) * 30))
            if cfg.level is not None else compute_level_idc(
                self.coded_w, self.coded_h,
                cfg.framerate_num / max(cfg.framerate_denom, 1)))
        self.qp_c = chroma_qp(cfg.qp)
        lam = qp_to_lambda(cfg.qp)
        self.lambda_satd = math.sqrt(lam)
        # Batched path: frames are independent in all-intra coding, so a
        # leading frame axis is the natural throughput dimension (the
        # analogue of the reference's OWF frame pipelining,
        # src/encoderstate.c:790-806, recast as data parallelism).  The
        # batch axis is native through the wavefront scan (vmap-of-scan
        # produces pathological layouts) and all outputs the host needs
        # every frame come back as ONE packed uint8 buffer: transfer
        # call count and volume were design targets for the slow host
        # link this was written for (int8 levels; dense int16 kept on
        # device as a rare low-QP overflow fallback).
        self._device_encode_batch = jax.jit(self._device_encode_impl)
        # Per-picture selective-encryption nonce (stream order; crypto
        # configs run the sequential emission path so this counter
        # matches the decoder's picture count).
        self._crypto_seq = 0
        # Per-picture selective-encryption nonce counter (stream
        # order; crypto configs run the sequential emission path).
        self._crypto_seq = 0
        self._host_pool = None
        self._dpb = None
        self._setup_p()

    def headers(self) -> bytes:
        return (write_vps(self.params) + write_sps(self.params)
                + write_pps(self.params))

    def set_base_qp(self, qp: int) -> None:
        """Re-point the encoder at a new base QP without recompiling.

        Valid on the variable-tree operating point without custom
        scaling lists: there QP and lambda ride every device program
        as traced data (search, recon, SAO, deblock qp_map), so the
        same executables serve the new QP.  Fixed-grid jits bake QP at
        trace time and are dropped here to rebuild lazily.  The
        reference re-creates the whole encoder per QP
        (kvz_encoder_open, src/encoder.c); reuse matters here because
        program compilation is minutes, e.g. across a BD-rate ladder."""
        self.cfg = dataclasses.replace(self.cfg, qp=qp)
        self.params.qp = qp          # PPS init_qp / slice_qp_delta base
        self.qp_c = chroma_qp(qp)
        lam = qp_to_lambda(qp)
        self.lambda_satd = math.sqrt(lam)
        # QP-static compiled paths (fixed grids, per-QP fused P
        # programs, rd3 chroma RDO) rebuild on next use.
        self._device_encode_batch = jax.jit(self._device_encode_impl)
        for attr in ("_p_fused_cache", "_cm_search", "_stack_cache",
                     "_packed_fns"):
            if hasattr(self, attr):
                getattr(self, attr).clear()

    def _apply_crypto_iv(self, enc) -> None:
        """Fresh per-picture CTR nonce for selective encryption (the
        decoder counts pictures in stream order)."""
        if self.params.crypto_key is None:
            return
        enc.set_crypto_iv(self._crypto_seq)
        self._crypto_seq += 1

    def _split_sources(self, buf):
        """Inverse of the host-side single-buffer concat: (B, bytes)
        uint8 -> (ys, cbs, crs) int32 planes (bitcast for >8-bit)."""
        b = buf.shape[0]
        s = max(self.cu, 8)
        h, w = self.coded_h, self.coded_w
        hc = -(-h // 2 // (s // 2)) * (s // 2) if self.chroma else 0
        wc = -(-w // 2 // (s // 2)) * (s // 2) if self.chroma else 0
        unit = 2 if self.bitdepth > 8 else 1

        def take(off, n, hh, ww):
            part = jax.lax.slice(buf, (0, off), (b, off + n * unit))
            if unit == 2:
                part = jax.lax.bitcast_convert_type(
                    part.reshape(b, n, 2), jnp.uint16)
            return part.reshape(b, hh, ww).astype(jnp.int32)

        ys = take(0, h * w, h, w)
        cbs = crs = None
        if self.chroma:
            cbs = take(h * w * unit, hc * wc, hc, wc)
            crs = take((h * w + hc * wc) * unit, hc * wc, hc, wc)
        return ys, cbs, crs

    def _device_encode_impl(self, buf):
        """Batched device program: ONE (B, bytes) uint8 source buffer
        in, (head, payload) compacted transfer buffers + on-device
        recon/dense-levels out (see ops/xfer.py for the link model)."""
        ys, cbs, crs = self._split_sources(buf)
        return self._encode_from_planes(ys, cbs, crs)

    def _src_plane_shapes(self, b: int):
        """Batch-stacked (rows, width) per plane for the delta pack."""
        s = max(self.cu, 8)
        h, w = self.coded_h, self.coded_w
        shapes = [(b * h, w)]
        if self.chroma:
            hc = -(-h // 2 // (s // 2)) * (s // 2)
            wc = -(-w // 2 // (s // 2)) * (s // 2)
            shapes += [(b * hc, wc)] * 2
        return shapes

    def _device_encode_packed_impl(self, buf, b: int):
        """Delta-packed source variant (ops/xfer.py source pack),
        written for a slow host->device link; whether it pays on PCIe
        is not measured."""
        from kvazaar_jax.ops.xfer import unpack_source_device
        shapes = self._src_plane_shapes(b)
        total = sum(r * w for r, w in shapes)
        planes = unpack_source_device(buf, total, shapes)
        h, w = self.coded_h, self.coded_w
        ys = planes[0].reshape(b, h, w)
        cbs = crs = None
        if self.chroma:
            rc, wc = shapes[1]
            cbs = planes[1].reshape(b, rc // b, wc)
            crs = planes[2].reshape(b, rc // b, wc)
        return self._encode_from_planes(ys, cbs, crs)

    def _pack_sources_delta(self, frames):
        """Host side of the packed upload; None -> raw fallback."""
        from kvazaar_jax.ops.xfer import pack_source_host
        s = max(self.cu, 8)
        ys = np.stack([pad_to_multiple(np.asarray(f[0], np.uint8), s)
                       for f in frames])
        b = len(frames)
        planes = [ys.reshape(-1, ys.shape[2])]
        cbs = crs = None
        if self.chroma:
            cbs = np.stack([pad_to_multiple(np.asarray(f[1], np.uint8),
                                            s // 2) for f in frames])
            crs = np.stack([pad_to_multiple(np.asarray(f[2], np.uint8),
                                            s // 2) for f in frames])
            planes += [cbs.reshape(-1, cbs.shape[2]),
                       crs.reshape(-1, crs.shape[2])]
        buf = pack_source_host(planes)
        if buf is None:
            return None
        return buf, (ys, cbs, crs)

    def _encode_from_planes(self, ys, cbs, crs):
        modes = jax.vmap(
            lambda y: search_frame_modes(
                y, self.plan, self.lambda_satd, self.bitdepth,
                self.cfg.rd >= 1, rdo=self.cfg.rd >= 2,
                qp=self.cfg.qp,
                lam_rd=qp_to_lambda(self.cfg.qp))[0])(ys)
        ts_y = cmodes = None
        if self.cu == 4:
            # Split planes: luma on the 4x4 plan, chroma (one 4x4 TB
            # per 8x8 CU, DM mode of PU0) on the 8x8 plan.
            out = reconstruct_frames(
                ys, None, None, modes, self.plan, self.cfg.qp,
                self.qp_c, self.bitdepth, lossless=self.cfg.lossless,
                signhide=self.cfg.signhide, rdoq=self.cfg.rdoq,
                lam=qp_to_lambda(self.cfg.qp), scaling=self.scaling,
                tskip=self.cfg.transform_skip)
            rec_y, lv_y = out[0], out[1]
            if self.cfg.transform_skip:
                ts_y = out[6]
            rec_cb = lv_cb = rec_cr = lv_cr = None
            if self.chroma:
                from kvazaar_jax.encoder.intra_recon import \
                    reconstruct_chroma_frames
                rec_cb, lv_cb, rec_cr, lv_cr = \
                    reconstruct_chroma_frames(
                        cbs, crs, modes[:, ::2, ::2], self.plan_c,
                        self.qp_c, self.bitdepth,
                        lossless=self.cfg.lossless,
                        signhide=self.cfg.signhide, rdoq=self.cfg.rdoq,
                        lam=qp_to_lambda(self.cfg.qp),
                        scaling=self.scaling)
        else:
            if self.cfg.rd >= 3 and self.chroma:
                # --rd 3: explicit chroma-mode RDO (open-loop roundtrip
                # over the 5 Table 8-3 candidates per CU).
                from kvazaar_jax.encoder.intra_search import \
                    search_chroma_modes
                cmodes = jax.vmap(
                    lambda cb_, cr_, m_: search_chroma_modes(
                        cb_, cr_, m_, self.plan, self.qp_c,
                        qp_to_lambda(self.cfg.qp),
                        self.bitdepth))(cbs, crs, modes)
            (rec_y, lv_y, rec_cb, lv_cb, rec_cr,
             lv_cr) = reconstruct_frames(
                ys, cbs, crs, modes, self.plan, self.cfg.qp, self.qp_c,
                self.bitdepth, lossless=self.cfg.lossless,
                signhide=self.cfg.signhide, rdoq=self.cfg.rdoq,
                lam=qp_to_lambda(self.cfg.qp), scaling=self.scaling,
                cmodes=cmodes, rdpcm=self.cfg.implicit_rdpcm)
        if self.cfg.deblock:
            # In-loop filter as a batched post-pass: intra prediction
            # reads unfiltered samples (spec 8.4.4.2.1), so deblocking
            # never feeds the wavefront.
            rdt = rec_y.dtype
            # Deblocking only filters the 8x8 edge grid (8.7.2): the
            # intra-NxN point's 4x4 TU edges are never filtered, so its
            # boundary grid is the 8x8 CU grid.
            dcu = max(self.cu, 8)
            dy, dcb, dcr = jax.vmap(
                lambda a, b, c: deblock_frame(a, b, c, self.cfg.qp,
                                              dcu, self.bitdepth)
            )(rec_y, rec_cb, rec_cr) if self.chroma else (
                jax.vmap(lambda a: deblock_frame(a, None, None,
                                                 self.cfg.qp, dcu,
                                                 self.bitdepth)[0])(rec_y),
                None, None)
            rec_y = dy.astype(rdt)
            if rec_cb is not None:
                rec_cb = dcb.astype(rdt)
                rec_cr = dcr.astype(rdt)

        # Distortion on-device: 3 scalars/frame ride the packed buffer
        # instead of full reconstruction planes.  Measured over the
        # conformance window only — padded rows/columns reconstruct
        # near-perfectly and would inflate PSNR.
        tw, th = self.cfg.width, self.cfg.height

        def sse(a, b):
            f = a.shape[1] * 2 // self.coded_h     # 2=luma, 1=chroma
            hh, ww = th * f // 2, tw * f // 2
            d = (a[:, :hh, :ww].astype(jnp.float32)
                 - b[:, :hh, :ww].astype(jnp.float32))
            return jnp.sum(d * d, axis=(1, 2))

        sses = jnp.stack(
            [sse(rec_y, ys),
             sse(rec_cb, cbs) if cbs is not None else
             jnp.zeros(ys.shape[0], jnp.float32),
             sse(rec_cr, crs) if crs is not None else
             jnp.zeros(ys.shape[0], jnp.float32)], axis=1)  # (B, 3)
        packed = self._pack_outputs(lv_y, lv_cb, lv_cr, modes, sses,
                                    ts_y, cmodes)
        dense = tuple(None if lv is None else lv.astype(jnp.int16)
                      for lv in (lv_y, lv_cb, lv_cr))
        return packed, dense, (rec_y, rec_cb, rec_cr)

    def _level_sizes(self, nframes: int):
        """Per-frame byte layout of the flat level buffer + head."""
        s = self.cu
        nb = self.plan.blocks_y * self.plan.blocks_x
        cs = s // 2
        nbc = nb
        if s == 4:
            cs = 4                       # one 4x4 chroma TB per 8x8 CU
            nbc = (self.plan_c.blocks_y * self.plan_c.blocks_x
                   if self.plan_c else 0)
        lv_sizes = [nb * s * s]
        if self.chroma:
            lv_sizes += [nbc * cs * cs] * 2
        return s, nb, cs, nbc, lv_sizes

    def _pack_outputs(self, lv_y, lv_cb, lv_cr, modes, sses,
                      ts_y=None, cmodes=None):
        """One transfer buffer (see ops/xfer.py): [nibbles][escape
        records][modes u8][tskip u8][cmodes u8][meta: esc i32,
        sse (B,3) f32]."""
        from kvazaar_jax.ops.xfer import pack_levels
        b = modes.shape[0]
        u8 = lambda x: jax.lax.bitcast_convert_type(x, jnp.uint8)
        lvs = [lv.astype(jnp.int16).reshape(b, -1)
               for lv in (lv_y, lv_cb, lv_cr) if lv is not None]
        flat = jnp.concatenate(lvs, axis=1).reshape(-1)
        nib, esc, esc_count = pack_levels(flat, self.cfg.qp)
        parts = [nib, esc, modes.astype(jnp.uint8).reshape(-1)]
        if ts_y is not None:
            parts.append(ts_y.astype(jnp.uint8).reshape(-1))
        if cmodes is not None:
            parts.append(cmodes.astype(jnp.uint8).reshape(-1))
        parts.append(u8(esc_count[None]).reshape(-1))
        parts.append(u8(sses).reshape(-1))
        return jnp.concatenate(parts)

    def _unpack_batch(self, buf: np.ndarray, nframes: int):
        """Parse the packed buffer -> (levels_flat | None, modes, ts_y,
        cmodes, sses); levels_flat is None when the escape capacity
        overflowed (caller uses the dense fallback)."""
        from kvazaar_jax.ops import xfer
        s, nb, cs, nbc, lv_sizes = self._level_sizes(nframes)
        total = nframes * sum(lv_sizes)
        cap = xfer.esc_capacity(total, self.cfg.qp)
        has_ts = self.cfg.transform_skip and s == 4
        has_cm = self.cfg.rd >= 3 and self.chroma and s > 4
        sizes = [(total + 1) // 2, cap * 8, nframes * nb] \
            + ([nframes * nb] if has_ts else []) \
            + ([nframes * nb] if has_cm else []) + [4, nframes * 12]
        offs = np.cumsum([0] + sizes)
        nib = buf[offs[0]:offs[1]]
        esc = buf[offs[1]:offs[2]]
        modes = buf[offs[2]:offs[3]].reshape(
            nframes, self.plan.blocks_y, self.plan.blocks_x)
        k = 3
        ts_y = None
        if has_ts:
            ts_y = buf[offs[k]:offs[k + 1]].reshape(
                nframes, self.plan.blocks_y, self.plan.blocks_x)
            k += 1
        cmodes = None
        if has_cm:
            cmodes = buf[offs[k]:offs[k + 1]].reshape(
                nframes, self.plan.blocks_y, self.plan.blocks_x)
            k += 1
        esc_count = int(buf[offs[k]:offs[k + 1]].copy()
                        .view(np.int32)[0])
        sses = buf[offs[k + 1]:].copy().view(np.float32).reshape(
            nframes, 3)
        flat = None
        if esc_count <= cap:
            flat = xfer.unpack_levels(nib, esc, esc_count, total)
        return flat, modes, ts_y, cmodes, sses

    def _levels_from_flat(self, flat: np.ndarray, nframes: int):
        """Flat per-batch level bytes -> per-plane (B, n, s, s) views."""
        s, nb, cs, nbc, lv_sizes = self._level_sizes(nframes)
        buf = flat.reshape(nframes, sum(lv_sizes))
        offs = np.cumsum([0] + lv_sizes)
        out_lv = []
        k = 0
        for _ in range(3 if self.chroma else 1):
            size, n = (s, nb) if k == 0 else (cs, nbc)
            out_lv.append(buf[:, offs[k]:offs[k + 1]].reshape(
                nframes, n, size, size))
            k += 1
        while len(out_lv) < 3:
            out_lv.append(None)
        return out_lv

    def encode_frame(self, y: np.ndarray, cb=None, cr=None,
                     qp_ctu=None, nal_type=None,
                     poc: int = 0) -> FrameResult:
        """y: (H, W) source luma (uint8/uint16); cb/cr half size.
        qp_ctu: optional (Cy, Cx) int32 per-CTU QP map (LCU rate
        control / ROI / AQ); routes through the traced-QP program +
        cu_qp_delta syntax.  nal_type/poc: IRAP override for open-GOP
        intra pictures (CRA_NUT codes its POC; default IDR at 0,
        reference NAL-type logic src/encoderstate.c:1171-1272)."""
        self._islice_ctx = (nal_type, poc) if nal_type is not None \
            else None
        try:
            if self.cfg.mesh_tiles > 1:
                return self.encode_frame_mesh(y, cb, cr)
            if qp_ctu is not None:
                return self.encode_frame_qp(y, cb, cr, qp_ctu)
            if self.cfg.intra_min_cu < self.cfg.intra_max_cu:
                return self.encode_frame_var(y, cb, cr)
            return self.finalize_frames(
                self.submit_frames([(y, cb, cr)]))[0]
        finally:
            self._islice_ctx = None

    def encode_frame_mesh(self, y, cb=None, cr=None) -> FrameResult:
        """Multi-device end-to-end encode: the frame's tile-row bands
        are sharded over a (mesh_tiles,) device mesh — per-band search
        + wavefront recon with zero communication (tiles cut every
        dependency) and a ppermute halo-exchanged deblocking filter —
        then per-tile CABAC substreams splice into ONE bitstream,
        byte-identical to the single-device (tiles_x, mesh_tiles)
        encode (the device form of the reference's tile threads +
        kvz_bitstream_move, src/encoderstate.c:860-965)."""
        if not hasattr(self, "_mesh_prog"):
            from jax.sharding import Mesh
            from kvazaar_jax.parallel.sharding import \
                encode_frame_bands_sharded
            n = self.cfg.mesh_tiles
            devs = jax.devices()
            if len(devs) < n:
                raise RuntimeError(
                    f"mesh_tiles={n} needs {n} devices; "
                    f"{len(devs)} visible")
            mesh = Mesh(np.array(devs[:n]), ("bands",))

            def prog(yp, cbp, crp):
                return encode_frame_bands_sharded(
                    yp, cbp, crp, self.cfg.qp, self.qp_c,
                    self.lambda_satd, mesh, self.cu,
                    tiles_x=self.cfg.tiles_x, bitdepth=self.bitdepth,
                    two_pass=self.cfg.rd >= 1,
                    signhide=self.cfg.signhide, rdoq=self.cfg.rdoq,
                    lam=qp_to_lambda(self.cfg.qp),
                    deblock=self.cfg.deblock)

            self._mesh_prog = jax.jit(prog)
        sdt = np.uint8 if self.bitdepth <= 8 else np.uint16
        yp = jnp.asarray(pad_to_multiple(np.asarray(y, sdt), self.cu))
        cbp = crp = None
        if self.chroma:
            cbp = jnp.asarray(pad_to_multiple(np.asarray(cb, sdt),
                                              self.cu // 2))
            crp = jnp.asarray(pad_to_multiple(np.asarray(cr, sdt),
                                              self.cu // 2))
        (modes, lv_y, lv_cb, lv_cr, rec_y, rec_cb,
         rec_cr) = self._mesh_prog(yp, cbp, crp)
        self._dpb = (rec_y, rec_cb, rec_cr)
        return self._host_finalize(
            np.asarray(modes),
            np.asarray(lv_y).astype(np.int32),
            None if lv_cb is None else np.asarray(lv_cb).astype(
                np.int32),
            None if lv_cr is None else np.asarray(lv_cr).astype(
                np.int32),
            np.asarray(rec_y),
            None if rec_cb is None else np.asarray(rec_cb),
            None if rec_cr is None else np.asarray(rec_cr))

    def _device_encode_qp_impl(self, ys, cbs, crs, qp_ctu):
        """Traced-QP variant of _device_encode_impl (single or batched
        frames; qp_ctu: (B, Cy, Cx) int32).  Returns dense outputs —
        this path serves rate-controlled encodes where correctness,
        not the packed-transfer fast path, is the target."""
        ys = ys.astype(jnp.int32)
        if cbs is not None:
            cbs = cbs.astype(jnp.int32)
            crs = crs.astype(jnp.int32)
        modes = jax.vmap(
            lambda y: search_frame_modes(
                y, self.plan, self.lambda_satd, self.bitdepth,
                self.cfg.rd >= 1, rdo=self.cfg.rd >= 2,
                qp=self.cfg.qp,
                lam_rd=qp_to_lambda(self.cfg.qp))[0])(ys)
        cmodes = None
        if self.cfg.rd >= 3 and self.chroma:
            from kvazaar_jax.encoder.intra_search import \
                search_chroma_modes
            cmodes = jax.vmap(
                lambda cb_, cr_, m_: search_chroma_modes(
                    cb_, cr_, m_, self.plan, self.qp_c,
                    qp_to_lambda(self.cfg.qp),
                    self.bitdepth))(cbs, crs, modes)
        qp_blk = self._qp_blk_of(qp_ctu)
        (rec_y, lv_y, rec_cb, lv_cb, rec_cr,
         lv_cr) = reconstruct_frames(
            ys, cbs, crs, modes, self.plan, self.cfg.qp, self.qp_c,
            self.bitdepth, lossless=self.cfg.lossless,
            signhide=self.cfg.signhide, rdoq=self.cfg.rdoq,
            lam=qp_to_lambda(self.cfg.qp), scaling=self.scaling,
            qp_map=qp_blk, cmodes=cmodes)
        eff = self._effective_qp_ctu(
            qp_ctu, self._cbf_ctu_of(lv_y, lv_cb, lv_cr))
        if self.cfg.deblock:
            rdt = rec_y.dtype
            dqp_blk = self._qp_blk_of(eff)
            dcu = max(self.cu, 8)
            if self.chroma:
                dy, dcb, dcr = jax.vmap(
                    lambda a, b, c, q: deblock_frame(
                        a, b, c, self.cfg.qp, dcu, self.bitdepth,
                        qp_map=q))(rec_y, rec_cb, rec_cr, dqp_blk)
                rec_cb, rec_cr = dcb.astype(rdt), dcr.astype(rdt)
            else:
                dy = jax.vmap(
                    lambda a, q: deblock_frame(
                        a, None, None, self.cfg.qp, dcu, self.bitdepth,
                        qp_map=q)[0])(rec_y, dqp_blk)
            rec_y = dy.astype(rdt)
        return modes, cmodes, (lv_y, lv_cb, lv_cr), (rec_y, rec_cb,
                                                     rec_cr)

    def encode_frame_qp(self, y, cb=None, cr=None,
                        qp_ctu=None) -> FrameResult:
        """Intra frame with a per-CTU QP map (the LCU rate-control
        operating point, reference kvz_set_lcu_lambda_and_qp
        src/rate_control.c:278 + per-LCU allocation :259)."""
        if not hasattr(self, "_device_encode_qp"):
            self._device_encode_qp = jax.jit(self._device_encode_qp_impl)
        s = max(self.cu, 8)
        sdt = np.uint8 if self.bitdepth <= 8 else np.uint16
        ys = pad_to_multiple(np.asarray(y, sdt), s)[None]
        cbs = crs = None
        if self.chroma:
            cbs = pad_to_multiple(np.asarray(cb, sdt), s // 2)[None]
            crs = pad_to_multiple(np.asarray(cr, sdt), s // 2)[None]
        qarr = np.asarray(qp_ctu, np.int32)[None]
        modes, cmodes, lvs, recs = self._device_encode_qp(
            ys, cbs, crs, jnp.asarray(qarr))
        sao = None
        if self.cfg.sao:
            recs, sao_list = self._sao_stage((ys, cbs, crs), recs)
            sao = sao_list[0]
        self._dpb = (recs[0][0],
                     recs[1][0] if self.chroma else None,
                     recs[2][0] if self.chroma else None)
        rec_y = np.asarray(recs[0][0])
        rec_cb = np.asarray(recs[1][0]) if self.chroma else None
        rec_cr = np.asarray(recs[2][0]) if self.chroma else None
        return self._host_finalize(
            np.asarray(modes[0]), np.asarray(lvs[0][0], np.int32),
            None if not self.chroma else np.asarray(lvs[1][0], np.int32),
            None if not self.chroma else np.asarray(lvs[2][0], np.int32),
            rec_y, rec_cb, rec_cr, sao=sao,
            qp_ctu=np.asarray(qp_ctu, np.int32),
            cmodes=None if cmodes is None else np.asarray(cmodes[0]))

    # ---- SAO stage (ops/sao.py): runs after deblock on the device
    # recon; params chosen on host from device statistics. ----

    def _sao_fns(self):
        if not hasattr(self, "_sao_jit"):
            from kvazaar_jax.ops.sao import apply_sao_plane, sao_stats

            def stats(ys, recs_y, cbs, recs_cb, crs, recs_cr):
                s_y = jax.vmap(lambda o, r: sao_stats(
                    o.astype(jnp.int32), r.astype(jnp.int32), 64,
                    self.bitdepth))(ys, recs_y)
                arrs = list(s_y)
                if cbs is not None:
                    s_cb = jax.vmap(lambda o, r: sao_stats(
                        o.astype(jnp.int32), r.astype(jnp.int32), 32,
                        self.bitdepth))(cbs, recs_cb)
                    s_cr = jax.vmap(lambda o, r: sao_stats(
                        o.astype(jnp.int32), r.astype(jnp.int32), 32,
                        self.bitdepth))(crs, recs_cr)
                    arrs += list(s_cb) + list(s_cr)
                # ONE packed buffer: one download call instead of 12
                # small ones.  Shapes recorded at trace time.
                self._sao_stat_meta = [a.shape[1:] for a in arrs]
                b = arrs[0].shape[0]
                return jnp.concatenate(
                    [a.reshape(b, -1) for a in arrs], axis=1)

            def apply(recs_y, recs_cb, recs_cr, t, eo, bp, off):
                ay = jax.vmap(lambda r, t_, e_, b_, o_: apply_sao_plane(
                    r, t_[:, :, 0], e_[:, :, 0], b_[:, :, 0],
                    o_[:, :, 0], 64, self.bitdepth))(recs_y, t, eo, bp,
                                                     off)
                if recs_cb is None:
                    return ay, None, None
                acb = jax.vmap(lambda r, t_, e_, b_, o_: apply_sao_plane(
                    r, t_[:, :, 1], e_[:, :, 1], b_[:, :, 1],
                    o_[:, :, 1], 32, self.bitdepth))(recs_cb, t, eo, bp,
                                                     off)
                acr = jax.vmap(lambda r, t_, e_, b_, o_: apply_sao_plane(
                    r, t_[:, :, 1], e_[:, :, 1], b_[:, :, 2],
                    o_[:, :, 2], 32, self.bitdepth))(recs_cr, t, eo, bp,
                                                     off)
                return ay, acb, acr

            self._sao_jit = (jax.jit(stats), jax.jit(apply))
        return self._sao_jit

    def _sao_device_fn(self):
        """Fused device SAO: stats + greedy-merge decide + apply in
        ONE program — no host sync in the submit path (the host decide
        round-trip serialized the GOP pipeline; see
        ops/sao.py sao_decide_frame_device)."""
        if hasattr(self, "_sao_dev_jit"):
            return self._sao_dev_jit
        from kvazaar_jax.ops.sao import (apply_sao_plane,
                                         sao_decide_frame_device,
                                         sao_stats)
        bd = self.bitdepth

        def one(o_y, r_y, o_cb, r_cb, o_cr, r_cr, lam):
            s_y = sao_stats(o_y.astype(jnp.int32),
                            r_y.astype(jnp.int32), 64, bd)
            stats_c = None
            if o_cb is not None:
                s_cb = sao_stats(o_cb.astype(jnp.int32),
                                 r_cb.astype(jnp.int32), 32, bd)
                s_cr = sao_stats(o_cr.astype(jnp.int32),
                                 r_cr.astype(jnp.int32), 32, bd)
                stats_c = (s_cb, s_cr)
            p = sao_decide_frame_device(s_y, stats_c, lam)
            t, eo, bp, off = p["type"], p["eo"], p["bp"], p["off"]
            ay = apply_sao_plane(r_y, t[:, :, 0], eo[:, :, 0],
                                 bp[:, :, 0], off[:, :, 0], 64, bd)
            acb = acr = None
            if o_cb is not None:
                acb = apply_sao_plane(r_cb, t[:, :, 1], eo[:, :, 1],
                                      bp[:, :, 1], off[:, :, 1], 32,
                                      bd)
                acr = apply_sao_plane(r_cr, t[:, :, 1], eo[:, :, 1],
                                      bp[:, :, 2], off[:, :, 2], 32,
                                      bd)
            cy, cx = t.shape[:2]
            packed = jnp.concatenate(
                [p["merge"][:, :, None], t, eo, bp,
                 off.reshape(cy, cx, 12)], axis=-1)   # (cy, cx, 20)
            return ay, acb, acr, packed

        def run(ys, recs_y, cbs, recs_cb, crs, recs_cr, lam):
            if cbs is None:
                return jax.vmap(
                    lambda a, b, l: one(a, b, None, None, None, None,
                                        l),
                    in_axes=(0, 0, None))(ys, recs_y, lam)
            return jax.vmap(one, in_axes=(0, 0, 0, 0, 0, 0, None))(
                ys, recs_y, cbs, recs_cb, crs, recs_cr, lam)

        self._sao_dev_jit = jax.jit(run)
        return self._sao_dev_jit

    def _sao_stage(self, srcs, recs, lam=None):
        """Search + apply SAO for a batch.  Returns (new recs,
        per-frame params for the serializer — a list of dicts on the
        tiles path, a _LazySaoParams (deferred one-buffer download)
        on the device path).  lam: per-frame lambda override (GOP
        layer lambdas)."""
        from kvazaar_jax.ops.sao import sao_decide_frame
        ys, cbs, crs = srcs
        if lam is None:
            lam = qp_to_lambda(self.cfg.qp)
        if not self.params.tiles_enabled:
            fn = self._sao_device_fn()
            ay, acb, acr, packed = fn(
                jnp.asarray(ys), recs[0],
                None if cbs is None else jnp.asarray(cbs), recs[1],
                None if crs is None else jnp.asarray(crs), recs[2],
                jnp.float32(lam))
            return (ay, acb, acr), _LazySaoParams(packed)
        stats_fn, apply_fn = self._sao_fns()
        packed = stats_fn(
            jnp.asarray(ys), recs[0],
            None if cbs is None else jnp.asarray(cbs), recs[1],
            None if crs is None else jnp.asarray(crs), recs[2])
        buf = np.asarray(packed)            # one D2H transfer
        arrs = []
        off = 0
        for shp in self._sao_stat_meta:
            n = int(np.prod(shp))
            arrs.append(buf[:, off:off + n].reshape((-1,) + tuple(shp)))
            off += n
        s_y, s_cb, s_cr = arrs[:4], None, None
        if cbs is not None:
            s_cb, s_cr = arrs[4:8], arrs[8:12]
        nframes = ys.shape[0]
        sao_list = []
        t_all, eo_all, bp_all, off_all = [], [], [], []
        for i in range(nframes):
            st_y = [a[i] for a in s_y]
            st_c = None
            if s_cb is not None:
                st_c = ([a[i] for a in s_cb], [a[i] for a in s_cr])
            tcol = trow = None
            if self.params.tiles_enabled:
                cbx = self.plan.tile_col_bounds
                cby = self.plan.tile_row_bounds
                tcol = np.searchsorted(
                    cbx[1:], np.arange(self.params.width_in_ctus),
                    "right")
                trow = np.searchsorted(
                    cby[1:], np.arange(self.params.height_in_ctus),
                    "right")
            p = sao_decide_frame(st_y, st_c, lam, tile_col=tcol,
                                 tile_row=trow)
            sao_list.append(p)
            t_all.append(p["type"])
            eo_all.append(p["eo"])
            bp_all.append(p["bp"])
            off_all.append(p["off"])
        new_recs = apply_fn(recs[0], recs[1], recs[2],
                            jnp.asarray(np.stack(t_all)),
                            jnp.asarray(np.stack(eo_all)),
                            jnp.asarray(np.stack(bp_all)),
                            jnp.asarray(np.stack(off_all)))
        return new_recs, sao_list

    # ---- Variable-CU quadtree path (encoder/quadtree.py) ----

    @functools.lru_cache(maxsize=8)
    def _var_recon_fn(self, n_steps: int):
        from kvazaar_jax.encoder.quadtree import reconstruct_frame_var

        def run(sched, dc):
            from kvazaar_jax.ops.devconst import bound
            with bound(dc):
                return run_inner(sched)

        def run_inner(sched):
            # Base QP / lambda ride the schedule as traced data when
            # no scaling lists bake qp%6 tables into constants: ONE
            # compiled program serves every stream QP (reference
            # re-inits per stream; recompiling per QP costs minutes
            # and defeats encoder reuse across QPs, e.g. the BD-rate
            # ladder).  Mirrors the inter recon path above.
            if self.scaling is None and "qp" in sched:
                from kvazaar_jax.constants import CHROMA_QP_TAB
                qp = sched["qp"]
                qp_c = jnp.take(
                    jnp.asarray(np.asarray(CHROMA_QP_TAB, np.int32)),
                    jnp.clip(qp, 0, 51))
                lam = sched["lam"]
                qp_map = jnp.full((self.coded_h // 8,
                                   self.coded_w // 8), qp, jnp.int32)
            else:
                qp, qp_c = self.cfg.qp, self.qp_c
                lam = qp_to_lambda(self.cfg.qp)
                qp_map = None
            rec_y, rec_cb, rec_cr, levels = reconstruct_frame_var(
                sched, qp, qp_c, self.coded_w,
                self.coded_h, self.chroma, self.bitdepth,
                self.cfg.lossless, self.cfg.signhide,
                rdoq=self.cfg.rdoq, lam=lam,
                scaling=self.scaling)
            if self.cfg.deblock:
                dy, dcb, dcr = deblock_frame(
                    rec_y, rec_cb, rec_cr, self.cfg.qp, 8,
                    self.bitdepth, bs_v=sched["bs_v"],
                    bs_h=sched["bs_h"], qp_map=qp_map)
            else:
                dy, dcb, dcr = rec_y, rec_cb, rec_cr
            rdt = jnp.uint8 if self.bitdepth <= 8 else jnp.uint16
            dy = dy.astype(rdt)
            if dcb is not None:
                dcb, dcr = dcb.astype(rdt), dcr.astype(rdt)
            # Levels arrive as pixel-layout planes: one int16 buffer.
            lv_flat = jnp.concatenate(
                [lv.reshape(-1) for lv in levels
                 if lv is not None])
            return dy, dcb, dcr, lv_flat.astype(jnp.int16)

        return jax.jit(run)

    def _var_search_fn(self):
        if not hasattr(self, "_qt_search"):
            from kvazaar_jax.encoder.quadtree import search_quadtree

            def s(yp, qp, lam_satd, lam_rd, dc):
                from kvazaar_jax.ops.devconst import bound
                with bound(dc):
                    outs = search_quadtree(
                        yp, self.coded_w, self.coded_h,
                        lam_satd,
                        self.bitdepth, self.cfg.intra_min_cu,
                        self.cfg.intra_max_cu, self.cfg.rd >= 1,
                        rdo=self.cfg.rd >= 2, qp=qp,
                        lam_rd=lam_rd,
                        tu_split=self.cfg.tr_depth_intra > 0)
                vec, self._qt_search_spec = _pack_device_tree(outs)
                return vec

            self._qt_search = jax.jit(s)
        return self._qt_search

    def encode_frame_var(self, y, cb=None, cr=None) -> FrameResult:
        """Quadtree all-intra encode (variable CU 8/16/32): device
        search at every size + bottom-up argmin, host wavefront
        planning, data-driven device reconstruction (see
        encoder/quadtree.py; matches src/search.c:424-757 capability)."""
        from kvazaar_jax.encoder.var_schedule import build_var_plan
        s = self.cu
        yp = pad_to_multiple(np.asarray(y, np.int32), s)
        cbp = crp = None
        if self.chroma:
            cbp = pad_to_multiple(np.asarray(cb, np.int32), s // 2)
            crp = pad_to_multiple(np.asarray(cr, np.int32), s // 2)
        from kvazaar_jax.encoder.quadtree import choose_tree
        vec = self._var_search_fn()(jnp.asarray(yp),
                                    jnp.int32(self.cfg.qp),
                                    jnp.float32(self.lambda_satd),
                                    jnp.float32(
                                        qp_to_lambda(self.cfg.qp)),
                                    self._var_dconsts())
        unp = _unpack_host_tree(vec, self._qt_search_spec)
        tucosts = None
        if self.cfg.tr_depth_intra > 0:
            costs_d, modes_d, tucosts = unp
            tucosts = {k: np.asarray(v) for k, v in tucosts.items()}
        else:
            costs_d, modes_d = unp
        # Costs are RD units at every rd level (roundtrip recost with
        # per-CU syntax bins inside search_quadtree).
        from kvazaar_jax.encoder.quadtree import SPLIT_FLAG_BINS
        chosen = choose_tree(costs_d, self.coded_w, self.coded_h,
                             qp_to_lambda(self.cfg.qp),
                             percu_bits=0.0,
                             split_bits=SPLIT_FLAG_BINS,
                             tucosts=tucosts)
        trsplit8 = None
        if tucosts is not None:
            size8, trsplit8 = chosen
        else:
            size8 = chosen
        mode_maps = {k: np.asarray(v) for k, v in modes_d.items()}
        # 64x64 CUs reconstruct as four same-mode 32x32 TBs (forced TU
        # split, 7.3.8.8): schedule them as 32-blocks carrying the 64
        # CU's mode; depth8/serialization keep the true tree.
        sched_size8 = np.minimum(size8, 32).astype(size8.dtype)
        if 64 in mode_maps and (size8 == 64).any():
            m32 = mode_maps[32].copy()
            m64 = mode_maps[64]
            up = np.kron(m64, np.ones((2, 2), m32.dtype))
            mask32 = size8[::4, ::4] == 64
            region = m32[:up.shape[0], :up.shape[1]]
            m32[:up.shape[0], :up.shape[1]] = np.where(
                mask32[:up.shape[0], :up.shape[1]], up, region)
            mode_maps = dict(mode_maps)
            mode_maps[32] = m32
        # --tr-depth-intra: a split CU reconstructs as four z-ordered
        # half-size TBs carrying the CU's mode — same recast as the
        # forced 64->32 TB scheduling above.  depth8/trsplit8 keep the
        # true tree for the serializer; sched_size8 becomes the TB
        # node map (which also feeds deblock TU-edge BS, 8.7.2).
        def _patch_children(maps, msk8, s):
            h_ = s // 2
            pm = maps[s]
            up = np.kron(pm, np.ones((2, 2), pm.dtype))
            mch = msk8[::h_ // 8, ::h_ // 8]
            child = maps[h_].copy()
            region = child[:up.shape[0], :up.shape[1]]
            child[:up.shape[0], :up.shape[1]] = np.where(
                mch[:up.shape[0], :up.shape[1]], up, region)
            out = dict(maps)
            out[h_] = child
            return out

        if trsplit8 is not None and trsplit8.any():
            tmask = trsplit8.astype(bool)
            sched_size8 = np.where(tmask, sched_size8 // 2,
                                   sched_size8).astype(size8.dtype)
            for s in (32, 16):
                msk = (size8 == s) & tmask
                if msk.any():
                    mode_maps = _patch_children(mode_maps, msk, s)
        cmode_maps = None
        if self.cfg.rd >= 3 and self.chroma:
            cmode_maps = self._var_chroma_modes(mode_maps, size8, cbp,
                                                crp)
            if trsplit8 is not None and trsplit8.any():
                for s in (32, 16):
                    msk = (size8 == s) & trsplit8.astype(bool)
                    if (msk.any() and s in cmode_maps
                            and s // 2 in cmode_maps):
                        cmode_maps = _patch_children(cmode_maps, msk,
                                                     s)
        vp = build_var_plan(sched_size8, mode_maps, self.coded_w,
                            self.coded_h, self.chroma,
                            cmode_maps=cmode_maps)

        sched, lv_shapes = self._var_sched_arrays(vp, yp, cbp, crp,
                                                  sched_size8)
        if self.scaling is None:
            sched["qp"] = jnp.int32(self.cfg.qp)
            sched["lam"] = jnp.float32(qp_to_lambda(self.cfg.qp))
        dy, dcb, dcr, lv_flat = self._var_recon_fn(
            vp.n_steps)(sched, self._var_dconsts())
        sao = None
        if self.cfg.sao:
            (ry, rcb, rcr), sao_list = self._sao_stage(
                (yp[None],
                 None if cbp is None else cbp[None],
                 None if crp is None else crp[None]),
                (dy[None],
                 None if dcb is None else dcb[None],
                 None if dcr is None else dcr[None]))
            sao = sao_list[0]
            dy = ry[0]
            if self.chroma:
                dcb, dcr = rcb[0], rcr[0]
        self._dpb = (dy, dcb, dcr)
        lv_np = np.asarray(lv_flat)
        rec_y = np.asarray(dy)
        rec_cb = np.asarray(dcb) if self.chroma else None
        rec_cr = np.asarray(dcr) if self.chroma else None

        fd = self._var_frame_data(vp, size8, mode_maps, lv_np,
                                  lv_shapes, sched_size8=sched_size8,
                                  cmode_maps=cmode_maps)
        if trsplit8 is not None:
            fd.trsplit8[:] = trsplit8
        if sao is not None:
            fd.sao_merge[:] = sao["merge"]
            fd.sao_type[:] = sao["type"]
            fd.sao_eo[:] = sao["eo"]
            fd.sao_bp[:] = sao["bp"]
            fd.sao_off[:] = sao["off"]
        return self._var_serialize(fd, rec_y, rec_cb, rec_cr)

    def _var_chroma_modes(self, mode_maps, size8, cbp, crp):
        """--rd 3 over variable trees: per-size-class chroma-mode RDO
        (search_chroma_modes on each size's fixed grid), with 64-CU
        quadrant agreement — a 64 CU signals ONE intra_chroma_pred_mode
        but is scheduled as four 32 entries, so its 2x2 quadrant group
        must share the top-left's choice."""
        from kvazaar_jax.encoder.intra_search import search_chroma_modes
        if not hasattr(self, "_cm_search"):
            self._cm_search = {}
        cmode_maps = {}
        cbj, crj = jnp.asarray(cbp), jnp.asarray(crp)
        for s_ in sorted(mode_maps.keys()):
            if s_ > 32:
                continue
            if s_ not in self._cm_search:
                plan_s = make_intra_plan(self.coded_w, self.coded_h,
                                         s_, chroma=True)
                def cm(cb_, cr_, m_, dc_, _p=plan_s):
                    from kvazaar_jax.ops.devconst import bound
                    with bound(dc_):
                        return search_chroma_modes(
                            cb_, cr_, m_, _p, self.qp_c,
                            qp_to_lambda(self.cfg.qp),
                            self.bitdepth)
                self._cm_search[s_] = jax.jit(cm)
            cmode_maps[s_] = np.asarray(self._cm_search[s_](
                cbj, crj, jnp.asarray(mode_maps[s_]),
                self._var_dconsts()))
        if 32 in cmode_maps and (size8 == 64).any():
            cm = cmode_maps[32]
            tl = np.kron(cm[0::2, 0::2], np.ones((2, 2), cm.dtype))
            mask = np.kron((size8[::4, ::4] == 64),
                           np.ones((2, 2), bool))
            h_, w_ = cm.shape
            cmode_maps[32] = np.where(mask[:h_, :w_], tl[:h_, :w_], cm)
        return cmode_maps

    @functools.lru_cache(maxsize=16)
    def _var_unpack_fn(self, meta):
        """Jitted blob -> sched-pytree unpack (one H2D transfer + one
        dispatch per frame instead of ~50 small array uploads)."""
        def unpack(blob):
            out = {}
            off = 0
            for path, dt, shape in meta:
                dt = np.dtype(dt)
                n = int(np.prod(shape)) * dt.itemsize
                seg = jax.lax.slice(blob, (off,), (off + n,))
                off += n
                if dt.itemsize > 1:
                    arr = jax.lax.bitcast_convert_type(
                        seg.reshape(-1, dt.itemsize),
                        dt).reshape(shape)
                else:
                    arr = seg.reshape(shape)
                    if dt == np.bool_:
                        arr = arr != 0
                d = out
                for k in path[:-1]:
                    d = d.setdefault(k, {})
                d[path[-1]] = arr
            return out

        return jax.jit(unpack)

    def _var_sched_arrays(self, vp, yp, cbp, crp, size8):
        """Upload the var schedule as ONE packed buffer and unpack it
        on device into the sched dict.  Returns (sched dict, level
        shapes in pack order).

        Only compact per-slot metadata + the source planes travel; the
        big gather maps (pix, wr_h/wr_v, idx_h/idx_v/sel_h, cell8) and
        the origs are DERIVED ON DEVICE from (x0, y0, valid, avail)
        instead of the old full-schedule upload (~30 MB, ~50
        calls/frame), the var path's bottleneck on a slow host link."""
        sdt = np.uint8 if self.bitdepth <= 8 else np.uint16
        fields = []     # (path, np array) in a fixed order

        def cls_fields(pl, s, cs):
            fields.extend([
                ((pl, s, "modes"), cs.modes.astype(np.int32)),
                ((pl, s, "avail"), cs.avail.astype(np.uint8)),
                ((pl, s, "corner_h"), cs.corner_h.astype(np.bool_)),
                ((pl, s, "x0"), cs.x0.astype(np.int32)),
                ((pl, s, "y0"), cs.y0.astype(np.int32)),
                ((pl, s, "valid"), cs.valid.astype(np.bool_)),
            ])
            if cs.inter is not None and self._var_inter_active:
                fields.append(((pl, s, "inter"),
                               cs.inter.astype(np.bool_)))

        lv_shapes = []
        for s in sorted(vp.luma.keys()):
            cs = vp.luma[s]
            cls_fields("luma", s, cs)
            lv_shapes.append(("y", s, cs.valid.shape[0],
                             cs.valid.shape[1]))
        if self.chroma:
            for s in sorted(vp.chroma.keys()):
                cls_fields("chroma", s, vp.chroma[s])

        def icls_fields(pl, s, d):
            fields.extend([
                ((pl, s, "x0"), d["x0"].astype(np.int32)),
                ((pl, s, "y0"), d["y0"].astype(np.int32)),
                ((pl, s, "valid"), d["valid"].astype(np.bool_)),
                ((pl, s, "rows"), d["rows"].astype(np.int32)),
            ])
        if vp.iluma is not None:
            for s in sorted(vp.iluma.keys()):
                icls_fields("iluma", s, vp.iluma[s])
            if self.chroma:
                for s in sorted(vp.ichroma.keys()):
                    icls_fields("ichroma", s, vp.ichroma[s])
        fields.append((("plane_y",), np.asarray(yp, sdt)))
        if self.chroma:
            fields.append((("plane_cb",), np.asarray(cbp, sdt)))
            fields.append((("plane_cr",), np.asarray(crp, sdt)))
        if self.chroma:
            for pl in ("cb", "cr"):
                for s in sorted(vp.chroma.keys()):
                    cs = vp.chroma[s]
                    lv_shapes.append((pl, s, cs.valid.shape[0],
                                      cs.valid.shape[1]))
        if vp.iluma is not None:
            # Direct-pass inter batches follow the scan classes in
            # the level buffer (same order the device concatenates).
            for s in sorted(vp.iluma.keys()):
                d = vp.iluma[s]
                lv_shapes.append(("iy", s, d["valid"].shape[0],
                                  d["valid"].shape[1]))
            if self.chroma:
                for pl in ("icb", "icr"):
                    for s in sorted(vp.ichroma.keys()):
                        d = vp.ichroma[s]
                        lv_shapes.append((pl, s,
                                          d["valid"].shape[0],
                                          d["valid"].shape[1]))
        # Deblock boundary strengths on the 8x8 cell grid: intra edges
        # (bs 2) exactly at CU/TU boundaries (a 64 CU's forced 32x32
        # TUs are TU boundaries, 8.7.2 — hence min(size, 32)).
        c = np.minimum((size8 // 8).astype(np.int32), 4)
        x8 = np.arange(size8.shape[1])[None, :]
        y8 = np.arange(size8.shape[0])[:, None]
        fields.append((("bs_v",),
                       np.where(x8 % c == 0, 2, 0).astype(np.int32)))
        fields.append((("bs_h",),
                       np.where(y8 % c == 0, 2, 0).astype(np.int32)))
        # Real wavefront depth: traced trip count for the recon scan
        # (schedule shapes stay at the padded bucket).
        fields.append((("n_real",),
                       np.array([max(vp.n_steps_real, 1)],
                                np.int32)))

        blob = np.concatenate(
            [np.ascontiguousarray(a).view(np.uint8).reshape(-1)
             for _p, a in fields])
        meta = tuple((p, a.dtype.str, a.shape) for p, a in fields)
        sched = self._var_unpack_fn(meta)(blob)
        sched.setdefault("chroma", {})
        return sched, lv_shapes

    def _var_frame_data(self, vp, size8, mode_maps, lv_np, lv_shapes,
                        sched_size8=None, cmode_maps=None):
        """Host assembly: depth/mode grids + coefficient planes from
        the packed level buffer.  sched_size8: the recon-schedule size
        grid (64 CUs appear as four 32 entries carrying the CU mode)."""
        fd = FrameData.empty(self.coded_w, self.coded_h, self.chroma)
        # depth = 6 - log2(size): 64->0, 32->1, 16->2, 8->3.
        fd.depth8[:] = (6 - np.round(np.log2(size8)).astype(np.int32)
                        ).astype(np.uint8)
        if sched_size8 is None:
            sched_size8 = size8
        size4 = np.kron(sched_size8, np.ones((2, 2), np.uint8))
        mode4 = np.zeros_like(size4, np.uint8)
        for s, grid in mode_maps.items():
            if s > 32:
                continue        # 64 modes ride the patched 32 grid
            up = np.kron(grid.astype(np.uint8),
                         np.ones((s // 4, s // 4), np.uint8))
            mode4 = np.where(size4 == s, up[:size4.shape[0],
                                            :size4.shape[1]], mode4)
        fd.mode4[:] = mode4
        if cmode_maps is not None:
            cm8 = np.full(fd.cmode4.shape, 255, np.uint8)
            for s, grid in cmode_maps.items():
                up = np.kron(grid.astype(np.uint8),
                             np.ones((s // 8, s // 8), np.uint8))
                cm8 = np.where(sched_size8 == s,
                               up[:cm8.shape[0], :cm8.shape[1]], cm8)
            fd.cmode4[:] = cm8

        # Levels arrive in pixel layout (scattered on device inside
        # the recon loop): the host just slices planes instead of a
        # per-class np.put scatter.
        ny = self.coded_w * self.coded_h
        fd.coeff_y[:] = lv_np[:ny].astype(np.int32).reshape(
            self.coded_h, self.coded_w)
        if self.chroma:
            nc = ny // 4
            fd.coeff_cb[:] = lv_np[ny:ny + nc].astype(
                np.int32).reshape(self.coded_h // 2, self.coded_w // 2)
            fd.coeff_cr[:] = lv_np[ny + nc:ny + 2 * nc].astype(
                np.int32).reshape(self.coded_h // 2, self.coded_w // 2)
        return fd

    def _var_serialize(self, fd, rec_y, rec_cb, rec_cr) -> FrameResult:
        if self.params.slices != "none":
            nal = self._slice_nals(fd, SLICE_I, self._islice_nal_poc()[0],
                                   dict(poc=self._islice_nal_poc()[1],
                                        ref_list_l0=[]))
            if self.cfg.hash in ("md5", "checksum") \
                    and rec_y is not None:
                from kvazaar_jax.bitstream.headers import \
                    write_picture_hash_sei
                nal += write_picture_hash_sei((rec_y, rec_cb, rec_cr),
                                              self.bitdepth,
                                              kind=self.cfg.hash)
            return FrameResult(nals=nal, recon_y=rec_y,
                               recon_cb=rec_cb, recon_cr=rec_cr,
                               frame_data=fd, bits=len(nal) * 8)
        sizes = []
        if not self.params.transquant_bypass \
                and self.params.max_tr_depth_intra == 0 \
                and self.params.crypto_key is None \
                and self.params.slices == "none" \
                and not self.params.tiles_enabled:
            if self.params.wpp:
                data, sizes = native.encode_slice_data_native_wpp(
                    self.params, fd, self.cfg.qp)
            else:
                data = native.encode_slice_data_native(self.params, fd,
                                                       self.cfg.qp)
        else:
            dw = BitWriter()
            enc = SliceDataEncoder(self.params, fd,
                                   Contexts(SLICE_I, self.cfg.qp),
                                   CabacEncoder(dw))
            self._apply_crypto_iv(enc)
            if self.params.tiles_enabled and self.params.wpp:
                sizes = enc.encode_slice_data_tiles_wpp()
            elif self.params.tiles_enabled:
                sizes = enc.encode_slice_data_tiles()
            elif self.params.wpp:
                sizes = enc.encode_slice_data_wpp()
            else:
                enc.encode_slice_data()
                dw.align_zero()
            data = dw.get_bytes()
        w = BitWriter()
        inal, ipoc = self._islice_nal_poc()
        write_slice_header(w, self.params, SLICE_I, inal,
                           self.cfg.qp, poc=ipoc, ref_list_l0=[],
                           num_entry_points=max(len(sizes) - 1, 0),
                           entry_point_offsets=sizes[:-1])
        nal = nal_unit(w.get_bytes() + data, inal)
        if self.cfg.hash in ("md5", "checksum") and rec_y is not None:
            from kvazaar_jax.bitstream.headers import \
                write_picture_hash_sei
            nal += write_picture_hash_sei((rec_y, rec_cb, rec_cr),
                                          self.bitdepth,
                                          kind=self.cfg.hash)
        return FrameResult(nals=nal, recon_y=rec_y, recon_cb=rec_cb,
                           recon_cr=rec_cr, frame_data=fd,
                           bits=len(nal) * 8)


    def _host_finalize(self, modes, lv_y, lv_cb, lv_cr, rec_y, rec_cb,
                       rec_cr, sao=None, ts_y=None,
                       qp_ctu=None, cmodes=None) -> FrameResult:
        s = self.cu
        fd = FrameData.empty(self.coded_w, self.coded_h, self.chroma)
        if qp_ctu is not None:
            fd.qp_ctu = np.asarray(qp_ctu, np.int32).copy()
        if cmodes is not None:
            # --rd 3 explicit chroma modes, CU grid -> 8-cell grid.
            fd.cmode4[:] = np.kron(
                np.asarray(cmodes, np.uint8),
                np.ones((s // 8, s // 8), np.uint8))
        if s == 4:
            fd.depth8[:] = 3               # 8x8 CUs, PART_NxN
            fd.nxn8[:] = 1
            fd.mode4[:] = modes
            if ts_y is not None:
                fd.tskip4[:] = ts_y
            fd.coeff_y[:] = blocks_to_plane(lv_y, self.plan, 4,
                                            self.coded_w, self.coded_h)
            if self.chroma:
                fd.coeff_cb[:] = blocks_to_plane(
                    lv_cb, self.plan_c, 4, self.coded_w // 2,
                    self.coded_h // 2)
                fd.coeff_cr[:] = blocks_to_plane(
                    lv_cr, self.plan_c, 4, self.coded_w // 2,
                    self.coded_h // 2)
        else:
            fd.depth8[:] = 6 - int(math.log2(s))
            fd.mode4[:] = np.kron(modes,
                                  np.ones((s // 4, s // 4), np.uint8))
            fd.coeff_y[:] = blocks_to_plane(lv_y, self.plan, s,
                                            self.coded_w, self.coded_h)
            if self.chroma:
                fd.coeff_cb[:] = blocks_to_plane(
                    lv_cb, self.plan, s // 2, self.coded_w // 2,
                    self.coded_h // 2)
                fd.coeff_cr[:] = blocks_to_plane(
                    lv_cr, self.plan, s // 2, self.coded_w // 2,
                    self.coded_h // 2)
        if sao is not None:
            fd.sao_merge[:] = sao["merge"]
            fd.sao_type[:] = sao["type"]
            fd.sao_eo[:] = sao["eo"]
            fd.sao_bp[:] = sao["bp"]
            fd.sao_off[:] = sao["off"]
        if self.params.slices != "none":
            nal = self._slice_nals(fd, SLICE_I, self._islice_nal_poc()[0],
                                   dict(poc=self._islice_nal_poc()[1],
                                        ref_list_l0=[]))
            if self.cfg.hash in ("md5", "checksum") \
                    and rec_y is not None:
                from kvazaar_jax.bitstream.headers import \
                    write_picture_hash_sei
                nal += write_picture_hash_sei((rec_y, rec_cb, rec_cr),
                                              self.bitdepth,
                                              kind=self.cfg.hash)
            return FrameResult(nals=nal, recon_y=rec_y,
                               recon_cb=rec_cb, recon_cr=rec_cr,
                               frame_data=fd, bits=len(nal) * 8)
        # Slice data first (entry-point offsets go into the header).
        sizes = []
        if not self.params.transquant_bypass \
                and self.params.max_tr_depth_intra == 0 \
                and self.params.crypto_key is None \
                and self.params.slices == "none" \
                and not self.params.tiles_enabled and self.cu != 4:
            if self.params.wpp:
                data, sizes = native.encode_slice_data_native_wpp(
                    self.params, fd, self.cfg.qp)
            else:
                data = native.encode_slice_data_native(self.params, fd,
                                                       self.cfg.qp)
        else:
            dw = BitWriter()
            enc = SliceDataEncoder(self.params, fd,
                                   Contexts(SLICE_I, self.cfg.qp),
                                   CabacEncoder(dw))
            self._apply_crypto_iv(enc)
            if self.params.tiles_enabled and self.params.wpp:
                sizes = enc.encode_slice_data_tiles_wpp()
            elif self.params.tiles_enabled:
                sizes = enc.encode_slice_data_tiles()
            elif self.params.wpp:
                sizes = enc.encode_slice_data_wpp()
            else:
                enc.encode_slice_data()
                dw.align_zero()
            data = dw.get_bytes()
        w = BitWriter()
        inal, ipoc = self._islice_nal_poc()
        write_slice_header(w, self.params, SLICE_I, inal,
                           self.cfg.qp, poc=ipoc, ref_list_l0=[],
                           num_entry_points=max(len(sizes) - 1, 0),
                           entry_point_offsets=sizes[:-1])
        nal = nal_unit(w.get_bytes() + data, inal)
        if self.cfg.hash in ("md5", "checksum") and rec_y is not None:
            from kvazaar_jax.bitstream.headers import \
                write_picture_hash_sei
            nal += write_picture_hash_sei((rec_y, rec_cb, rec_cr),
                                          self.bitdepth,
                                          kind=self.cfg.hash)
        return FrameResult(nals=nal, recon_y=rec_y, recon_cb=rec_cb,
                           recon_cr=rec_cr, frame_data=fd,
                           bits=len(nal) * 8)

    def host_pack_sources(self, frames):
        """(y, cb, cr) list -> ONE (B, bytes) uint8 upload buffer (one
        transfer call per batch) + the padded host planes."""
        s = max(self.cu, 8)     # coded sizes are multiples of min CU 8
        sdt = np.uint8 if self.bitdepth <= 8 else np.uint16
        ys = np.stack([pad_to_multiple(np.asarray(f[0], sdt), s)
                       for f in frames])
        b = len(frames)
        parts = [ys.reshape(b, -1).view(np.uint8)]
        cbs = crs = None
        if self.chroma:
            cbs = np.stack([pad_to_multiple(np.asarray(f[1], sdt),
                                            s // 2) for f in frames])
            crs = np.stack([pad_to_multiple(np.asarray(f[2], sdt),
                                            s // 2) for f in frames])
            parts += [cbs.reshape(b, -1).view(np.uint8),
                      crs.reshape(b, -1).view(np.uint8)]
        return np.concatenate(parts, axis=1), (ys, cbs, crs)

    def submit_frames(self, frames):
        """Queue the device program for a batch (async dispatch); pair
        with finalize_frames.  Queuing batch N+1 before finalizing batch
        N overlaps device compute with the previous batch's transfer +
        host CABAC.  8-bit sources take the delta-packed upload when
        the content fits its escape budget (~1.6x fewer H2D bytes on
        natural video; ops/xfer.py source pack)."""
        b = len(frames)
        if self.bitdepth == 8:
            pk = self._pack_sources_delta(frames)
            if pk is not None:
                buf, (ys, cbs, crs) = pk
                srcs = (ys, cbs, crs) if self.cfg.sao else None
                if not hasattr(self, "_packed_fns"):
                    self._packed_fns = {}
                if b not in self._packed_fns:
                    self._packed_fns[b] = jax.jit(
                        lambda x, _b=b:
                        self._device_encode_packed_impl(x, _b))
                return (b, self._packed_fns[b](buf), srcs)
        buf, (ys, cbs, crs) = self.host_pack_sources(frames)
        srcs = (ys, cbs, crs) if self.cfg.sao else None
        return (b, self._device_encode_batch(buf), srcs)

    def encode_frames(self, frames) -> list[FrameResult]:
        """Encode a batch of frames through one batched device program;
        host serialization fans out over a thread pool (the native CABAC
        releases the GIL)."""
        if self.cfg.intra_min_cu < self.cfg.intra_max_cu:
            # Variable-CU trees are per-frame (content-dependent
            # schedules); no batched program yet.
            return [self.encode_frame_var(*f) for f in frames]
        return self.finalize_frames(self.submit_frames(frames))

    def download_frames(self, handle):
        """Stage 2 of the pipeline: the ONE device->host transfer for a
        submitted batch + host-side unpack.  Safe to call from a worker
        thread (releases the GIL while the bytes move); pass
        the result to finalize_downloaded."""
        nframes, (packed, dense, recs), srcs = handle
        flat, modes, ts_y, cmodes, sses = self._unpack_batch(
            np.asarray(packed), nframes)
        if flat is None:
            # Rare very-low-QP/high-energy fallback: exact int16
            # levels for the whole batch.
            out_lv = [None if d is None else
                      np.asarray(d).astype(np.int32) for d in dense]
        else:
            out_lv = self._levels_from_flat(flat, nframes)
        return nframes, (out_lv, modes, ts_y, cmodes, sses), recs, srcs

    def finalize_frames(self, handle,
                        need_recon: bool = True) -> list[FrameResult]:
        return self.finalize_downloaded(self.download_frames(handle),
                                        need_recon)

    def finalize_downloaded(self, downloaded,
                            need_recon: bool = True) -> list[FrameResult]:
        import concurrent.futures as cf
        nframes, unpacked, recs, srcs = downloaded
        # Levels+modes+meta came compacted (ops/xfer.py); recon planes
        # only when the caller needs pixels (hash SEI / --debug /
        # PSNR-from-recon).
        (lv_y, lv_cb, lv_cr), modes, ts_y, cmodes, sses = unpacked
        sao_list = [None] * nframes
        if self.cfg.sao:
            recs, sao_list = self._sao_stage(srcs, recs)
        # DPB takes the last frame of the batch (streaming IPPP refs).
        self._dpb = (recs[0][-1],
                     recs[1][-1] if self.chroma else None,
                     recs[2][-1] if self.chroma else None)
        rec_y = rec_cb = rec_cr = None
        if need_recon or self.cfg.hash != "none" or self.cfg.sao:
            rec_y = np.asarray(recs[0])
            if self.chroma:
                rec_cb, rec_cr = np.asarray(recs[1]), np.asarray(recs[2])
        if self._host_pool is None:
            self._host_pool = cf.ThreadPoolExecutor(
                max_workers=self.cfg.threads or 8)
        futs = []
        for i in range(nframes):
            futs.append(self._host_pool.submit(
                self._host_finalize, modes[i], lv_y[i],
                lv_cb[i] if self.chroma else None,
                lv_cr[i] if self.chroma else None,
                None if rec_y is None else rec_y[i],
                rec_cb[i] if (self.chroma and rec_cb is not None) else None,
                rec_cr[i] if (self.chroma and rec_cr is not None) else None,
                sao_list[i],
                ts_y[i] if ts_y is not None else None,
                None,
                cmodes[i] if cmodes is not None else None))
        out = [f.result() for f in futs]
        for i, r in enumerate(out):
            r.sse = tuple(float(s) for s in sses[i])
        return out


def psnr(a: np.ndarray, b: np.ndarray, bitdepth: int = 8) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    if mse == 0:
        return 999.99
    peak = (1 << bitdepth) - 1
    return 10.0 * math.log10(peak * peak / mse)


def compute_bs_maps_b(is_inter, cbf_luma_blk, dirs, mv0, mv1):
    """Boundary strengths for B frames (8.7.2.4): inter-inter edges get
    bs 1 when the sides use different prediction directions (different
    reference sets / MV counts) or any used list's MVs differ by >= 4
    quarter-pels; shared by encoder and oracle decoder."""
    intra_b = ~is_inter

    def edge(sl_a, sl_b):
        a_i, b_i = intra_b[sl_a], intra_b[sl_b]
        cbf = cbf_luma_blk[sl_a] | cbf_luma_blk[sl_b]
        dif_dir = dirs[sl_a] != dirs[sl_b]
        d0 = jnp.any(jnp.abs(mv0[sl_a] - mv0[sl_b]) >= 4, axis=-1)
        d1 = jnp.any(jnp.abs(mv1[sl_a] - mv1[sl_b]) >= 4, axis=-1)
        use0 = dirs[sl_a] != 1
        use1 = dirs[sl_a] != 0
        mvd = (use0 & d0) | (use1 & d1)
        return jnp.where(a_i | b_i, 2,
                         jnp.where(cbf | dif_dir | mvd, 1,
                                   0)).astype(jnp.int32)

    by, bx = is_inter.shape
    bs_v = jnp.zeros((by, bx), jnp.int32)
    bs_h = jnp.zeros((by, bx), jnp.int32)
    bs_v = bs_v.at[:, 1:].set(
        edge((slice(None), slice(0, bx - 1)),
             (slice(None), slice(1, bx))))
    bs_h = bs_h.at[1:, :].set(
        edge((slice(0, by - 1), slice(None)),
             (slice(1, by), slice(None))))
    return bs_v, bs_h


def compute_bs_maps_smp(inter8, cbf8, mv_cells, cu: int, part8=None):
    """8-grid boundary strengths for SMP frames (8.7.2.4): full rules
    at CU/TU edges (every cu-multiple), the MV-difference rule at SMP
    PU edges inside inter CUs, 0 elsewhere (internal non-boundary
    edges are never filtered).

    inter8/cbf8: (h8, w8) bool CU-filled; mv_cells: (h8, w8, 2) qpel;
    part8: (h8, w8) int32 CU-filled part mode."""
    cells = cu // 8
    h8, w8 = inter8.shape
    intra8 = ~inter8
    xi = jnp.arange(w8)
    yi = jnp.arange(h8)

    def edge(sl_a, sl_b, is_cu_edge, is_pu_edge):
        a_i, b_i = intra8[sl_a], intra8[sl_b]
        cbf = cbf8[sl_a] | cbf8[sl_b]
        mvd = jnp.any(jnp.abs(mv_cells[sl_a] - mv_cells[sl_b]) >= 4,
                      axis=-1)
        bs = jnp.where(a_i | b_i, 2,
                       jnp.where(cbf | mvd, 1, 0)).astype(jnp.int32)
        bs_pu = jnp.where(mvd, 1, 0)
        return jnp.where(is_cu_edge, bs,
                         jnp.where(is_pu_edge, bs_pu, 0))

    # Vertical edges at x = j*8 (j >= 1).
    cu_v = ((xi % cells) == 0)[None, 1:w8]
    pu_v = jnp.zeros((h8, w8), bool)
    pu_h = jnp.zeros((h8, w8), bool)
    if part8 is not None and cells > 1:
        half = cells // 2
        quarter = max(cells // 4, 1)
        col = (xi % cells)[None, :]
        row = (yi % cells)[:, None]
        pu_v = (((part8 == 2) & (col == half))
                | ((part8 == 6) & (col == quarter))
                | ((part8 == 7) & (col == cells - quarter))) & inter8
        pu_h = (((part8 == 1) & (row == half))
                | ((part8 == 4) & (row == quarter))
                | ((part8 == 5) & (row == cells - quarter))) & inter8
    bs_v = jnp.zeros((h8, w8), jnp.int32)
    bs_h = jnp.zeros((h8, w8), jnp.int32)
    bs_v = bs_v.at[:, 1:].set(edge(
        (slice(None), slice(0, w8 - 1)), (slice(None), slice(1, w8)),
        cu_v, pu_v[:, 1:]))
    cu_h = ((yi % cells) == 0)[1:h8, None]
    bs_h = bs_h.at[1:, :].set(edge(
        (slice(0, h8 - 1), slice(None)), (slice(1, h8), slice(None)),
        cu_h, pu_h[1:, :]))
    return bs_v, bs_h


def compute_bs_maps(is_inter, cbf_luma_blk, mv, ref=None):
    """Per-CU-edge boundary strengths (H.265 8.7.2.4, P slices).

    is_inter/cbf: (By, Bx) bool; mv: (By, Bx, 2) qpel; ref: optional
    (By, Bx) L0 ref indices — different reference pictures force
    BS >= 1.  Returns (bs_v, bs_h) int32 (By, Bx): bs of each block's
    left / top edge (column/row 0 entries are picture borders, never
    filtered)."""
    intra_b = ~is_inter

    def edge(sl_a, sl_b):
        a_i, b_i = intra_b[sl_a], intra_b[sl_b]
        cbf = cbf_luma_blk[sl_a] | cbf_luma_blk[sl_b]
        mvd = jnp.any(jnp.abs(mv[sl_a] - mv[sl_b]) >= 4, axis=-1)
        if ref is not None:
            mvd = mvd | (ref[sl_a] != ref[sl_b])
        return jnp.where(a_i | b_i, 2,
                         jnp.where(cbf | mvd, 1, 0)).astype(jnp.int32)

    by, bx = is_inter.shape
    bs_v = jnp.zeros((by, bx), jnp.int32)
    bs_h = jnp.zeros((by, bx), jnp.int32)
    bs_v = bs_v.at[:, 1:].set(
        edge((slice(None), slice(0, bx - 1)),
             (slice(None), slice(1, bx))))
    bs_h = bs_h.at[1:, :].set(
        edge((slice(0, by - 1), slice(None)),
             (slice(1, by), slice(None))))
    return bs_v, bs_h


