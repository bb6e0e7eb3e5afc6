"""Public encoder API — the analogue of the reference's kvz_api vtable
(src/kvazaar.h:545-699, src/kvazaar.c): open an encoder from a Config,
feed frames, receive Annex-B chunks + reconstruction + per-frame info.

v1 scope: all-intra.  The feed/drain pipeline shape (async device compute
overlapping host CABAC of the previous frame) is preserved so inter/GOP
frames slot in without API changes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from kvazaar_jax.config import Config
from kvazaar_jax.constants import NAL_IDR_W_RADL, SLICE_I, SLICE_P
from kvazaar_jax.encoder.frame_encoder import IntraFrameEncoder, psnr
from kvazaar_jax.profiler import phase


@dataclasses.dataclass
class FrameInfo:
    """Per-frame results (reference: kvz_frame_info,
    src/kvazaar.h:492-526)."""
    poc: int
    qp: int
    nal_type: int
    slice_type: int
    bits: int
    psnr_y: float
    psnr_u: float
    psnr_v: float


# Hierarchical GOP coding structures (the reference builds these in
# kvz_config: --gop 8 B-pyramid with per-position qp_offset/layer/
# qp_factor, src/cfg.c:908-950 + layer lambdas src/encoder.c:748).
# Entries in CODING order: (poc_offset from the previous anchor,
# L0 distance back, L1 distance forward or None for the P anchor,
# qp_offset, qp_factor).  The gop-4 pyramid is our extension (the
# reference CLI accepts only 0/8/lp-*) with a 3-layer offset ladder.
GOP_TABLES = {
    4: [(4, 4, None, 1, 0.442), (2, 2, 2, 2, 0.3536),
        (1, 1, 1, 3, 0.68), (3, 1, 1, 3, 0.68)],
    8: [(8, 8, None, 1, 0.442), (4, 4, 4, 2, 0.3536),
        (2, 2, 2, 3, 0.3536), (1, 1, 1, 4, 0.68), (3, 1, 1, 4, 0.68),
        (6, 2, 2, 3, 0.3536), (5, 1, 1, 4, 0.68), (7, 1, 1, 4, 0.68)],
}


class Encoder:
    """Streaming encoder: results = encoder.encode(frame) (a list —
    GOP reordering delays output); encoder.flush() at end."""

    def __init__(self, cfg: Config):
        self.cfg = cfg.validate()
        from kvazaar_jax.checkpoint import Checkpointer
        self._ckpt = Checkpointer()
        # Stream-order picture count for the selective-encryption
        # nonce (shared across per-QP encoder instances under RC).
        self._crypto_pics = 0
        # Interlaced sources: the internal encoder codes half-height
        # FIELD pictures (the reference's field adapter,
        # src/kvazaar.c:294); encode() splits each frame into fields.
        self._fields = cfg.source_scan_type
        if self._fields:
            import dataclasses as dc
            cfg = dc.replace(cfg, height=cfg.height // 2)
            self.cfg = cfg.validate()
        self._intra = IntraFrameEncoder(cfg)
        self._poc = 0
        self._wrote_headers = False
        self._rc = None
        self._rc_lambda = None
        self._prev_qp = cfg.qp
        self._encoders = {cfg.qp: self._intra}
        self._gop = cfg.gop_len if cfg.gop_len > 1 else 0
        self._pending = []           # display-order sources in this GOP
        self._dpb_map = {}           # poc -> (y, cb, cr) device planes
        self._base_poc = 0
        # Low-delay multi-reference state (lp-g#d#t# GOPs and/or
        # --ref N): POC-keyed DPB + the per-position structure table.
        self._lp_table = None
        self._multi = (cfg.lp_gop is not None or cfg.ref_frames > 1
                       or cfg.tmvp)
        if cfg.lp_gop is not None:
            from kvazaar_jax.config import lp_gop_table
            g, d, t = cfg.lp_gop
            self._lp_table = lp_gop_table(g, d, t, cfg.ref_frames)
        self._dpb_ld = {}            # rel poc -> (y, cb, cr) planes
        if cfg.bitrate > 0:
            from kvazaar_jax.encoder.rate_control import RateController
            fps = cfg.framerate_num / max(cfg.framerate_denom, 1)
            if self._fields:
                # Each source frame produces TWO field pictures: the
                # per-picture budget is bitrate / (2*fps).
                fps *= 2
            self._rc = RateController(cfg.bitrate, fps, cfg.width,
                                      cfg.height)
        # Per-CTU QP machinery (LCU RC / ROI / AQ -> cu_qp_delta).
        self._rc_wts = {}        # slice kind -> (Cy, Cx) weights
        self._roi_map = None
        if cfg.roi is not None:
            with open(cfg.roi) as f:
                toks = f.read().split()
            rw, rh = int(toks[0]), int(toks[1])
            vals = np.array([int(t) for t in toks[2:2 + rw * rh]],
                            np.int32)
            if vals.size != rw * rh:
                raise ValueError("ROI file: expected %d deltas" %
                                 (rw * rh))
            self._roi_map = vals.reshape(rh, rw)

    def _encoder_for_qp(self, qp: int) -> "IntraFrameEncoder":
        """Per-QP compiled encoder (QP is static in the device
        programs); DPB handed over on switch.  The selective-encryption
        nonce counter is stream-global: sync it into whichever instance
        encodes next (decoder counts pictures in stream order)."""
        if qp not in self._encoders:
            import dataclasses as dc
            cfg2 = dc.replace(self.cfg, qp=qp)
            enc2 = IntraFrameEncoder(cfg2)
            # One PPS in the stream: slice_qp_delta is coded against the
            # base config's init QP, not this encoder's QP.
            enc2.params.qp = self.cfg.qp
            self._encoders[qp] = enc2
        enc = self._encoders[qp]
        enc._dpb = self._intra._dpb if self._intra is not enc else \
            enc._dpb
        if self.cfg.crypto is not None:
            enc._crypto_seq = self._crypto_pics
        return enc

    def headers(self) -> bytes:
        return self._intra.headers()

    def set_base_qp(self, qp: int) -> None:
        """Change the stream's base QP without recompiling any device
        program (variable-tree configs without custom scaling lists:
        QP/lambda are traced data end to end).  Takes effect at the
        next picture; combine with reset_stream() to start a clean
        stream at the new QP (e.g. a BD-rate ladder over one encoder
        instance — a fresh instance per QP re-traces and re-loads
        every program)."""
        import dataclasses as dc
        self.cfg = dc.replace(self.cfg, qp=qp).validate()
        self._intra.set_base_qp(qp)
        self._encoders = {qp: self._intra}
        self._prev_qp = qp

    def reset_stream(self) -> None:
        """Start a new bitstream on this encoder: headers re-emitted,
        POC back to 0 (next picture is an IDR), GOP reorder buffer and
        DPBs cleared.  Compiled device programs are retained."""
        assert not self._pending, "flush() before reset_stream()"
        self._poc = 0
        self._wrote_headers = False
        self._irap_count = 0
        self._base_poc = 0
        self._dpb_map = {}
        self._dpb_ld = {}
        self._intra._dpb = None
        self._crypto_pics = 0
        self._intra._crypto_seq = 0

    def _au_prefix(self, slice_type: int) -> bytes:
        """Per-access-unit prefix: AUD, then parameter sets + version
        SEI at stream start and (--vps-period N) before every Nth IRAP
        (the reference's assembly order,
        encoder_state_write_bitstream_main,
        src/encoder_state-bitstream.c:982-1010)."""
        out = b""
        if self.cfg.aud:
            from kvazaar_jax.bitstream.headers import write_aud
            out += write_aud(slice_type)
        reemit = False
        if slice_type == SLICE_I:
            n = getattr(self, "_irap_count", 0)
            self._irap_count = n + 1
            vp = self.cfg.vps_period
            reemit = (self._wrote_headers and vp > 0 and n > 0
                      and n % vp == 0)
        if not self._wrote_headers or reemit:
            out += self.headers()
            if self.cfg.info and not self._wrote_headers:
                from kvazaar_jax.bitstream.headers import \
                    write_version_sei
                out += write_version_sei()
            self._wrote_headers = True
        return out

    def encode(self, y: np.ndarray, cb=None, cr=None):
        """Encode one frame.  Returns a LIST of (annexb_bytes,
        FrameInfo, recon) results in coding order — empty while a GOP
        is buffering; call flush() after the last input frame.

        GOP control: gop_len in {4, 8} → hierarchical B pyramid with
        reordering; otherwise --period semantics (1 → all-intra,
        N > 1 → IDR every N, 0 → first frame only intra, IPPP).

        Interlaced sources (--source-scan-type tff/bff) split each
        frame into two half-height field pictures, each coded as its
        own picture with a pic_timing SEI (pic_struct 1/2)."""
        if self._fields:
            outs = []
            for parity in (0, 1):
                off = parity if self._fields == 1 else 1 - parity
                fy = y[off::2]
                fcb = None if cb is None else cb[off::2]
                fcr = None if cr is None else cr[off::2]
                ps = 1 if off == 0 else 2    # top field / bottom field
                outs.append(self._encode_ld(fy, fcb, fcr,
                                            pic_struct=ps))
            return outs
        if self._gop:
            return self._encode_gop_input(y, cb, cr)
        return [self._encode_ld(y, cb, cr)]

    def flush(self):
        """Emit any buffered GOP tail (shorter final GOP codes as a
        low-delay P chain)."""
        if not self._gop or not self._pending:
            return []
        return self._flush_gop(partial=True)

    def _rc_enc(self, is_intra: bool):
        """(encoder, lambda) for the next frame under frame-level rate
        control, or (default encoder, None) at fixed QP.  Serves the
        GOP/B-pyramid path — LCU allocation is low-delay-only, but the
        picture-level R-lambda loop applies to every structure
        (pic_allocate_bits, src/rate_control.c:142)."""
        if self._rc is None:
            return self._intra, None
        lam, qp = self._rc.frame_lambda_qp(is_intra)
        qp = min(max(qp, self._prev_qp - 3), self._prev_qp + 3)
        self._prev_qp = qp
        return self._encoder_for_qp(qp), lam

    def _encode_gop_input(self, y, cb=None, cr=None):
        if self._poc == 0:
            # Open the stream with the IDR anchor at POC 0.
            enc, lam = self._rc_enc(True)
            res = enc.encode_frame(y, cb, cr)
            if lam is not None:
                self._rc.update(len(res.nals) * 8, lam)
            out = [self._emit(res, 0, (y, cb, cr), qp=enc.cfg.qp)]
            self._dpb_map[0] = enc._dpb
            self._poc = 1
            return out
        self._pending.append((y, cb, cr))
        if len(self._pending) == self._gop:
            return self._flush_gop(partial=False)
        return []

    def _flush_gop(self, partial: bool):
        base = self._base_poc
        out = []
        if partial:
            # Tail shorter than the GOP: low-delay P chain.
            for i, (y, cb, cr) in enumerate(self._pending):
                poc = base + 1 + i
                ife, lam = self._rc_enc(False)
                ife._dpb = self._dpb_map[poc - 1]
                res = ife.encode_p_frame(y, cb, cr, poc=poc,
                                         ref_poc=poc - 1)
                if lam is not None:
                    self._rc.update(len(res.nals) * 8, lam)
                self._dpb_map[poc] = ife._dpb
                out.append(self._emit(res, poc, self._pending[i],
                                      qp=ife.cfg.qp))
        elif (self._rc is None and self.cfg.crypto is None
                and self._intra._var_inter_active
                and self._intra.scaling is None):
            # Pipelined GOP: device submit of frame i+1 chains on the
            # device DPB while a worker finalizes frame i (downloads +
            # host CABAC) — the reference's OWF overlap
            # (src/encoderstate.c:790-806) at GOP granularity.
            import collections as _collections
            import concurrent.futures as _cf
            from kvazaar_jax.constants import NAL_CRA_NUT, NAL_RASL_R
            import time as _time
            _t_flush = _time.monotonic()
            ife = self._intra
            if not hasattr(self, "_fin_pool"):
                # TWO finalize workers: host CABAC + downloads of up to
                # two pictures overlap the next submits' device search
                # (per-frame FrameData/CABAC state is allocated per
                # call; the native CABAC already runs 2-way concurrent
                # on the intra pipeline).  Emission stays coding-order
                # via the FIFO deque.
                self._fin_pool = _cf.ThreadPoolExecutor(2)
            pending = _collections.deque()
            depth = 2
            period = self.cfg.intra_period
            # Open-GOP periodic intra: the anchor at a period boundary
            # codes as a CRA (POC continues); this GOP's B pictures
            # precede it in display order and reference across it ->
            # RASL leading pictures (reference NAL-type logic,
            # src/encoderstate.c:1171-1272, open_gop src/cfg.c:120).
            cra_poc = base + self._gop
            is_cra_gop = period > 1 and cra_poc % period == 0
            for (off, l0, l1, qp_off, qp_fac) in GOP_TABLES[self._gop]:
                poc = base + off
                src = self._pending[off - 1]
                frame_qp = (min(max(self.cfg.qp + qp_off, 0), 51)
                            if qp_off else None)
                if l1 is None and is_cra_gop and poc == cra_poc:
                    while pending:
                        f, p_, s_, q_ = pending.popleft()
                        out.append(self._emit(f.result(), p_, s_,
                                              qp=q_))
                    res = ife.encode_frame(*src, nal_type=NAL_CRA_NUT,
                                           poc=poc)
                    self._dpb_map[poc] = ife._dpb
                    out.append(self._emit(res, poc, src,
                                          qp=ife.cfg.qp,
                                          nal_type=NAL_CRA_NUT,
                                          slice_type=SLICE_I))
                    continue
                if l1 is None:
                    ife._dpb = self._dpb_map[poc - l0]
                    with phase("gop.submit_p"):
                        h = ife.submit_var_p(*src, poc=poc,
                                             ref_poc=poc - l0,
                                             qp=frame_qp,
                                             qp_factor=qp_fac)
                    self._dpb_map[poc] = ife._dpb
                    fut = self._fin_pool.submit(ife.finalize_var_p, h)
                else:
                    with phase("gop.submit_b"):
                        h = ife.submit_var_b(
                            *src, poc=poc,
                            ref0=(poc - l0, self._dpb_map[poc - l0]),
                            ref1=(poc + l1, self._dpb_map[poc + l1]),
                            qp=frame_qp, qp_factor=qp_fac,
                            nal_type=NAL_RASL_R if is_cra_gop
                            else None)
                    self._dpb_map[poc] = (h["dy"], h["dcb"], h["dcr"])
                    fut = self._fin_pool.submit(ife.finalize_var_b, h)
                pending.append((fut, poc, src,
                                frame_qp if frame_qp is not None
                                else ife.cfg.qp))
                while len(pending) > depth:
                    f, p_, s_, q_ = pending.popleft()
                    with phase("gop.wait"):
                        r_ = f.result()
                    with phase("gop.emit"):
                        out.append(self._emit(r_, p_, s_, qp=q_))
            while pending:
                f, p_, s_, q_ = pending.popleft()
                with phase("gop.wait"):
                    r_ = f.result()
                with phase("gop.emit"):
                    out.append(self._emit(r_, p_, s_, qp=q_))
            self._base_poc = base + self._gop
            self._dpb_map = {p: v for p, v in self._dpb_map.items()
                             if p >= self._base_poc}
            self._pending = []
            self._poc = self._base_poc + 1
            from kvazaar_jax.profiler import phases as _phases
            _phases.add("gop.flush_total",
                        _time.monotonic() - _t_flush)
            return out
        else:
            # GOP-level rate-control allocation (gop_allocate_bits,
            # src/rate_control.c:72): the whole GOP's budget is set
            # from the smoothed spending plan, then split over the
            # pyramid layers; each picture's lambda/QP comes from its
            # own target share instead of the flat per-frame budget.
            gop_targets = (self._rc.allocate_gop(GOP_TABLES[self._gop])
                           if self._rc is not None else None)
            for gi, (off, l0, l1, qp_off, qp_fac) in enumerate(
                    GOP_TABLES[self._gop]):
                poc = base + off
                src = self._pending[off - 1]
                frame_qp = None
                if gop_targets is not None:
                    lam, rc_qp = self._rc.pic_lambda_qp(gop_targets[gi])
                    rc_qp = min(max(rc_qp, self._prev_qp - 3),
                                self._prev_qp + 3)
                    self._prev_qp = rc_qp
                    ife = self._intra
                    if ife._var_inter_active and ife.scaling is None:
                        # QP rides the var path as traced data: one
                        # compiled program serves the whole RC ladder.
                        frame_qp = rc_qp
                    else:
                        ife = self._encoder_for_qp(rc_qp)
                else:
                    ife, lam = self._rc_enc(False)
                # Per-layer QP offsets + qp_factor lambdas (reference
                # GOP-8 table, src/cfg.c:908-950).  The var path takes
                # the frame QP as traced data (one compiled program
                # serves all layers); fixed grids / scaling lists fall
                # back to a per-QP compiled instance; RC sets its own
                # frame QP (GOP-allocated) and skips the structural
                # offset.
                fac = qp_fac
                if lam is None and qp_off:
                    want_qp = min(max(self.cfg.qp + qp_off, 0), 51)
                    if (ife._var_inter_active
                            and ife.scaling is None):
                        frame_qp = want_qp
                    else:
                        ife = self._encoder_for_qp(want_qp)
                if l1 is None:
                    ife._dpb = self._dpb_map[poc - l0]
                    res = ife.encode_p_frame(*src, poc=poc,
                                             ref_poc=poc - l0,
                                             qp=frame_qp,
                                             qp_factor=fac)
                    self._dpb_map[poc] = ife._dpb
                else:
                    res, recs = ife.encode_b_frame(
                        *src, poc=poc,
                        ref0=(poc - l0, self._dpb_map[poc - l0]),
                        ref1=(poc + l1, self._dpb_map[poc + l1]),
                        qp=frame_qp, qp_factor=fac)
                    self._dpb_map[poc] = recs
                if lam is not None:
                    self._rc.update(len(res.nals) * 8, lam)
                out.append(self._emit(
                    res, poc, src,
                    qp=frame_qp if frame_qp is not None
                    else ife.cfg.qp))
            self._base_poc = base + self._gop
            # Keep only the refs the next GOP can use.
            self._dpb_map = {p: v for p, v in self._dpb_map.items()
                             if p >= self._base_poc}
        self._pending = []
        self._poc = self._base_poc + len(self._pending) + 1
        return out

    def _emit(self, res, poc, src, qp=None, nal_type=None,
              slice_type=None):
        if self.cfg.crypto is not None:
            self._crypto_pics += 1
        chunks = self._au_prefix(
            SLICE_I if (poc == 0 or slice_type == SLICE_I) else 0)
        y, cb, cr = src
        h, w = y.shape
        rec_y = res.recon_y[:h, :w]
        rec_cb = rec_cr = None
        p_u = p_v = 0.0
        if res.recon_cb is not None:
            rec_cb = res.recon_cb[:h // 2, :w // 2]
            rec_cr = res.recon_cr[:h // 2, :w // 2]
            p_u = psnr(rec_cb, np.asarray(cb, np.int32),
                       self.cfg.input_bitdepth)
            p_v = psnr(rec_cr, np.asarray(cr, np.int32),
                       self.cfg.input_bitdepth)
        is_idr = poc == 0
        info = FrameInfo(
            poc=poc, qp=self.cfg.qp if qp is None else qp,
            nal_type=(NAL_IDR_W_RADL if is_idr
                      else (nal_type if nal_type is not None else 1)),
            slice_type=(SLICE_I if is_idr
                        else (slice_type if slice_type is not None
                              else 1)),
            bits=len(res.nals) * 8,
            psnr_y=psnr(rec_y, np.asarray(y, np.int32),
                        self.cfg.input_bitdepth),
            psnr_u=p_u, psnr_v=p_v)
        self._ckpt.mark_frame(info.poc, info.qp, info.nal_type,
                              info.slice_type, info.bits,
                              (rec_y, rec_cb, rec_cr), res.frame_data)
        return chunks + res.nals, info, (rec_y, rec_cb, rec_cr)

    def _qp_ctu_for(self, base_qp: int, y: np.ndarray, is_intra: bool):
        """Per-CTU QP map for the next frame, or None when per-CTU QP
        is off.  Combines LCU rate-control allocation (weights from the
        previous frame of the same slice type), the ROI delta map, and
        variance AQ — the reference's kvz_set_lcu_lambda_and_qp
        (src/rate_control.c:278) + ROI/AQP (src/encoder.c:127-170)."""
        if not self.cfg.cu_qp_delta_active:
            return None
        p = self._intra.params
        cy, cx = p.height_in_ctus, p.width_in_ctus
        if self._rc is not None and self.cfg.lcu_rc:
            key = "i" if is_intra else "p"
            qmap = self._rc.lcu_qp_map(base_qp, (cy, cx),
                                       self._rc_wts.get(key))
        else:
            qmap = np.full((cy, cx), base_qp, np.int32)
        if self._roi_map is not None:
            rh, rw = self._roi_map.shape
            iy = np.minimum(np.arange(cy) * rh // cy, rh - 1)
            ix = np.minimum(np.arange(cx) * rw // cx, rw - 1)
            qmap = qmap + self._roi_map[np.ix_(iy, ix)]
        if self.cfg.aq > 0:
            h, w = y.shape
            yp = np.pad(np.asarray(y, np.float64),
                        ((0, cy * 64 - h), (0, cx * 64 - w)),
                        mode="edge")
            v = yp.reshape(cy, 64, cx, 64).var(axis=(1, 3))
            lv = np.log2(v + 1.0)
            dqp = np.rint(self.cfg.aq * (lv - lv.mean()))
            qmap = qmap + np.clip(dqp, -3, 3).astype(np.int32)
        return np.clip(qmap, 0, 51).astype(np.int32)

    def _note_ctu_weights(self, fd, is_intra: bool) -> None:
        """Feed per-CTU complexity back to the LCU rate controller."""
        if self._rc is None or not self.cfg.lcu_rc:
            return
        from kvazaar_jax.encoder.rate_control import RateController
        self._rc_wts["i" if is_intra else "p"] = \
            RateController.ctu_weights_from_levels(
                fd, self._intra.coded_w, self._intra.coded_h)

    def _lp_pattern(self, rel_poc: int):
        """Structure entry for a low-delay frame at rel POC n (>= 1):
        ref deltas + QP offset (reference: the gop[] table consumed by
        encoder_state_init_new_frame, src/encoderstate.c:1050)."""
        if self._lp_table is not None:
            return self._lp_table[(rel_poc - 1) % len(self._lp_table)]
        return dict(poc_offset=rel_poc, layer=1, qp_offset=0,
                    ref_neg=list(range(1, self.cfg.ref_frames + 1)))

    def _encode_ld(self, y: np.ndarray, cb=None, cr=None,
                   pic_struct=None):
        period = self.cfg.intra_period
        is_intra = (self._poc == 0 or period == 1
                    or (period > 1 and self._poc % period == 0))
        chunks = self._au_prefix(SLICE_I if is_intra else SLICE_P)
        if pic_struct is not None:
            from kvazaar_jax.bitstream.headers import \
                write_pic_timing_sei
            chunks += write_pic_timing_sei(pic_struct)
        frame_qp = self.cfg.qp
        if self._rc is not None:
            lam, qp = self._rc.frame_lambda_qp(is_intra)
            # Clamp QP swings (keeps quality stable and bounds the
            # number of distinct compiled programs).
            qp = min(max(qp, self._prev_qp - 3), self._prev_qp + 3)
            self._rc_lambda = lam
            self._prev_qp = qp
            frame_qp = qp
            if self.cfg.cu_qp_delta_active:
                # The RC frame QP rides the per-CTU map: slice QP stays
                # at the config QP and ONE compiled program (with QP as
                # traced data) serves every frame — no per-QP
                # recompiles (the reference's per-LCU QP has the same
                # effect, src/rate_control.c:278).
                enc = self._intra
            else:
                enc = self._encoder_for_qp(qp)
        else:
            enc = self._intra
        qp_ctu = self._qp_ctu_for(frame_qp, y, is_intra)
        if is_intra:
            res = enc.encode_frame(y, cb, cr, qp_ctu=qp_ctu)
            # POC restarts at every IDR (8.3.1); slice headers signal
            # POC relative to the last IDR.
            self._last_idr = self._poc
            if self._multi:
                self._dpb_ld = {0: enc._dpb}
                self._motion_ld = {0: None}
        elif self._multi:
            rel = self._poc - getattr(self, "_last_idr", 0)
            pat = self._lp_pattern(rel)
            deltas = []
            for d in pat["ref_neg"]:
                if d <= rel and (rel - d) in self._dpb_ld \
                        and d not in deltas:
                    deltas.append(d)
            deltas = deltas[:self.cfg.ref_frames] or [1]
            used = [rel - d for d in deltas]
            # Pics a future frame (within one structure period) still
            # needs must survive this picture's RPS.
            needed = set()
            horizon = len(self._lp_table) if self._lp_table else \
                self.cfg.ref_frames
            for f in range(rel + 1, rel + horizon + 1):
                for d in self._lp_pattern(f)["ref_neg"]:
                    needed.add(f - d)
            retained = sorted(rel - p for p in self._dpb_ld
                              if p not in used and p in needed)
            refs = [(rel - d, self._dpb_ld[rel - d]) for d in deltas]
            if pat["qp_offset"] and self._rc is None:
                enc = self._encoder_for_qp(self.cfg.qp
                                           + pat["qp_offset"])
            tctx = None
            if self.cfg.tmvp:
                tctx = getattr(self, "_motion_ld", {}).get(
                    rel - deltas[0])
            res, rec_planes = enc.encode_p_frame_multi(
                y, cb, cr, poc=rel, refs=refs, retained=retained,
                tctx=tctx)
            self._dpb_ld[rel] = rec_planes
            if self.cfg.tmvp:
                from kvazaar_jax.bitstream.decoder import _motion_of
                if not hasattr(self, "_motion_ld"):
                    self._motion_ld = {}
                self._motion_ld[rel] = _motion_of(
                    res.frame_data, enc.params, rel, deltas)
                self._motion_ld = {
                    p: v for p, v in self._motion_ld.items()
                    if p == rel or p in needed}
            self._dpb_ld = {p: v for p, v in self._dpb_ld.items()
                            if p == rel or p in needed}
        else:
            rel = self._poc - getattr(self, "_last_idr", 0)
            res = enc.encode_p_frame(y, cb, cr, poc=rel,
                                     ref_poc=rel - 1, qp_ctu=qp_ctu)
        self._note_ctu_weights(res.frame_data, is_intra)
        if self._rc is not None:
            self._rc.update(len(res.nals) * 8, self._rc_lambda)
            self._intra = enc     # DPB owner for the next frame
        h, w = y.shape
        rec_y = res.recon_y[:h, :w]
        rec_cb = rec_cr = None
        p_u = p_v = 0.0
        if res.recon_cb is not None:
            rec_cb = res.recon_cb[:h // 2, :w // 2]
            rec_cr = res.recon_cr[:h // 2, :w // 2]
            p_u = psnr(rec_cb, np.asarray(cb, np.int32),
                       self.cfg.input_bitdepth)
            p_v = psnr(rec_cr, np.asarray(cr, np.int32),
                       self.cfg.input_bitdepth)
        info = FrameInfo(
            poc=self._poc, qp=enc.cfg.qp,
            nal_type=NAL_IDR_W_RADL if is_intra else 1,
            slice_type=SLICE_I if is_intra else 1,
            bits=len(res.nals) * 8,
            psnr_y=psnr(rec_y, np.asarray(y, np.int32),
                        self.cfg.input_bitdepth),
            psnr_u=p_u, psnr_v=p_v)
        self._ckpt.mark_frame(info.poc, info.qp, info.nal_type,
                              info.slice_type, info.bits,
                              (rec_y, rec_cb, rec_cr), res.frame_data)
        chunks += res.nals
        self._poc += 1
        return chunks, info, (rec_y, rec_cb, rec_cr)

    def _stream_info(self, res, poc, qp, is_intra, shape):
        """FrameInfo from device-computed SSEs (no pixel transfer);
        reference reports the same per-frame PSNR triple
        (src/encmain.c:570-640)."""
        import math
        h, w = shape
        peak = (1 << self.cfg.input_bitdepth) - 1

        def p(sse, npix):
            if sse is None:
                return 0.0
            return (10.0 * math.log10(peak * peak * npix
                                      / sse) if sse > 0 else 999.99)
        sse = res.sse or (None, None, None)
        return FrameInfo(
            poc=poc, qp=qp,
            nal_type=NAL_IDR_W_RADL if is_intra else 1,
            slice_type=SLICE_I if is_intra else 1,
            bits=len(res.nals) * 8,
            psnr_y=p(sse[0], h * w),
            psnr_u=p(sse[1], h * w // 4), psnr_v=p(sse[2], h * w // 4))

    def can_pipeline(self) -> bool:
        """True when the config takes the overlapped submit/download/
        finalize path in encode_stream (no cross-frame host
        dependencies)."""
        if self.cfg.cu_qp_delta_active or self._fields:
            # Per-CTU QP maps / field splitting happen per frame on
            # the host.
            return False
        if self.cfg.crypto is not None:
            # The per-picture nonce counter needs stream-order
            # (sequential) emission.
            return False
        if self.cfg.intra_period == 1:
            # Batched all-intra pipeline: SAO is applied inside
            # finalize; only variable-CU trees (per-frame schedules)
            # and RC (per-frame QP) force the scalar path.
            return (self._rc is None
                    and self.cfg.intra_min_cu == self.cfg.intra_max_cu)
        if self._intra._var_inter_active:
            # Variable P/B trees plan per frame on the host.
            return False
        return (not self._gop and self._rc is None and not self._multi
                and not self.cfg.sao)

    def encode_stream(self, frames, need_recon: bool = False):
        """Pipelined streaming encode over an iterable of (y, cb, cr)
        frames.  Yields (annexb_bytes, FrameInfo, recon) in order;
        recon is (None, None, None) unless need_recon or the config
        requires pixels (picture-hash SEI).

        For plain low-delay IPPP configs the three stages — device
        compute (async dispatch), download (worker thread), and host
        CABAC — overlap across consecutive frames, the device
        recasting of the reference's OWF frame pipelining
        (src/encoderstate.c:1259).  GOP / rate-control / multi-ref /
        SAO configs fall back to the per-frame path."""
        if not self.can_pipeline():
            for f in frames:
                for chunks, info, rec in self.encode(*f):
                    yield chunks, info, rec
            for chunks, info, rec in self.flush():
                yield chunks, info, rec
            return
        import queue as _q
        import threading
        import time as _time
        ife = self._intra
        want_pixels = need_recon or self.cfg.hash != "none"
        # Per-stage wall-time accounting (--stats; the reference prints
        # wall/CPU FPS, src/encmain.c:570-640 — here the pipeline
        # stages are the interesting split).
        self.stats = {"submit_s": 0.0, "download_s": 0.0,
                      "finalize_s": 0.0, "frames": 0}
        _stats_lock = threading.Lock()
        # Per-frame download + host finalize both take host time:
        # three combined workers keep the device chain the only serial
        # resource (the count was tuned for a slow host link; on PCIe
        # it is not measured).  Finalize is per-frame independent here (each
        # slice restarts CABAC contexts; the DPB is device-side state
        # threaded through submissions on the main thread).
        n_workers = self.cfg.owf or 3
        dlq: "_q.Queue" = _q.Queue(maxsize=n_workers + 2)
        finq: "_q.Queue" = _q.Queue()
        outq: "_q.Queue" = _q.Queue()

        def downloader():
            # ONE download thread so consecutive P frames in flight
            # can share a single device->host transfer call
            # (download_p_many).
            while True:
                item = dlq.get()
                if item is None:
                    return
                t0 = _time.monotonic()
                try:
                    seq, kind, handle, metas = item
                    if kind == "i":
                        dl = ife.download_frames(handle)
                        finq.put((seq, "i", dl, metas))
                    else:
                        batch = [item]
                        while len(batch) < 4:
                            try:
                                nxt = dlq.get_nowait()
                            except _q.Empty:
                                break
                            if nxt is None or nxt[1] != "p":
                                dlq.put(nxt)   # reorder-safe: only
                                break          # tail sentinel / "i"
                            batch.append(nxt)
                        dls = ife.download_p_many(
                            [it[2] for it in batch])
                        for it, dl in zip(batch, dls):
                            finq.put((it[0], "p", dl, it[3]))
                except BaseException as e:
                    outq.put((item[0], None, item[3], e))
                with _stats_lock:
                    self.stats["download_s"] += _time.monotonic() - t0

        def finalizer():
            while True:
                item = finq.get()
                if item is None:
                    return
                seq, kind, dl, metas = item
                try:
                    t1 = _time.monotonic()
                    if kind == "i":
                        res = ife.finalize_downloaded(
                            dl, need_recon=want_pixels)
                    else:
                        (poc, rel, shape), = metas
                        r0, _recs = ife.finalize_p_downloaded(
                            dl, poc=rel, ref_pocs=[rel - 1],
                            multi=False, need_recon=want_pixels)
                        res = [r0]
                    with _stats_lock:
                        self.stats["finalize_s"] += \
                            _time.monotonic() - t1
                        self.stats["frames"] += len(metas)
                    outq.put((seq, res, metas, None))
                except BaseException as e:   # surface on main thread
                    outq.put((seq, None, metas, e))

        dl_th = threading.Thread(target=downloader)
        fin_ths = [threading.Thread(target=finalizer)
                   for _ in range(n_workers)]
        workers = [dl_th] + fin_ths
        for th in workers:
            th.start()
        period = self.cfg.intra_period
        inflight = 0
        dpb = None
        seq_submit = 0
        seq_next = [0]
        reorder = {}

        def emit(res, poc, rel, shape):
            chunks = self._au_prefix(SLICE_I if rel == 0 else SLICE_P)
            h, w = shape
            rec = (None, None, None)
            if want_pixels and res.recon_y is not None:
                rec = (res.recon_y[:h, :w],
                       None if res.recon_cb is None
                       else res.recon_cb[:h // 2, :w // 2],
                       None if res.recon_cr is None
                       else res.recon_cr[:h // 2, :w // 2])
            info = self._stream_info(res, poc, self.cfg.qp,
                                     rel == 0, shape)
            self._ckpt.mark_frame(info.poc, info.qp, info.nal_type,
                                  info.slice_type, info.bits, rec,
                                  res.frame_data)
            return chunks + res.nals, info, rec

        def finalize_batch():
            # Workers complete out of order; emit in submission order.
            while seq_next[0] not in reorder:
                seq, res, metas, err = outq.get()
                reorder[seq] = (res, metas, err)
            res, metas, err = reorder.pop(seq_next[0])
            seq_next[0] += 1
            if err is not None:
                raise err
            return [emit(r, poc, rel, shape)
                    for r, (poc, rel, shape) in zip(res, metas)]

        batch_n = 8 if period == 1 else 1
        batch = []

        def submit_batch():
            nonlocal dpb, inflight
            t0 = _time.monotonic()
            metas = []
            for (y, cb, cr) in batch:
                p = self._poc
                if (p == 0 or period == 1
                        or (period > 1 and p % period == 0)):
                    self._last_idr = p
                rel = p - getattr(self, "_last_idr", 0)
                metas.append((p, rel, y.shape))
                self._poc += 1
            if len(batch) == 1 and metas[0][1] > 0:
                handle = ife.submit_p(*batch[0],
                                      [(metas[0][1] - 1, dpb)])
                dpb = handle[2]
                kind = "p"
            else:
                handle = ife.submit_frames(batch)
                recs = handle[1][2]
                dpb = (recs[0][-1],
                       recs[1][-1] if ife.chroma else None,
                       recs[2][-1] if ife.chroma else None)
                kind = "i"
            nonlocal seq_submit
            dlq.put((seq_submit, kind, handle, metas))
            seq_submit += 1
            batch.clear()
            inflight += 1
            with _stats_lock:
                self.stats["submit_s"] += _time.monotonic() - t0

        try:
            for f in frames:
                batch.append(f)
                if len(batch) == batch_n:
                    submit_batch()
                    if inflight > n_workers:
                        for r in finalize_batch():
                            yield r
                        inflight -= 1
            if batch:
                submit_batch()
            while inflight:
                for r in finalize_batch():
                    yield r
                inflight -= 1
            if dpb is not None:
                # Leave the device-side DPB where a later per-frame
                # encode() call expects it.
                ife._dpb = dpb
        finally:
            dlq.put(None)
            dl_th.join()
            for _ in fin_ths:
                finq.put(None)
            for th in fin_ths:
                th.join()

    def feed(self, y=None, cb=None, cr=None):
        """Reference-shaped async feed/drain (kvazaar_encode,
        src/kvazaar.c:225): feed ONE picture (or None to flush) and
        receive a list of finished results — possibly empty while the
        pipeline fills (the OWF delay), possibly several at the end.

        A lazy pipelined generator drives encode_stream underneath, so
        device compute, downloads, and host CABAC of different
        frames overlap exactly as in the streaming path."""
        import queue as _q
        import threading
        if not hasattr(self, "_feed_q"):
            self._feed_q = _q.Queue(maxsize=1)
            self._feed_out = _q.Queue()
            self._feed_done = object()

            def srcgen():
                while True:
                    item = self._feed_q.get()
                    if item is None:
                        return
                    yield item

            def run():
                try:
                    for r in self.encode_stream(srcgen()):
                        self._feed_out.put(r)
                except BaseException as e:
                    self._feed_out.put(e)
                self._feed_out.put(self._feed_done)

            self._feed_thread = threading.Thread(target=run,
                                                 daemon=True)
            self._feed_thread.start()
            self._feed_open = True
        out = []
        if y is None:
            if self._feed_open:
                self._feed_q.put(None)
                self._feed_open = False
            while True:
                r = self._feed_out.get()
                if r is self._feed_done:
                    self._feed_thread.join()
                    break
                if isinstance(r, BaseException):
                    raise r
                out.append(r)
            return out
        if not self._feed_open:
            raise RuntimeError(
                "feed() after flush: the stream is finished (open a "
                "new Encoder to start another)")
        self._feed_q.put((y, cb, cr))
        while True:
            try:
                r = self._feed_out.get_nowait()
            except _q.Empty:
                break
            if r is self._feed_done:
                break
            if isinstance(r, BaseException):
                raise r
            out.append(r)
        return out

    def encode_many(self, frames):
        """Encode a batch of frames through one vmapped device program
        (all-intra frames are independent).  Returns a list of
        (chunks, FrameInfo, recon) like encode()."""
        results = self._intra.encode_frames(frames)
        out = []
        for (y, cb, cr), res in zip(frames, results):
            chunks = b""
            if not self._wrote_headers:
                chunks += self.headers()
                self._wrote_headers = True
            h, w = y.shape
            rec_y = res.recon_y[:h, :w]
            rec_cb = rec_cr = None
            p_u = p_v = 0.0
            if res.recon_cb is not None:
                rec_cb = res.recon_cb[:h // 2, :w // 2]
                rec_cr = res.recon_cr[:h // 2, :w // 2]
                p_u = psnr(rec_cb, np.asarray(cb, np.int32),
                           self.cfg.input_bitdepth)
                p_v = psnr(rec_cr, np.asarray(cr, np.int32),
                           self.cfg.input_bitdepth)
            info = FrameInfo(
                poc=self._poc, qp=self.cfg.qp,
                nal_type=NAL_IDR_W_RADL, slice_type=SLICE_I,
                bits=len(res.nals) * 8,
                psnr_y=psnr(rec_y, np.asarray(y, np.int32),
                            self.cfg.input_bitdepth),
                psnr_u=p_u, psnr_v=p_v)
            chunks += res.nals
            self._poc += 1
            out.append((chunks, info, (rec_y, rec_cb, rec_cr)))
        return out
