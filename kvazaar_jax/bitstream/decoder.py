"""Conformance-oracle decoder for the bitstreams this encoder emits.

The reference proves conformance by decoding its output with the HM
reference decoder (tests/util.sh:20-55).  No HEVC decoder exists in this
environment, so we implement the decode path ourselves: parse the Annex-B
stream (header fields + CABAC slice data via bitstream/syntax.py), then
reconstruct with the exact-integer ops — independently re-deriving
prediction from *decoded* syntax only.  Encoder recon must equal decoder
recon bit-for-bit; any divergence is a real conformance bug (availability
rules, context drift, arithmetic mismatch).

The reconstruction here deliberately reuses the same wavefront machinery
as the encoder but is driven purely by parsed FrameData (levels + modes),
i.e. it never sees the source pixels.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from kvazaar_jax.bitstream.bits import BitReader, split_annexb
from kvazaar_jax.bitstream.cabac import CabacDecoder
from kvazaar_jax.bitstream.contexts import Contexts
from kvazaar_jax.bitstream.headers import StreamParams
from kvazaar_jax.bitstream.syntax import FrameData, SliceDataDecoder
from kvazaar_jax.constants import SLICE_I
from kvazaar_jax.encoder.geometry import make_intra_plan
from kvazaar_jax.encoder.intra_recon import _blocks_by_step
from kvazaar_jax.ops.intra import predict_modes
from kvazaar_jax.ops.quant import dequantize
from kvazaar_jax.ops.transform import inverse_transform


def _scaling_from_params(p: StreamParams):
    """ScalingLists instance for decode-side dequant, or None."""
    if getattr(p, "scaling_list_mode", 0) == 0:
        return None
    from kvazaar_jax.ops.scaling import ScalingLists
    if p.scaling_list_mode == 1 and p.scaling_custom is not None:
        return ScalingLists("custom", p.scaling_custom[0],
                            p.scaling_custom[1])
    return ScalingLists("default")


def parse_slice_segment(r: BitReader, p: StreamParams, nal_type: int):
    """--slices streams: parse one slice segment header.  Returns
    (info, first_seg, dependent, address) where info is
    parse_slice_header's tuple for independent segments and None for
    dependent ones."""
    first = r.u(1) == 1           # first_slice_segment_in_pic_flag
    if 16 <= nal_type <= 23:
        r.u(1)                    # no_output_of_prior_pics_flag
    assert r.ue() == 0            # slice_pic_parameter_set_id
    dep = False
    addr = 0
    if not first:
        if p.slices == "wpp":
            dep = r.u(1) == 1     # dependent_slice_segment_flag
        pic = p.width_in_ctus * p.height_in_ctus
        nbits = max((pic - 1).bit_length(), 1)
        addr = r.u(nbits)         # slice_segment_address
        if dep:
            if p.wpp or p.tiles_enabled:
                n = r.ue()
                if n:
                    ln = r.ue() + 1
                    for _ in range(n):
                        r.u(ln)
            assert r.bit() == 1
            r.byte_align()
            return None, first, True, addr
    info = _parse_slice_fields(r, p, nal_type)
    return info, first, dep, addr


def parse_slice_header(r: BitReader, p: StreamParams, nal_type: int):
    """Parse the slice headers we emit; returns (slice_type, QP, POC,
    ref_deltas_l0 — the used negative POC deltas in L0 order,
    ref_poc_diff_l1, entry-point offsets)."""
    assert r.u(1) == 1            # first_slice_segment_in_pic_flag
    if 16 <= nal_type <= 23:
        r.u(1)                    # no_output_of_prior_pics_flag
    assert r.ue() == 0            # slice_pic_parameter_set_id
    return _parse_slice_fields(r, p, nal_type)


def _parse_slice_fields(r: BitReader, p: StreamParams, nal_type: int):
    slice_type = r.ue()
    poc = 0
    ref_deltas = [1]
    ref_poc_diff_l1 = 0
    tmvp = False
    if nal_type not in (19, 20):
        poc = r.u(p.log2_max_poc_lsb)
        assert r.u(1) == 0        # short_term_ref_pic_set_sps_flag
        neg = r.ue()              # num_negative_pics
        pos = r.ue()              # num_positive_pics
        assert pos <= 1
        ref_deltas = []
        d = 0
        for _ in range(neg):
            d += r.ue() + 1       # delta_poc_s0_minus1[i]
            if r.u(1):            # used_by_curr_pic_s0_flag
                ref_deltas.append(d)
        if pos:
            ref_poc_diff_l1 = r.ue() + 1
            r.u(1)                # used_by_curr_pic_s1_flag
        if p.tmvp_enabled:
            tmvp = r.u(1) == 1    # slice_temporal_mvp_enabled_flag
    if p.sao_enabled:
        r.u(1)
        if p.chroma_format_idc:
            r.u(1)
    nref_l0 = min(len(ref_deltas), 1) or 1
    if slice_type != 2:
        nref_l0 = 1
        if r.u(1):                # num_ref_idx_active_override_flag
            nref_l0 = r.ue() + 1  # num_ref_idx_l0_active_minus1
            if slice_type == 0:   # B
                assert r.ue() == 0
        if slice_type == 0:       # B
            r.u(1)                # mvd_l1_zero_flag
        if tmvp:
            if slice_type == 0:
                r.u(1)            # collocated_from_l0_flag
            if nref_l0 > 1:
                assert r.ue() == 0   # collocated_ref_idx
        r.ue()                    # five_minus_max_num_merge_cand
    qp = p.qp + r.se()
    if p.sao_enabled or p.deblock_enabled:
        r.u(1)
    entries = []
    if p.wpp or p.tiles_enabled:
        n = r.ue()
        if n:
            ln = r.ue() + 1
            entries = [r.u(ln) + 1 for _ in range(n)]
    assert r.bit() == 1           # byte alignment bit
    r.byte_align()
    ref_deltas = ref_deltas[:nref_l0] if slice_type != 2 else ref_deltas
    return (slice_type, qp, poc, ref_deltas, ref_poc_diff_l1, entries,
            tmvp)


def parse_slice_header_i(r: BitReader, p: StreamParams):
    """Back-compat wrapper: (QP, entry offsets) of an IDR I slice."""
    st, qp, _poc, _rpd, _rpd1, entries, _t = parse_slice_header(r, p,
                                                                19)
    assert st == 2
    return qp, entries


def decode_stream(stream: bytes, params: StreamParams):
    """Decode the (subset) stream → list of (recon_y, recon_cb, recon_cr)
    per frame, plus parsed FrameData per frame.  Maintains a 1-picture
    DPB for P slices."""
    from kvazaar_jax.constants import SLICE_B, SLICE_P
    frames = []
    dpb = {}
    col_motion = {}    # poc -> collocated motion grids (TMVP source)
    pend = {}          # --slices picture assembly across NALs

    def _finish_picture(nal_type, slice_type, qp, poc, rpd, rpd1,
                        tmvp, fd):
        if nal_type in (19, 20):
            dpb.clear()
            col_motion.clear()
            poc = 0
        if slice_type == 2:
            col_motion[poc] = None
            recon = reconstruct_parsed(fd, params, qp)
        elif slice_type == SLICE_P:
            if _is_var_tree(fd, params):
                # Variable trees: cell-granularity MV recon + the
                # sequential var reconstruction (TMVP is off here).
                reconstruct_mvs_var(fd, params)
                col_motion[poc] = None
                recon = reconstruct_parsed_var(
                    fd, params, qp, ref=dpb[poc - rpd[0]])
            else:
                tctx = None
                if tmvp and col_motion.get(poc - rpd[0]) is not None:
                    tctx = dict(col_motion[poc - rpd[0]],
                                cur_poc=poc, w=params.width,
                                h=params.height)
                reconstruct_mvs(fd, params, poc, rpd, tctx=tctx)
                col_motion[poc] = _motion_of(fd, params, poc, rpd)
                refs = [dpb[poc - d] for d in rpd]
                recon = reconstruct_parsed_p(
                    fd, params, qp,
                    refs if len(refs) > 1 else refs[0])
        else:
            poc0, poc1 = poc - rpd[0], poc + rpd1
            if _is_var_tree(fd, params):
                reconstruct_mvs_b_var(fd, params, poc, poc0, poc1)
                recon = reconstruct_parsed_var(
                    fd, params, qp, ref_b=(dpb[poc0], dpb[poc1]))
            else:
                reconstruct_mvs_b(fd, params, poc, poc0, poc1)
                recon = reconstruct_parsed_b(
                    fd, params, qp, dpb[poc0], dpb[poc1])
        frames.append((recon, fd))
        dpb[poc] = recon

    def _new_fd(qp):
        chroma = params.chroma_format_idc != 0
        fd = FrameData.empty(params.width, params.height, chroma)
        if getattr(params, "cu_qp_delta", False):
            fd.qp_ctu = np.full((params.height_in_ctus,
                                 params.width_in_ctus), qp, np.int32)
        return fd

    pic_count = [0]

    def _crypto_iv(dec):
        """Per-picture selective-encryption nonce (stream order)."""
        if getattr(params, "crypto_key", None):
            dec.set_crypto_iv(pic_count[0])
        pic_count[0] += 1

    for nal_type, _tid, rbsp in split_annexb(stream):
        if nal_type in (0, 1, 8, 9, 19, 20, 21) \
                and getattr(params, "slices", "none") != "none":
            # Multi-segment pictures: buffer slice-data payloads until
            # the picture's segment count is complete.
            r = BitReader(rbsp)
            info, first, _dep, _addr = parse_slice_segment(
                r, params, nal_type)
            payload = rbsp[r.bit_position // 8:]
            if first:
                pend.clear()
                pend.update(info=info, nal_type=nal_type,
                            segs=[payload])
            else:
                pend["segs"].append(payload)
            expected = (params.height_in_ctus
                        if params.slices == "wpp"
                        else params.tiles[0] * params.tiles[1])
            if len(pend["segs"]) < expected:
                continue
            (slice_type, qp, poc, rpd, rpd1, _entries,
             tmvp) = pend["info"]
            fd = _new_fd(qp)
            nref = len(rpd) if slice_type == SLICE_P else 1
            dec = SliceDataDecoder(
                params, fd, Contexts(slice_type, qp),
                CabacDecoder(BitReader(pend["segs"][0])),
                nref_l0=nref)
            _crypto_iv(dec)
            if params.slices == "wpp":
                dec.decode_row_slices(pend["segs"])
            else:
                dec.decode_tile_slices(pend["segs"])
            _finish_picture(pend["nal_type"], slice_type, qp, poc,
                            rpd, rpd1, tmvp, fd)
            pend.clear()
        elif nal_type in (0, 1, 8, 9, 19, 20, 21):  # TRAIL/RASL/IRAP
            r = BitReader(rbsp)
            (slice_type, qp, poc, rpd, rpd1, entries,
             tmvp) = parse_slice_header(r, params, nal_type)
            fd = _new_fd(qp)
            cab = CabacDecoder(r)
            nref = len(rpd) if slice_type == SLICE_P else 1
            dec = SliceDataDecoder(params, fd,
                                   Contexts(slice_type, qp), cab,
                                   nref_l0=nref)
            _crypto_iv(dec)
            if params.wpp or params.tiles_enabled:
                # The header parse ended byte-aligned; the CabacDecoder
                # init then read 9 bits, so slice data begins at
                # bit_position - 9.
                start = (r.bit_position - 9) // 8
                sizes = entries + [len(rbsp) - start - sum(entries)]
                if params.tiles_enabled and params.wpp:
                    dec.decode_slice_data_tiles_wpp(rbsp, start, sizes)
                elif params.tiles_enabled:
                    dec.decode_slice_data_tiles(rbsp, start, sizes)
                else:
                    dec.decode_slice_data_wpp(rbsp, start, sizes)
            else:
                dec.decode_slice_data()
            _finish_picture(nal_type, slice_type, qp, poc, rpd, rpd1,
                            tmvp, fd)
        elif nal_type == 40:                 # suffix SEI: verify hash
            from kvazaar_jax.bitstream.headers import \
                parse_picture_hash_sei
            import hashlib
            parsed = parse_picture_hash_sei(rbsp)
            if parsed and frames:
                htype, digests = parsed
                from kvazaar_jax.bitstream.headers import \
                    picture_checksum
                rec = frames[-1][0]
                dt = np.uint8 if params.bitdepth <= 8 else np.uint16
                planes = [p_ for p_ in rec if p_ is not None]
                for d, pl in zip(digests, planes):
                    arr = np.ascontiguousarray(pl, dt)
                    if htype == 0:
                        got = hashlib.md5(arr.tobytes()).digest()
                    else:
                        got = picture_checksum(arr, params.bitdepth)
                    if got != d:
                        raise ValueError(
                            "decoded-picture-hash SEI mismatch")
    return frames


def _qp_block_map(fd: FrameData, params: StreamParams, plan, s: int):
    """(By, Bx) block-grid luma QP from the per-CTU effective map, or
    None when cu_qp_delta is off."""
    if fd.qp_ctu is None:
        return None
    by = np.minimum(np.arange(plan.blocks_y) * s // params.ctu_size,
                    fd.qp_ctu.shape[0] - 1)
    bx = np.minimum(np.arange(plan.blocks_x) * s // params.ctu_size,
                    fd.qp_ctu.shape[1] - 1)
    return jnp.asarray(fd.qp_ctu[np.ix_(by, bx)].astype(np.int32))


def _motion_of(fd: FrameData, params: StreamParams, poc: int,
               ref_deltas):
    """Collocated-motion grids of a decoded P frame, for TMVP in later
    pictures (the decoder-side analogue of the cu_array the reference
    keeps per reference picture, src/inter.c:746)."""
    depth = int(fd.depth8[0, 0])
    s = params.ctu_size >> depth
    c8 = s // 8
    inter_map = fd.inter8[::c8, ::c8].astype(bool)
    mv = fd.mv8[::c8, ::c8].astype(np.int32)
    refg = fd.ref8[::c8, ::c8].astype(np.int32)
    ref_pocs = np.array([poc - d for d in ref_deltas], np.int32)
    refpoc = ref_pocs[np.clip(refg, 0, len(ref_deltas) - 1)]
    return dict(poc=poc, cu=s, inter=inter_map, mv=mv, refpoc=refpoc)


def reconstruct_mvs_smp(fd: FrameData, params: StreamParams) -> None:
    """Decode-order MV reconstruction for SMP P frames: per-PU merge /
    AMVP on the 8-cell motion field (inverse of the encoder's
    _merge_amvp_smp; 8.5.3.2 with the 6.4.2 availability rules).
    Fills fd.mv8 region-filled per PU."""
    from kvazaar_jax.encoder.geometry import z_order_index
    from kvazaar_jax.encoder.inter_cands import (amvp_pair_pu_at,
                                                 merge_list_pu_at,
                                                 pu_cell_rects)
    depth = int(fd.depth8[0, 0])
    s = params.ctu_size >> depth
    cells = s // 8
    h8, w8 = fd.inter8.shape
    by, bx = h8 // cells, w8 // cells
    inter8 = fd.inter8.astype(bool)
    mv8 = np.zeros((h8, w8, 2), np.int32)
    per_ctu = max(64 // s, 1)
    zs = sorted(((z_order_index(zx, zy), zy, zx)
                 for zy in range(per_ctu) for zx in range(per_ctu)))
    for ty in range(-(-by // per_ctu)):
        for tx in range(-(-bx // per_ctu)):
            for _z, zy, zx in zs:
                cy, cx = ty * per_ctu + zy, tx * per_ctu + zx
                if cy >= by or cx >= bx:
                    continue
                by8, bx8 = cy * cells, cx * cells
                if not inter8[by8, bx8]:
                    continue
                p = int(fd.part8[by8, bx8])
                rects = [r + (i,) for i, r in enumerate(
                    pu_cell_rects(by8, bx8, cells, p))]
                for (ry, rx, rh, rw, pu_idx) in rects:
                    midx = int(fd.merge8[ry, rx])
                    if midx >= 0:
                        mlist = merge_list_pu_at(
                            inter8, mv8, ry, rx, rh, rw, p, pu_idx,
                            cells, cu_yx=(by8, bx8))
                        v = mlist[midx]
                    else:
                        pair = amvp_pair_pu_at(
                            inter8, mv8, ry, rx, rh, rw, p, pu_idx,
                            cells, cu_yx=(by8, bx8))
                        mvp = pair[int(fd.mvp8[ry, rx])]
                        v = (mvp[0] + int(fd.mvd8[ry, rx, 0]),
                             mvp[1] + int(fd.mvd8[ry, rx, 1]))
                    mv8[ry:ry + rh, rx:rx + rw] = v
    fd.mv8[:] = mv8


def reconstruct_mvs(fd: FrameData, params: StreamParams,
                    poc: int = None, ref_deltas=None,
                    tctx=None) -> None:
    """Sequential decode-order MV reconstruction for a P frame
    (8.5.3.2): merge index → candidate list, or AMVP + mvd.  With
    multiple L0 references (`ref_deltas` longer than 1) candidates
    carry ref indices and AMVP applies POC scaling (8.5.3.2.7).
    Fills fd.mv8 (and fd.ref8 for merge CUs) in place."""
    if fd.part8 is not None and fd.part8.any():
        return reconstruct_mvs_smp(fd, params)
    from kvazaar_jax.encoder.geometry import make_intra_plan
    from kvazaar_jax.encoder.inter_cands import (
        amvp_pair_at, amvp_pair_p_multiref_at, merge_list_at,
        merge_list_p_multiref_at)
    depth = int(fd.depth8[0, 0])
    s = params.ctu_size >> depth
    c8 = s // 8
    chroma = params.chroma_format_idc != 0
    plan = make_intra_plan(params.width, params.height, s, chroma,
                           tiles=params.tiles)
    by, bx = plan.blocks_y, plan.blocks_x
    inter_map = fd.inter8[::c8, ::c8].astype(bool)
    mv = np.zeros((by, bx, 2), np.int32)
    multi = (ref_deltas is not None and len(ref_deltas) > 1) \
        or tctx is not None
    nref = len(ref_deltas) if ref_deltas else 1
    refg = np.zeros((by, bx), np.int32)
    if multi:
        refg[:] = fd.ref8[::c8, ::c8]
        ref_pocs = [poc - d for d in ref_deltas]
        if tctx is not None:
            tctx = dict(tctx, cur_poc=poc)
    order = np.argsort(
        (plan.step_of_block.astype(np.int64) * (by * bx)
         + np.arange(by * bx).reshape(by, bx)).ravel(), kind="stable")
    # Decode order: any topological order consistent with availability
    # works for MV reconstruction; wavefront step order is one.
    for bid in order:
        y, x = divmod(int(bid), bx)
        if not inter_map[y, x]:
            continue
        midx = int(fd.merge8[y * c8, x * c8])
        if not multi:
            if midx >= 0:
                cands = merge_list_at(inter_map, mv, plan.avail, y, x)
                mv[y, x] = cands[midx]
            else:
                pair = amvp_pair_at(inter_map, mv, plan.avail, y, x)
                mvp = pair[int(fd.mvp8[y * c8, x * c8])]
                mv[y, x] = (mvp[0] + fd.mvd8[y * c8, x * c8][0],
                            mvp[1] + fd.mvd8[y * c8, x * c8][1])
            continue
        if midx >= 0:
            cands = merge_list_p_multiref_at(inter_map, refg, mv,
                                             plan.avail, y, x, nref,
                                             tctx=tctx,
                                             ref_pocs=ref_pocs, cu=s)
            r, v = cands[midx]
            refg[y, x] = r
            mv[y, x] = v
        else:
            r = int(refg[y, x])
            pair = amvp_pair_p_multiref_at(inter_map, refg, mv,
                                           plan.avail, y, x, r, poc,
                                           ref_pocs, tctx=tctx, cu=s)
            mvp = pair[int(fd.mvp8[y * c8, x * c8])]
            mv[y, x] = (mvp[0] + fd.mvd8[y * c8, x * c8][0],
                        mvp[1] + fd.mvd8[y * c8, x * c8][1])
    fd.mv8[:] = np.kron(mv, np.ones((c8, c8, 1), np.int32)).reshape(
        fd.mv8.shape)
    if multi:
        fd.ref8[:] = np.kron(refg, np.ones((c8, c8), np.int32)) \
            .astype(np.uint8)


def reconstruct_mvs_b(fd: FrameData, params: StreamParams, poc: int,
                      poc0: int, poc1: int) -> None:
    """Sequential decode-order MV reconstruction for a B slice:
    merge index → full-motion candidate (8.5.3.2.3) or AMVP + mvd per
    list.  Fills fd.mv8/mv8_l1 and, for merge CUs, fd.dir8 (the
    inter_pred_idc is not signalled for merge)."""
    from kvazaar_jax.encoder.geometry import make_intra_plan
    from kvazaar_jax.encoder.inter_cands import (amvp_pair_b_at,
                                                 merge_list_b_at)
    depth = int(fd.depth8[0, 0])
    s = params.ctu_size >> depth
    c8 = s // 8
    chroma = params.chroma_format_idc != 0
    plan = make_intra_plan(params.width, params.height, s, chroma,
                           tiles=params.tiles)
    by, bx = plan.blocks_y, plan.blocks_x
    inter_map = fd.inter8[::c8, ::c8].astype(bool)
    dirs = fd.dir8[::c8, ::c8].astype(np.int32)
    mv0 = np.zeros((by, bx, 2), np.int32)
    mv1 = np.zeros((by, bx, 2), np.int32)
    order = np.argsort(
        (plan.step_of_block.astype(np.int64) * (by * bx)
         + np.arange(by * bx).reshape(by, bx)).ravel(), kind="stable")
    for bid in order:
        y, x = divmod(int(bid), bx)
        if not inter_map[y, x]:
            continue
        midx = int(fd.merge8[y * c8, x * c8])
        if midx >= 0:
            mlist = merge_list_b_at(inter_map, dirs, mv0, mv1,
                                    plan.avail, y, x, (poc0, poc1))
            d, m0, m1 = mlist[midx]
            dirs[y, x] = d
            fd.dir8[y * c8:(y + 1) * c8,
                    x * c8:(x + 1) * c8] = d
            if d != 1:
                mv0[y, x] = m0
            if d != 0:
                mv1[y, x] = m1
            continue
        d = int(dirs[y, x])
        if d != 1:
            pair = amvp_pair_b_at(inter_map, dirs, mv0, mv1,
                                  plan.avail, y, x, 0, poc,
                                  (poc0, poc1))
            mvp = pair[int(fd.mvp8[y * c8, x * c8])]
            mv0[y, x] = (mvp[0] + fd.mvd8[y * c8, x * c8][0],
                         mvp[1] + fd.mvd8[y * c8, x * c8][1])
        if d != 0:
            pair = amvp_pair_b_at(inter_map, dirs, mv0, mv1,
                                  plan.avail, y, x, 1, poc,
                                  (poc0, poc1))
            mvp = pair[int(fd.mvp8_l1[y * c8, x * c8])]
            mv1[y, x] = (mvp[0] + fd.mvd8_l1[y * c8, x * c8][0],
                         mvp[1] + fd.mvd8_l1[y * c8, x * c8][1])
    fd.mv8[:] = np.kron(mv0, np.ones((c8, c8, 1), np.int32)).reshape(
        fd.mv8.shape)
    fd.mv8_l1[:] = np.kron(mv1, np.ones((c8, c8, 1), np.int32)) \
        .reshape(fd.mv8_l1.shape)


def reconstruct_parsed_b(fd: FrameData, params: StreamParams, qp: int,
                         ref0, ref1):
    """B-frame reconstruction: per-CU L0/L1/BI prediction with the
    14-bit bipred averaging (8.5.4.2.3.2)."""
    from kvazaar_jax.encoder.frame_encoder import (chroma_qp,
                                                   compute_bs_maps_b)
    from kvazaar_jax.encoder.inter_search import bi_mc_planes
    from kvazaar_jax.ops.deblock import deblock_frame
    depth = int(fd.depth8[0, 0])
    s = params.ctu_size >> depth
    c8 = s // 8
    chroma = params.chroma_format_idc != 0
    plan = make_intra_plan(params.width, params.height, s, chroma,
                           tiles=params.tiles)
    modes = fd.mode4[::s // 4, ::s // 4].astype(np.int32)
    inter_map = fd.inter8[::c8, ::c8].astype(bool)
    dirs = jnp.asarray(fd.dir8[::c8, ::c8].astype(np.int32))
    mv0 = jnp.asarray(fd.mv8[::c8, ::c8].astype(np.int32))
    mv1 = jnp.asarray(fd.mv8_l1[::c8, ::c8].astype(np.int32))

    def planes(ref):
        return tuple(None if p is None else
                     jnp.asarray(np.asarray(p, np.int32)) for p in ref)

    mc_y, mc_cb, mc_cr = bi_mc_planes(planes(ref0), planes(ref1), mv0,
                                      mv1, dirs, plan, params.bitdepth)
    lv_y = _blocks_by_step(fd.coeff_y, plan.luma, plan)
    lv_cb = lv_cr = None
    if chroma:
        lv_cb = _blocks_by_step(fd.coeff_cb, plan.chroma, plan)
        lv_cr = _blocks_by_step(fd.coeff_cr, plan.chroma, plan)
    out = _decode_recon_impl(
        plan, s, chroma, qp, chroma_qp(qp), params.bitdepth,
        jnp.asarray(lv_y),
        None if lv_cb is None else jnp.asarray(lv_cb),
        None if lv_cr is None else jnp.asarray(lv_cr),
        jnp.asarray(modes), is_inter=jnp.asarray(inter_map),
        mc_y=mc_y, mc_cb=mc_cb, mc_cr=mc_cr,
        lossless=params.transquant_bypass,
        scaling=_scaling_from_params(params))
    rec_y, rec_cb, rec_cr = out
    if params.deblock_enabled:
        cbf_blk = np.any(
            fd.coeff_y.reshape(plan.blocks_y, s, plan.blocks_x, s) != 0,
            axis=(1, 3))
        bs_v, bs_h = compute_bs_maps_b(jnp.asarray(inter_map),
                                       jnp.asarray(cbf_blk), dirs,
                                       mv0, mv1)
        rec_y, rec_cb, rec_cr = deblock_frame(
            rec_y, rec_cb, rec_cr, qp, s, params.bitdepth,
            params.deblock_beta_offset_div2,
            params.deblock_tc_offset_div2, bs_v=bs_v, bs_h=bs_h)
    rec_y = np.asarray(rec_y)
    rec_cb = None if rec_cb is None else np.asarray(rec_cb)
    rec_cr = None if rec_cr is None else np.asarray(rec_cr)
    return _apply_sao_parsed(fd, params, rec_y, rec_cb, rec_cr)


def reconstruct_parsed_p(fd: FrameData, params: StreamParams, qp: int,
                         ref):
    """P-frame reconstruction from parsed syntax + reference planes.

    ref: one (y, cb, cr) tuple, or a list of them (L0 order) for
    multi-ref slices — fd.ref8 then selects per block."""
    from kvazaar_jax.encoder.frame_encoder import (chroma_qp,
                                                   compute_bs_maps)
    from kvazaar_jax.encoder.inter_search import mc_planes
    from kvazaar_jax.ops.deblock import deblock_frame
    depth = int(fd.depth8[0, 0])
    s = params.ctu_size >> depth
    c8 = s // 8
    chroma = params.chroma_format_idc != 0
    plan = make_intra_plan(params.width, params.height, s, chroma,
                           tiles=params.tiles)
    modes = fd.mode4[::s // 4, ::s // 4].astype(np.int32)
    inter_map = fd.inter8[::c8, ::c8].astype(bool)
    mv = fd.mv8[::c8, ::c8].astype(np.int32)
    smp = fd.part8 is not None and fd.part8.any()

    refs = ref if isinstance(ref, list) else [ref]
    ref_grid = None
    rg = None
    if len(refs) > 1:
        rg = fd.ref8[::c8, ::c8].astype(np.int32)
        ref_grid = jnp.asarray(rg)

    def stack(idx):
        if refs[0][idx] is None:
            return None
        if len(refs) == 1:
            return jnp.asarray(np.asarray(refs[0][idx], np.int32))
        return jnp.asarray(np.stack(
            [np.asarray(r[idx], np.int32) for r in refs]))

    if smp:
        from kvazaar_jax.encoder.inter_search import mc_planes_cells
        mc_y, mc_cb, mc_cr = mc_planes_cells(
            stack(0), stack(1), stack(2),
            jnp.asarray(fd.mv8.astype(np.int32)), params.bitdepth)
    else:
        mc_y, mc_cb, mc_cr = mc_planes(
            stack(0), stack(1), stack(2),
            jnp.asarray(mv), plan, params.bitdepth, ref_grid=ref_grid)

    lv_y = _blocks_by_step(fd.coeff_y, plan.luma, plan)
    lv_cb = lv_cr = None
    if chroma:
        lv_cb = _blocks_by_step(fd.coeff_cb, plan.chroma, plan)
        lv_cr = _blocks_by_step(fd.coeff_cr, plan.chroma, plan)

    qp_blk = _qp_block_map(fd, params, plan, s)
    out = _decode_recon_impl(
        plan, s, chroma, qp, chroma_qp(qp), params.bitdepth,
        jnp.asarray(lv_y),
        None if lv_cb is None else jnp.asarray(lv_cb),
        None if lv_cr is None else jnp.asarray(lv_cr),
        jnp.asarray(modes), is_inter=jnp.asarray(inter_map),
        mc_y=mc_y, mc_cb=mc_cb, mc_cr=mc_cr,
        lossless=params.transquant_bypass,
        scaling=_scaling_from_params(params), qp_map=qp_blk)
    rec_y, rec_cb, rec_cr = out
    if params.deblock_enabled and smp:
        from kvazaar_jax.encoder.frame_encoder import \
            compute_bs_maps_smp
        cells = s // 8
        cbf_blk = np.any(
            fd.coeff_y.reshape(plan.blocks_y, s, plan.blocks_x, s) != 0,
            axis=(1, 3))
        cbf8 = np.kron(cbf_blk, np.ones((cells, cells), bool))
        partc = np.kron(fd.part8[::cells, ::cells].astype(np.int32),
                        np.ones((cells, cells), np.int32))
        bs_v8, bs_h8 = compute_bs_maps_smp(
            jnp.asarray(fd.inter8.astype(bool)), jnp.asarray(cbf8),
            jnp.asarray(fd.mv8.astype(np.int32)), s,
            part8=jnp.asarray(partc))
        rec_y, rec_cb, rec_cr = deblock_frame(
            rec_y, rec_cb, rec_cr, qp, 8, params.bitdepth,
            params.deblock_beta_offset_div2,
            params.deblock_tc_offset_div2, bs_v=bs_v8, bs_h=bs_h8)
    elif params.deblock_enabled:
        cbf_blk = np.any(
            fd.coeff_y.reshape(plan.blocks_y, s, plan.blocks_x, s) != 0,
            axis=(1, 3))
        bs_v, bs_h = compute_bs_maps(
            jnp.asarray(inter_map), jnp.asarray(cbf_blk),
            jnp.asarray(mv),
            ref=None if rg is None else jnp.asarray(rg))
        rec_y, rec_cb, rec_cr = deblock_frame(
            rec_y, rec_cb, rec_cr, qp, s, params.bitdepth,
            params.deblock_beta_offset_div2,
            params.deblock_tc_offset_div2, bs_v=bs_v, bs_h=bs_h,
            qp_map=qp_blk)
    rec_y = np.asarray(rec_y)
    rec_cb = None if rec_cb is None else np.asarray(rec_cb)
    rec_cr = None if rec_cr is None else np.asarray(rec_cr)
    return _apply_sao_parsed(fd, params, rec_y, rec_cb, rec_cr)


def reconstruct_parsed(fd: FrameData, params: StreamParams, qp: int):
    """Wavefront reconstruction purely from parsed syntax.  Uniform-CU
    frames take the fast batched path; variable trees take the
    sequential pure-numpy path (fully independent of the encoder's
    ops)."""
    from kvazaar_jax.encoder.frame_encoder import chroma_qp
    depth = int(fd.depth8[0, 0])
    if depth == 0 or not np.all(fd.depth8 == depth) or (
            fd.nxn8 is not None and fd.nxn8.any()):
        # Variable trees and 64x64 CUs (which reconstruct as four
        # 32x32 TBs) take the sequential oracle path.
        return reconstruct_parsed_var(fd, params, qp)
    s = params.ctu_size >> depth
    chroma = params.chroma_format_idc != 0
    plan = make_intra_plan(params.width, params.height, s, chroma,
                           tiles=params.tiles)
    modes = fd.mode4[::s // 4, ::s // 4].astype(np.int32)
    cmodes = None
    if chroma and fd.cmode4 is not None:
        # Explicit chroma modes (--rd 3): parsed actual modes; equal to
        # the luma modes for all-DM streams (pass None then so the
        # traced program is unchanged).
        cm = fd.cmode4[::s // 8, ::s // 8].astype(np.int32)
        cm = np.where(cm == 255, modes, cm)
        if not np.array_equal(cm, modes):
            cmodes = jnp.asarray(cm)

    lv_y = _blocks_by_step(fd.coeff_y, plan.luma, plan)
    lv_cb = lv_cr = None
    if chroma:
        lv_cb = _blocks_by_step(fd.coeff_cb, plan.chroma, plan)
        lv_cr = _blocks_by_step(fd.coeff_cr, plan.chroma, plan)

    qp_blk = _qp_block_map(fd, params, plan, s)
    out = _decode_recon_jit(plan, s, chroma, qp, chroma_qp(qp),
                            params.bitdepth, jnp.asarray(lv_y),
                            None if lv_cb is None else jnp.asarray(lv_cb),
                            None if lv_cr is None else jnp.asarray(lv_cr),
                            jnp.asarray(modes),
                            lossless=params.transquant_bypass,
                            scaling=_scaling_from_params(params),
                            qp_map=qp_blk, cmodes=cmodes,
                            rdpcm=params.transquant_bypass
                            and params.implicit_rdpcm)
    rec_y, rec_cb, rec_cr = out[0], out[1], out[2]
    if params.deblock_enabled:
        from kvazaar_jax.ops.deblock import deblock_frame
        rec_y, rec_cb, rec_cr = deblock_frame(
            rec_y, rec_cb, rec_cr, qp, s, params.bitdepth,
            params.deblock_beta_offset_div2,
            params.deblock_tc_offset_div2, qp_map=qp_blk)
    rec_y = np.asarray(rec_y)
    rec_cb = None if rec_cb is None else np.asarray(rec_cb)
    rec_cr = None if rec_cr is None else np.asarray(rec_cr)
    return _apply_sao_parsed(fd, params, rec_y, rec_cb, rec_cr)


def _apply_sao_parsed(fd: FrameData, params: StreamParams, rec_y,
                      rec_cb, rec_cr):
    """Apply parsed per-CTU SAO params after deblocking (8.7.3)."""
    if not params.sao_enabled:
        return rec_y, rec_cb, rec_cr
    from kvazaar_jax.ops.sao import apply_sao_plane
    t = jnp.asarray(fd.sao_type.astype(np.int32))
    eo = jnp.asarray(fd.sao_eo.astype(np.int32))
    bp = jnp.asarray(fd.sao_bp.astype(np.int32))
    off = jnp.asarray(fd.sao_off.astype(np.int32))
    ry = apply_sao_plane(jnp.asarray(np.asarray(rec_y, np.int32)),
                         t[:, :, 0], eo[:, :, 0], bp[:, :, 0],
                         off[:, :, 0], 64, params.bitdepth)
    rcb = rcr = None
    if rec_cb is not None:
        rcb = apply_sao_plane(jnp.asarray(np.asarray(rec_cb, np.int32)),
                              t[:, :, 1], eo[:, :, 1], bp[:, :, 1],
                              off[:, :, 1], 32, params.bitdepth)
        rcr = apply_sao_plane(jnp.asarray(np.asarray(rec_cr, np.int32)),
                              t[:, :, 1], eo[:, :, 1], bp[:, :, 2],
                              off[:, :, 2], 32, params.bitdepth)
    dt = np.uint8 if params.bitdepth <= 8 else np.uint16
    return (np.asarray(ry, dt),
            None if rcb is None else np.asarray(rcb, dt),
            None if rcr is None else np.asarray(rcr, dt))


def _np_intra_pred(refs: np.ndarray, mode: int, s: int, luma: bool,
                   bitdepth: int) -> np.ndarray:
    """Pure-numpy intra prediction of one block from a substituted
    spec-order ref vector (int64 arithmetic; shares no code with the
    encoder's einsum path — this is the independent oracle)."""
    from kvazaar_jax.ops.intra import mode_weights_np
    w, shifts = mode_weights_np(s, luma)
    if luma and s >= 8:
        f = (refs[:-2] + 2 * refs[1:-1] + refs[2:] + 2) >> 2
        filt = np.concatenate([refs[:1], f, refs[-1:]])
    else:
        filt = refs
    refs2 = np.concatenate([refs, filt]).astype(np.int64)
    sh = int(shifts[mode])
    pred = ((w[mode].astype(np.int64) @ refs2 + (1 << (sh - 1)))
            >> sh).reshape(s, s)
    if not luma or s >= 32:
        return pred
    maxv = (1 << bitdepth) - 1
    top = refs[2 * s + 1: 3 * s + 1].astype(np.int64)
    left = refs[s: 2 * s][::-1].astype(np.int64)
    corner = int(refs[2 * s])
    if mode == 1:
        dc = pred[s // 2, s // 2]
        row0 = (top + 3 * dc + 2) >> 2
        col0 = (left + 3 * dc + 2) >> 2
        c00 = (left[0] + 2 * dc + top[0] + 2) >> 2
        pred[0, :] = row0
        pred[:, 0] = col0
        pred[0, 0] = c00
    elif mode == 10:
        pred[0, :] = np.clip(left[0] + ((top - corner) >> 1), 0, maxv)
    elif mode == 26:
        pred[:, 0] = np.clip(top[0] + ((left - corner) >> 1), 0, maxv)
    return pred


def _np_inv_residual(levels: np.ndarray, s: int, qp: int,
                     bitdepth: int, m=None, dst: bool = False,
                     ts: bool = False) -> np.ndarray:
    """Pure-numpy dequant + inverse transform (8.6.3/8.6.4, int64).
    m: optional (N, N) scaling-list matrix; dst: DST-VII (4x4 intra
    luma TBs, 8.6.4.1); ts: transform_skip (8.6.4.2: r = d << 7, then
    the bdShift rounding — no transform)."""
    from kvazaar_jax.ops.quant import quant_params
    from kvazaar_jax.ops.transform import dct_matrix_np, dst4_matrix_np
    log2n = s.bit_length() - 1
    _, _, inv_scale, shift = quant_params(qp, log2n, bitdepth)
    lv = levels.astype(np.int64)
    if m is not None:
        sh = shift - qp // 6
        prod = lv * (inv_scale * m.astype(np.int64))
        if sh > 0:
            dq = (prod + (1 << (sh - 1))) >> sh
        else:
            dq = np.clip(prod, -32768, 32767) << (-sh)
    else:
        dq = (lv * (inv_scale << (qp // 6))
              + (1 << (shift - 5))) >> (shift - 4)
    dq = np.clip(dq, -32768, 32767)
    sh2 = 20 - bitdepth
    if ts:
        r = ((dq << 7) + (1 << (sh2 - 1))) >> sh2
        return np.clip(r, -32768, 32767)
    t = (dst4_matrix_np() if dst else dct_matrix_np(s)).astype(np.int64)
    e = (t.T @ dq + 64) >> 7
    e = np.clip(e, -32768, 32767)
    r = (e @ t + (1 << (sh2 - 1))) >> sh2
    return np.clip(r, -32768, 32767)


def _is_var_tree(fd: FrameData, params: StreamParams) -> bool:
    """True when the frame carries a non-uniform quadtree (or 64 CUs),
    i.e. the encoder used the variable-CU path."""
    depth = int(fd.depth8[0, 0])
    return depth == 0 or not np.all(fd.depth8 == depth)


def reconstruct_mvs_var(fd: FrameData, params: StreamParams) -> None:
    """Decode-order MV reconstruction for a variable-tree P frame
    (single L0 reference): per-CU merge/AMVP with the cell-granularity
    candidate rules (6.4.2; cell-level z keys linearize any tree).
    Fills fd.mv8 CU-filled in place."""
    from kvazaar_jax.encoder.inter_cands import (amvp_pair_pu_at,
                                                 merge_list_pu_at)
    from kvazaar_jax.encoder.var_schedule import _enumerate_cus
    h8, w8 = fd.inter8.shape
    size8 = (params.ctu_size >> fd.depth8.astype(np.int32))
    inter8 = fd.inter8.astype(bool)
    mv8 = np.zeros((h8, w8, 2), np.int32)
    for (x0, y0, s) in _enumerate_cus(size8):
        cy8, cx8 = y0 // 8, x0 // 8
        if not inter8[cy8, cx8]:
            continue
        cells = s // 8
        midx = int(fd.merge8[cy8, cx8])
        if midx >= 0:
            mlist = merge_list_pu_at(inter8, mv8, cy8, cx8, cells,
                                     cells, 0, 0, 1,
                                     cu_yx=(cy8, cx8))
            v = mlist[midx]
        else:
            pair = amvp_pair_pu_at(inter8, mv8, cy8, cx8, cells,
                                   cells, 0, 0, 1, cu_yx=(cy8, cx8))
            mvp = pair[int(fd.mvp8[cy8, cx8])]
            v = (mvp[0] + int(fd.mvd8[cy8, cx8, 0]),
                 mvp[1] + int(fd.mvd8[cy8, cx8, 1]))
        mv8[cy8:cy8 + cells, cx8:cx8 + cells] = v
    fd.mv8[:] = mv8


def reconstruct_mvs_b_var(fd: FrameData, params: StreamParams,
                          poc: int, poc0: int, poc1: int) -> None:
    """Decode-order MV reconstruction for a variable-tree B frame
    (one reference per list).  Fills fd.mv8/mv8_l1/dir8 in place."""
    from kvazaar_jax.encoder.inter_cands import (amvp_pair_b_pu_at,
                                                 merge_list_b_pu_at)
    from kvazaar_jax.encoder.var_schedule import _enumerate_cus
    h8, w8 = fd.inter8.shape
    size8 = (params.ctu_size >> fd.depth8.astype(np.int32))
    inter8 = fd.inter8.astype(bool)
    dirs8 = fd.dir8.astype(np.int32).copy()
    mv0 = np.zeros((h8, w8, 2), np.int32)
    mv1 = np.zeros((h8, w8, 2), np.int32)
    for (x0, y0, s) in _enumerate_cus(size8):
        cy8, cx8 = y0 // 8, x0 // 8
        if not inter8[cy8, cx8]:
            continue
        cells = s // 8
        midx = int(fd.merge8[cy8, cx8])
        if midx >= 0:
            mlist = merge_list_b_pu_at(inter8, dirs8, mv0, mv1, cy8,
                                       cx8, cells, (poc0, poc1))
            d, m0, m1 = mlist[midx]
            dirs8[cy8:cy8 + cells, cx8:cx8 + cells] = d
            if d != 1:
                mv0[cy8:cy8 + cells, cx8:cx8 + cells] = m0
            if d != 0:
                mv1[cy8:cy8 + cells, cx8:cx8 + cells] = m1
            continue
        d = int(dirs8[cy8, cx8])
        dirs8[cy8:cy8 + cells, cx8:cx8 + cells] = d
        if d != 1:
            pair = amvp_pair_b_pu_at(inter8, dirs8, mv0, mv1, cy8,
                                     cx8, cells, 0, poc, (poc0, poc1))
            mvp = pair[int(fd.mvp8[cy8, cx8])]
            mv0[cy8:cy8 + cells, cx8:cx8 + cells] = (
                mvp[0] + int(fd.mvd8[cy8, cx8, 0]),
                mvp[1] + int(fd.mvd8[cy8, cx8, 1]))
        if d != 0:
            pair = amvp_pair_b_pu_at(inter8, dirs8, mv0, mv1, cy8,
                                     cx8, cells, 1, poc, (poc0, poc1))
            mvp = pair[int(fd.mvp8_l1[cy8, cx8])]
            mv1[cy8:cy8 + cells, cx8:cx8 + cells] = (
                mvp[0] + int(fd.mvd8_l1[cy8, cx8, 0]),
                mvp[1] + int(fd.mvd8_l1[cy8, cx8, 1]))
    fd.mv8[:] = mv0
    fd.mv8_l1[:] = mv1
    fd.dir8[:] = dirs8.astype(np.uint8)


def reconstruct_parsed_var(fd: FrameData, params: StreamParams,
                           qp: int, ref=None, ref_b=None):
    """Sequential per-CU reconstruction for variable-CU frames —
    a direct transcription of the decoding process (8.4.4), one CU at a
    time in z-scan order, entirely in numpy for the intra path.

    P frames pass `ref` ((y, cb, cr) planes); B frames `ref_b`
    ((ref0, ref1)); inter CUs take a full-frame cell-granularity MC
    prediction (fd.mv8/mv8_l1/dir8 must be reconstructed first)."""
    _sl_var = _scaling_from_params(params)
    from kvazaar_jax.encoder.frame_encoder import chroma_qp
    from kvazaar_jax.encoder.geometry import z_order_index
    w, h = params.width, params.height
    chroma = params.chroma_format_idc != 0
    h8, w8 = h // 8, w // 8
    sizes8 = (params.ctu_size >> fd.depth8.astype(np.int32)) // 8
    nxn = (fd.nxn8 if fd.nxn8 is not None
           else np.zeros((h8, w8), np.uint8))
    cus = []
    for y8 in range(h8):
        for x8 in range(w8):
            c = int(sizes8[y8, x8])
            if y8 % c or x8 % c:
                continue
            cus.append(((y8 // 8, x8 // 8, z_order_index(x8 % 8,
                                                         y8 % 8)),
                        x8 * 8, y8 * 8, c * 8))
    cus.sort()
    order = np.zeros((h8, w8), np.int32)
    for k, (_key, x0, y0, s) in enumerate(cus):
        order[y0 // 8:(y0 + s) // 8, x0 // 8:(x0 + s) // 8] = k
    # Luma decode-unit order at 4x4 granularity: PART_NxN CUs split
    # into four z-ordered 4x4 PUs whose later PUs predict from earlier
    # ones; 64x64 CUs force the TU split into four z-ordered 32x32 TBs
    # that predict sequentially with the CU mode (8.4.4.2.2
    # availability follows this order).
    lorder = np.zeros((h // 4, w // 4), np.int32)
    lu = 0
    luma_units_of_cu = []
    trsplit = (fd.trsplit8 if fd.trsplit8 is not None
               else np.zeros((h8, w8), np.uint8))
    for _key, x0, y0, s in cus:
        if nxn[y0 // 8, x0 // 8]:
            units = [(x0, y0, 4), (x0 + 4, y0, 4),
                     (x0, y0 + 4, 4), (x0 + 4, y0 + 4, 4)]
        elif s == 64:
            units = [(x0, y0, 32), (x0 + 32, y0, 32),
                     (x0, y0 + 32, 32), (x0 + 32, y0 + 32, 32)]
        elif trsplit[y0 // 8, x0 // 8]:
            # Explicit one-level TU split (split_transform_flag): four
            # z-ordered half-size TBs predicted sequentially with the
            # CU's mode (8.4.4.2.1 at TB granularity).
            t = s // 2
            units = [(x0, y0, t), (x0 + t, y0, t),
                     (x0, y0 + t, t), (x0 + t, y0 + t, t)]
        else:
            units = [(x0, y0, s)]
        luma_units_of_cu.append(units)
        for ux, uy, us in units:
            lorder[uy // 4:(uy + us) // 4, ux // 4:(ux + us) // 4] = lu
            lu += 1
    # Chroma decode-unit order (4-sample granularity of the chroma
    # plane): one TB per CU except 64 CUs -> four z-ordered 16x16 TBs.
    corder = np.zeros((h // 8, w // 8), np.int32)
    cu_ctr = 0
    chroma_units_of_cu = []
    for _key, x0, y0, s in cus:
        cx0, cy0 = x0 // 2, y0 // 2
        if s == 64:
            cunits = [(cx0, cy0, 16), (cx0 + 16, cy0, 16),
                      (cx0, cy0 + 16, 16), (cx0 + 16, cy0 + 16, 16)]
        elif s >= 16 and trsplit[y0 // 8, x0 // 8]:
            # TU split: chroma TBs follow the luma split while the
            # chroma child stays >= 4 (s 16/32 -> 4x4/8x8 chroma TBs).
            t = s // 4
            cunits = [(cx0, cy0, t), (cx0 + t, cy0, t),
                      (cx0, cy0 + t, t), (cx0 + t, cy0 + t, t)]
        else:
            cunits = [(cx0, cy0, s // 2)]
        chroma_units_of_cu.append(cunits)
        for ux, uy, us in cunits:
            corder[uy // 4:(uy + us) // 4,
                   ux // 4:(ux + us) // 4] = cu_ctr
            cu_ctr += 1

    planes = [np.zeros((h, w), np.int64)]
    coeffs = [fd.coeff_y]
    if chroma:
        planes += [np.zeros((h // 2, w // 2), np.int64),
                   np.zeros((h // 2, w // 2), np.int64)]
        coeffs += [fd.coeff_cb, fd.coeff_cr]
    qps = [qp, chroma_qp(qp), chroma_qp(qp)]
    mid = 1 << (params.bitdepth - 1)
    maxv = (1 << params.bitdepth) - 1

    # Inter support: full-frame cell-granularity MC prediction from the
    # reconstructed motion fields (interpolation is position-
    # independent, so per-cell MC equals per-PU MC).
    inter8 = fd.inter8.astype(bool) if fd.inter8 is not None else None
    has_inter = ((ref is not None or ref_b is not None)
                 and inter8 is not None and inter8.any())
    mc = (None, None, None)
    if has_inter:
        def j(p):
            return None if p is None else jnp.asarray(
                np.asarray(p, np.int32))
        if ref_b is not None:
            from kvazaar_jax.encoder.inter_search import \
                bi_mc_planes_cells
            r0, r1 = ref_b
            mcj = bi_mc_planes_cells(
                tuple(j(p) for p in r0), tuple(j(p) for p in r1),
                jnp.asarray(fd.mv8.astype(np.int32)),
                jnp.asarray(fd.mv8_l1.astype(np.int32)),
                jnp.asarray(fd.dir8.astype(np.int32)),
                params.bitdepth)
        else:
            from kvazaar_jax.encoder.inter_search import mc_planes_cells
            mcj = mc_planes_cells(j(ref[0]), j(ref[1]), j(ref[2]),
                                  jnp.asarray(fd.mv8.astype(np.int32)),
                                  params.bitdepth)
        mc = tuple(None if p is None else np.asarray(p) for p in mcj)

    def recon_block(pi, x0, y0, s, mode, k_cu, my_lu, inter=False):
        if inter:
            plane = planes[pi]
            pred = mc[pi][y0:y0 + s, x0:x0 + s].astype(np.int64)
            lv = coeffs[pi][y0:y0 + s, x0:x0 + s]
            if params.transquant_bypass:
                res = lv.astype(np.int64)
            else:
                res = _np_inv_residual(
                    lv, s, qps[pi], params.bitdepth,
                    None if _sl_var is None
                    else _sl_var.m(s, False, pi))
            plane[y0:y0 + s, x0:x0 + s] = np.clip(pred + res, 0, maxv)
            return
        return recon_block_intra(pi, x0, y0, s, mode, k_cu, my_lu)

    def recon_block_intra(pi, x0, y0, s, mode, k_cu, my_lu):
        plane = planes[pi]
        scale = 1 if pi == 0 else 2
        ph, pw = plane.shape
        # Spec-ordered refs with availability by decode order and
        # substitution (8.4.4.2.2).
        i = np.arange(4 * s + 1)
        xs = np.where(i <= 2 * s, x0 - 1, x0 + i - (2 * s + 1))
        ys = np.where(i <= 2 * s, y0 + 2 * s - 1 - i, y0 - 1)
        inside = (xs >= 0) & (ys >= 0) & (xs < pw) & (ys < ph)
        if pi == 0:
            avail = inside & (lorder[np.clip(ys, 0, ph - 1) // 4,
                                     np.clip(xs, 0, pw - 1) // 4]
                              < my_lu)
        else:
            avail = inside & (corder[np.clip(ys, 0, ph - 1) // 4,
                                     np.clip(xs, 0, pw - 1) // 4]
                              < my_lu)
        refs = np.full(4 * s + 1, mid, np.int64)
        if avail.any():
            vals = plane[np.clip(ys, 0, ph - 1),
                         np.clip(xs, 0, pw - 1)]
            sub = np.where(avail, np.arange(4 * s + 1), -1)
            np.maximum.accumulate(sub, out=sub)
            sub[sub < 0] = int(np.argmax(avail))
            refs = np.where(avail[sub], vals[sub], mid)
        pred = _np_intra_pred(refs, mode, s, pi == 0,
                              params.bitdepth)
        lv = coeffs[pi][y0:y0 + s, x0:x0 + s]
        if params.transquant_bypass:
            res = lv.astype(np.int64)
        else:
            ts = False
            if params.transform_skip and s == 4:
                tmap = (fd.tskip4, fd.tskip_cb, fd.tskip_cr)[pi]
                if tmap is not None:
                    ts = bool(tmap[y0 // 4, x0 // 4])
            dst = pi == 0 and s == 4       # 4x4 intra luma TB (8.6.4.1)
            res = _np_inv_residual(
                lv, s, qps[pi], params.bitdepth,
                None if _sl_var is None else _sl_var.m(s, True, pi),
                dst=dst and not ts, ts=ts)
        plane[y0:y0 + s, x0:x0 + s] = np.clip(pred + res, 0, maxv)

    lu = 0
    cu_ctr = 0
    for k, (_key, lx0, ly0, ls) in enumerate(cus):
        cu_inter = bool(has_inter and inter8[ly0 // 8, lx0 // 8])
        for ux, uy, us in luma_units_of_cu[k]:
            recon_block(0, ux, uy, us,
                        int(fd.mode4[uy // 4, ux // 4]), k, lu,
                        inter=cu_inter)
            lu += 1
        if chroma:
            # Chroma mode: explicit (parsed intra_chroma_pred_mode,
            # --rd 3) when cmode4 carries one, else DM = luma mode of
            # the PU covering the CU origin (8.4.3); NxN CUs still
            # carry one 4x4 chroma TB.
            mode = int(fd.mode4[ly0 // 4, lx0 // 4])
            if not cu_inter and fd.cmode4 is not None:
                cm = int(fd.cmode4[ly0 // 8, lx0 // 8])
                if cm != 255:
                    mode = cm
            base = cu_ctr
            for j_, (ux, uy, us) in enumerate(chroma_units_of_cu[k]):
                for pi in (1, 2):
                    recon_block(pi, ux, uy, us, mode, k, base + j_,
                                inter=cu_inter)
            cu_ctr += len(chroma_units_of_cu[k])
        else:
            cu_ctr += len(chroma_units_of_cu[k])

    rec_y = planes[0]
    rec_cb = planes[1] if chroma else None
    rec_cr = planes[2] if chroma else None
    if params.deblock_enabled and has_inter:
        from kvazaar_jax.encoder.quadtree import (var_bs_maps,
                                                  var_edge_masks)
        from kvazaar_jax.ops.deblock import deblock_frame
        node8 = np.where((trsplit > 0) & (sizes8 > 1),
                         sizes8 // 2, sizes8)
        ev, eh = var_edge_masks(node8 * 8)
        # Per-TB luma cbf on the cell grid (TB = min(CU, 32), 8.7.2.4).
        cbf8 = np.zeros((h8, w8), bool)
        for (_key, x0, y0, s) in cus:
            tb = min(s, 32)
            for ty in range(y0, y0 + s, tb):
                for tx in range(x0, x0 + s, tb):
                    if fd.coeff_y[ty:ty + tb, tx:tx + tb].any():
                        cbf8[ty // 8:(ty + tb) // 8,
                             tx // 8:(tx + tb) // 8] = True
        is_b = ref_b is not None
        bs_v, bs_h = var_bs_maps(
            jnp.asarray(inter8), jnp.asarray(cbf8),
            jnp.asarray(fd.mv8.astype(np.int32)), jnp.asarray(ev),
            jnp.asarray(eh),
            mv1_cells=(jnp.asarray(fd.mv8_l1.astype(np.int32))
                       if is_b else None),
            dirs8=(jnp.asarray(fd.dir8.astype(np.int32))
                   if is_b else None))
        dy, dcb, dcr = deblock_frame(
            jnp.asarray(rec_y.astype(np.int32)),
            None if rec_cb is None else jnp.asarray(
                rec_cb.astype(np.int32)),
            None if rec_cr is None else jnp.asarray(
                rec_cr.astype(np.int32)),
            qp, 8, params.bitdepth, params.deblock_beta_offset_div2,
            params.deblock_tc_offset_div2, bs_v=bs_v, bs_h=bs_h)
        rec_y, rec_cb, rec_cr = (np.asarray(dy),
                                 None if dcb is None else np.asarray(dcb),
                                 None if dcr is None else np.asarray(dcr))
    elif params.deblock_enabled:
        from kvazaar_jax.ops.deblock import deblock_frame
        # TU boundaries filter too: a 64 CU's forced 32x32 TUs and
        # explicit split_transform_flag splits (8.7.2).
        c = np.minimum(sizes8.astype(np.int32), 4)
        c = np.where((trsplit > 0) & (c > 1), c // 2, c)
        x8 = np.arange(w8)[None, :]
        y8m = np.arange(h8)[:, None]
        bs_v = jnp.asarray(np.where(x8 % c == 0, 2, 0).astype(np.int32))
        bs_h = jnp.asarray(np.where(y8m % c == 0, 2, 0).astype(np.int32))
        dy, dcb, dcr = deblock_frame(
            jnp.asarray(rec_y.astype(np.int32)),
            None if rec_cb is None else jnp.asarray(
                rec_cb.astype(np.int32)),
            None if rec_cr is None else jnp.asarray(
                rec_cr.astype(np.int32)),
            qp, 8, params.bitdepth, params.deblock_beta_offset_div2,
            params.deblock_tc_offset_div2, bs_v=bs_v, bs_h=bs_h)
        rec_y, rec_cb, rec_cr = (np.asarray(dy),
                                 None if dcb is None else np.asarray(dcb),
                                 None if dcr is None else np.asarray(dcr))
    dt = np.uint8 if params.bitdepth <= 8 else np.uint16
    rec_y = np.asarray(rec_y, dt)
    if chroma:
        rec_cb = np.asarray(rec_cb, dt)
        rec_cr = np.asarray(rec_cr, dt)
    return _apply_sao_parsed(fd, params, rec_y, rec_cb, rec_cr)


def _plane_step_from_levels(recon_flat, gidx, noref, scatter, levels,
                            modes, size, qp, bitdepth, luma,
                            inter=None, mc=None, lossless=False,
                            scaling_tab=None, qp_step=None,
                            rdpcm=False):
    refs = recon_flat[gidx]
    refs = jnp.where(noref[:, None], 1 << (bitdepth - 1), refs)
    pred = predict_modes(refs.astype(jnp.int32), modes, size, luma=luma,
                         bitdepth=bitdepth,
                         fixups=not (rdpcm and luma))
    if inter is not None:
        pred = jnp.where(inter[:, None, None], mc, pred)
    if lossless:
        res = levels.astype(jnp.int32)
        if rdpcm:
            # Inverse implicit RDPCM: cumsum along the prediction
            # direction for hor/ver intra TBs (8.4.4.3-equivalent of
            # the reference's rdpcm(), src/transform.c:99).
            m = modes[:, None, None]
            res = jnp.where(
                m == 10, jnp.cumsum(res, axis=-1),
                jnp.where(m == 26, jnp.cumsum(res, axis=-2), res))
    else:
        dqc = None
        intra_m = None
        if scaling_tab is not None:
            dqc = (jnp.asarray(scaling_tab[2]),
                   jnp.asarray(scaling_tab[3]))
            intra_m = True if inter is None else ~inter
        dq = dequantize(levels,
                        qp if qp_step is None else qp_step, size,
                        bitdepth, dqc=dqc, intra=intra_m)
        res = inverse_transform(dq, size, bitdepth)
    rec = jnp.clip(pred + res, 0, (1 << bitdepth) - 1)
    return recon_flat.at[scatter.reshape(-1)].set(rec.reshape(-1))


def _decode_recon_impl(plan, s, chroma, qp, qp_c, bitdepth, lv_y, lv_cb,
                       lv_cr, modes, is_inter=None, mc_y=None,
                       mc_cb=None, mc_cr=None, lossless=False,
                       scaling=None, qp_map=None, cmodes=None,
                       rdpcm=False):
    tab_y = tab_cb = tab_cr = None
    if scaling is not None:
        def _tabs(size, comp, qq):
            return (scaling.qc(size, True, comp)[qq % 6],
                    scaling.qc(size, False, comp)[qq % 6],
                    scaling.dqc(size, True, comp)[qq % 6],
                    scaling.dqc(size, False, comp)[qq % 6])
        tab_y = _tabs(s, 0, qp)
        if chroma:
            tab_cb = _tabs(plan.chroma.size, 1, qp_c)
            tab_cr = _tabs(plan.chroma.size, 2, qp_c)
    h, w = plan.height, plan.width
    slot_ids = jnp.asarray(np.maximum(plan.block_of_slot, 0))
    modes_steps = modes.reshape(-1)[slot_ids]
    cmodes_steps = (modes_steps if cmodes is None
                    else cmodes.reshape(-1)[slot_ids])
    has_qp = qp_map is not None
    qp_steps = qpc_steps = None
    if has_qp:
        from kvazaar_jax.encoder.intra_recon import _CHROMA_QP_TAB
        qpi = jnp.clip(qp_map.astype(jnp.int32), 0, 51)
        qp_steps = qpi.reshape(-1)[slot_ids]
        qpc_steps = jnp.take(jnp.asarray(_CHROMA_QP_TAB),
                             qpi).reshape(-1)[slot_ids]
    inter = is_inter is not None
    if inter:
        inter_steps = is_inter.reshape(-1)[slot_ids]
        sc2p = plan.chroma.size if chroma else 0

        def mc_steps(plane, size):
            flat_ext = jnp.concatenate(
                [plane.reshape(-1), jnp.zeros((1,), plane.dtype)])
            maps = plan.luma if size == s else plan.chroma
            return flat_ext[jnp.asarray(maps.scatter_idx)].reshape(
                plan.n_steps, plan.n_slots, size, size)

        mcy_steps = mc_steps(mc_y.astype(jnp.int32), s)
        if chroma:
            mccb_steps = mc_steps(mc_cb.astype(jnp.int32), sc2p)
            mccr_steps = mc_steps(mc_cr.astype(jnp.int32), sc2p)
    g_y = jnp.asarray(plan.luma.gather_idx)
    n_y = jnp.asarray(plan.luma.no_refs)
    sc_y = jnp.asarray(plan.luma.scatter_idx)
    rec_y0 = jnp.zeros((h * w + 1,), jnp.int32)
    if chroma:
        g_c = jnp.asarray(plan.chroma.gather_idx)
        n_c = jnp.asarray(plan.chroma.no_refs)
        sc_c = jnp.asarray(plan.chroma.scatter_idx)
        rec_c0 = jnp.zeros(((h // 2) * (w // 2) + 1,), jnp.int32)
        sc2 = plan.chroma.size

    def step_fn(carry, xs):
        qt = qct = None
        if has_qp:
            xs, qt, qct = xs[:-2], xs[-2], xs[-1]
        if chroma:
            ry, rcb, rcr = carry
            if inter:
                (gy, ny, scy, ly, gc, nc, scc, lcb, lcr, m, cm, it, my,
                 mcb, mcr) = xs
            else:
                gy, ny, scy, ly, gc, nc, scc, lcb, lcr, m, cm = xs
                it = my = mcb = mcr = None
            ry = _plane_step_from_levels(ry, gy, ny, scy, ly, m, s, qp,
                                         bitdepth, True, it, my,
                                         lossless, tab_y, qp_step=qt,
                                         rdpcm=rdpcm)
            rcb = _plane_step_from_levels(rcb, gc, nc, scc, lcb, cm,
                                          sc2, qp_c, bitdepth, False,
                                          it, mcb, lossless, tab_cb,
                                          qp_step=qct, rdpcm=rdpcm)
            rcr = _plane_step_from_levels(rcr, gc, nc, scc, lcr, cm,
                                          sc2, qp_c, bitdepth, False,
                                          it, mcr, lossless, tab_cr,
                                          qp_step=qct, rdpcm=rdpcm)
            return (ry, rcb, rcr), None
        (ry,) = carry
        if inter:
            gy, ny, scy, ly, m, it, my = xs
        else:
            gy, ny, scy, ly, m = xs
            it = my = None
        ry = _plane_step_from_levels(ry, gy, ny, scy, ly, m, s, qp,
                                     bitdepth, True, it, my, lossless,
                                     tab_y, qp_step=qt, rdpcm=rdpcm)
        return (ry,), None

    if chroma:
        xs = (g_y, n_y, sc_y, lv_y, g_c, n_c, sc_c, lv_cb, lv_cr,
              modes_steps, cmodes_steps)
        if inter:
            xs = xs + (inter_steps, mcy_steps, mccb_steps, mccr_steps)
        carry0 = (rec_y0, rec_c0, rec_c0)
    else:
        xs = (g_y, n_y, sc_y, lv_y, modes_steps)
        if inter:
            xs = xs + (inter_steps, mcy_steps)
        carry0 = (rec_y0,)
    if has_qp:
        xs = xs + (qp_steps, qpc_steps)
    carry, _ = jax.lax.scan(step_fn, carry0, xs)
    rec_y = carry[0][:-1].reshape(h, w)
    if chroma:
        return (rec_y, carry[1][:-1].reshape(h // 2, w // 2),
                carry[2][:-1].reshape(h // 2, w // 2))
    return (rec_y, None, None)


def _decode_recon_jit(plan, s, chroma, qp, qp_c, bitdepth, lv_y, lv_cb,
                      lv_cr, modes, lossless=False, scaling=None,
                      qp_map=None, cmodes=None, rdpcm=False):
    # jit keyed on the static arguments via closure; plans are cached.
    return _decode_recon_impl(plan, s, chroma, qp, qp_c, bitdepth,
                              lv_y, lv_cb, lv_cr, modes,
                              lossless=lossless, scaling=scaling,
                              qp_map=qp_map, cmodes=cmodes,
                              rdpcm=rdpcm)
