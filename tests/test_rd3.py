"""--rd 3: explicit chroma-mode RDO (reference kvz_search_cu_intra_chroma,
/root/reference/src/search_intra.c:736 — enabled there at --rd >= 3,
src/search.c rdo gates).  The encoder searches the four Table 8-3 list
candidates + DM per CU with a true roundtrip; streams must decode
bit-exact and actually use non-DM modes on chroma-structured content."""

import numpy as np
import pytest

from kvazaar_jax.config import Config
from kvazaar_jax.encoder.frame_encoder import IntraFrameEncoder
from kvazaar_jax.bitstream.decoder import decode_stream

pytestmark = pytest.mark.smoke


def _chroma_rich(n, w, h, seed=3):
    """Luma and chroma with DIFFERENT directional structure, so DM is a
    bad chroma predictor and the explicit modes pay."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        y = np.clip(128 + 60 * np.sin(yy / 5.0 + i)          # horizontal
                    + rng.normal(0, 2, (h, w)), 0, 255).astype(np.uint8)
        cb = np.clip(128 + 50 * np.sin(xx[::2, ::2] / 4.0)   # vertical
                     + rng.normal(0, 2, (h // 2, w // 2)),
                     0, 255).astype(np.uint8)
        cr = np.clip(128 + 50 * np.cos(xx[::2, ::2] / 6.0)
                     + rng.normal(0, 2, (h // 2, w // 2)),
                     0, 255).astype(np.uint8)
        out.append((y, cb, cr))
    return out


def _encode_decode(cfg, frames):
    enc = IntraFrameEncoder(cfg)
    res = enc.encode_frames(frames)
    stream = enc.headers() + b"".join(r.nals for r in res)
    dec = decode_stream(stream, enc.params)
    assert len(dec) == len(res)
    for k, ((dy, dcb, dcr), dfd) in enumerate(dec):
        r = res[k]
        np.testing.assert_array_equal(dy, r.recon_y, err_msg=f"f{k} y")
        np.testing.assert_array_equal(dcb, r.recon_cb, err_msg=f"f{k} cb")
        np.testing.assert_array_equal(dcr, r.recon_cr, err_msg=f"f{k} cr")
    return res, dec


def test_rd3_bitexact_and_nondm():
    frames = _chroma_rich(2, 96, 64)
    cfg = Config(width=96, height=64, qp=30, intra_period=1,
                 intra_min_cu=16, intra_max_cu=16, rd=3).validate()
    res, dec = _encode_decode(cfg, frames)
    # The searched modes must actually leave DM somewhere on this clip
    # (decoder-parsed cmode4 differs from the luma mode).
    (_rec, dfd) = dec[0]
    lm8 = dfd.mode4[::2, ::2]
    assert (dfd.cmode4 != lm8).any(), "rd3 never chose a non-DM mode"


def test_rd3_improves_chroma_vs_rd2():
    frames = _chroma_rich(2, 96, 64)
    outs = {}
    for rd in (2, 3):
        cfg = Config(width=96, height=64, qp=30, intra_period=1,
                     intra_min_cu=16, intra_max_cu=16, rd=rd).validate()
        enc = IntraFrameEncoder(cfg)
        res = enc.encode_frames(frames)
        sse_c = sum(r.sse[1] + r.sse[2] for r in res)
        bits = sum(r.bits for r in res)
        outs[rd] = (sse_c, bits)
    # rd3 must win on RD: strictly better chroma distortion at <= ~equal
    # bits, or fewer bits at <= ~equal distortion.
    s2, b2 = outs[2]
    s3, b3 = outs[3]
    assert (s3 < s2 and b3 < b2 * 1.02) or (b3 < b2 and s3 < s2 * 1.02), \
        f"rd3 {outs[3]} not better than rd2 {outs[2]}"


def test_rd3_native_matches_python():
    """The native CABAC path must emit byte-identical slice data for
    explicit chroma modes (intra_chroma_pred_mode + chroma scan idx)."""
    from kvazaar_jax.bitstream import native
    from kvazaar_jax.bitstream.bits import BitWriter
    from kvazaar_jax.bitstream.cabac import CabacEncoder
    from kvazaar_jax.bitstream.contexts import Contexts
    from kvazaar_jax.bitstream.syntax import SliceDataEncoder
    from kvazaar_jax.constants import SLICE_I
    frames = _chroma_rich(1, 96, 64)
    cfg = Config(width=96, height=64, qp=30, intra_period=1,
                 intra_min_cu=8, intra_max_cu=8, rd=3).validate()
    enc = IntraFrameEncoder(cfg)
    res = enc.encode_frames(frames)
    fd = res[0].frame_data
    assert (fd.cmode4 != 255).any()
    ndata = native.encode_slice_data_native(enc.params, fd, cfg.qp)
    w = BitWriter()
    pe = SliceDataEncoder(enc.params, fd, Contexts(SLICE_I, cfg.qp),
                          CabacEncoder(w))
    pe.encode_slice_data()
    w.align_zero()
    assert ndata == w.get_bytes()


def test_rd3_cu8_bitexact():
    frames = _chroma_rich(1, 64, 64)
    cfg = Config(width=64, height=64, qp=27, intra_period=1,
                 intra_min_cu=8, intra_max_cu=8, rd=3,
                 signhide=True).validate()
    _encode_decode(cfg, frames)


def test_rd3_var_tree_bitexact():
    """rd 3 over the variable quadtree (8..64 incl. a 64 CU level):
    per-size chroma-mode RDO with 64-CU quadrant agreement."""
    frames = _chroma_rich(1, 128, 128, seed=7)
    cfg = Config(width=128, height=128, qp=30, intra_period=1,
                 intra_min_cu=8, intra_max_cu=64, rd=3,
                 rdoq=True).validate()
    res, dec = _encode_decode(cfg, frames)
    (_rec, dfd) = dec[0]
    lm8 = dfd.mode4[::2, ::2]
    assert (dfd.cmode4 != lm8).any(), "var rd3 never chose non-DM"


def test_rd3_with_rdoq_sao():
    frames = _chroma_rich(1, 64, 64)
    cfg = Config(width=64, height=64, qp=32, intra_period=1,
                 intra_min_cu=16, intra_max_cu=16, rd=3, rdoq=True,
                 sao=True).validate()
    enc = IntraFrameEncoder(cfg)
    res = enc.encode_frames(frames)
    stream = enc.headers() + b"".join(r.nals for r in res)
    dec = decode_stream(stream, enc.params)
    (dy, dcb, dcr), _ = dec[0]
    np.testing.assert_array_equal(dy, res[0].recon_y)
    np.testing.assert_array_equal(dcb, res[0].recon_cb)
    np.testing.assert_array_equal(dcr, res[0].recon_cr)
