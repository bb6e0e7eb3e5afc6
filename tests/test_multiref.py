"""Multi-reference low-delay P: lp-g#d#t# GOP structures, per-ref
motion search, ref_idx_l0 syntax, ref-aware merge/AMVP with POC
scaling — e2e bit-exact through the oracle decoder.

Reference capability: per-ref search loop (src/search_inter.c:1134),
lp-gop processing (src/cfg.c:1237), RPS emission
(src/encoder_state-bitstream.c:687), ref_idx coding
(src/encode_coding_tree.c:590)."""

import numpy as np

from kvazaar_jax.api import Encoder
from kvazaar_jax.bitstream.decoder import decode_stream
from kvazaar_jax.config import Config, lp_gop_table
import pytest

pytestmark = pytest.mark.heavy


def test_lp_gop_table_matches_reference_algorithm():
    # lp-g4d2t1 with 4 refs: previous frame + earlier keyframes.
    t = lp_gop_table(4, 2, 1, 4)
    assert [e["ref_neg"] for e in t] == [
        [1, 5, 9, 13], [1, 2, 6, 10], [1, 3, 7, 11], [1, 4, 8, 12]]
    assert [e["qp_offset"] for e in t] == [2, 2, 2, 1]
    # d=1: everything layer 1.
    assert all(e["layer"] == 1 for e in lp_gop_table(4, 1, 1, 2))


def _encode_all(enc, frames):
    res = []
    stream = b""
    for f in frames:
        for (chunks, info, rec) in enc.encode(*f):
            stream += chunks
            res.append((info, rec))
    for (chunks, info, rec) in enc.flush():
        stream += chunks
        res.append((info, rec))
    return stream, res


def _check_bit_exact(stream, res, enc, n, w, h):
    dec = decode_stream(stream, enc._intra.params)
    assert len(dec) == n
    for k, ((dy, dcb, dcr), _fd) in enumerate(dec):
        info, rec = res[k]
        np.testing.assert_array_equal(dy[:h, :w], rec[0])
        if rec[1] is not None:
            np.testing.assert_array_equal(dcb[:h // 2, :w // 2], rec[1])
            np.testing.assert_array_equal(dcr[:h // 2, :w // 2], rec[2])
    return dec


def test_lp_g4d2t1_bit_exact_with_qp_ladder():
    rng = np.random.default_rng(5)
    w, h, n = 96, 64, 10
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for i in range(n):
        y = np.clip(128 + 60 * np.sin(xx / 17.0 + i * 0.4)
                    * np.cos(yy / 11.0 + i * 0.1)
                    + rng.normal(0, 4, (h, w)), 0, 255).astype(np.uint8)
        cb = np.clip(110 + 20 * np.sin(xx[::2, ::2] / 9.0), 0,
                     255).astype(np.uint8)
        frames.append((y, cb, cb.copy()))
    cfg = Config(width=w, height=h, qp=30, intra_max_cu=16,
                 intra_min_cu=16, intra_period=0, hash="md5")
    cfg.set("gop", "lp-g4d2t1").set("ref_frames", "4").validate()
    enc = Encoder(cfg)
    stream, res = _encode_all(enc, frames)
    dec = _check_bit_exact(stream, res, enc, n, w, h)
    # The layer QP ladder: keyframes (rel poc % 4 == 0) at qp+1,
    # others at qp+2.
    assert [i.qp for i, _ in res] == [30, 32, 32, 32, 31,
                                      32, 32, 32, 31, 32]
    # Multiple reference indices actually chosen somewhere.
    used = set()
    for _r, fd in dec:
        if fd.inter8.any():
            used |= set(np.unique(fd.ref8[fd.inter8 > 0]).tolist())
    assert len(used) > 1


def test_ref_idx_unary_tail_period6_content():
    """Period-6 repeating content: positions whose delta-6 reference
    is an exact copy must pick ref_idx >= 2, covering the TR unary
    tail (ctx bin 1 + bypass) of ref_idx coding."""
    rng = np.random.default_rng(9)
    w, h = 64, 64
    pattern = [np.clip(rng.normal(128, 40, (h, w)), 0,
                       255).astype(np.uint8) for _ in range(6)]
    from scipy.ndimage import gaussian_filter
    pattern = [np.clip(gaussian_filter(p.astype(np.float32), 3), 0,
                       255).astype(np.uint8) for p in pattern]
    frames = [(pattern[i % 6], None, None) for i in range(12)]
    cfg = Config(width=w, height=h, qp=30, intra_max_cu=16,
                 intra_min_cu=16, intra_period=0, chroma_format=400)
    cfg.set("gop", "lp-g4d2t1").set("ref_frames", "4").validate()
    enc = Encoder(cfg)
    stream, res = _encode_all(enc, frames)
    dec = _check_bit_exact(stream, res, enc, 12, w, h)
    used = set()
    for _r, fd in dec:
        if fd.inter8.any():
            used |= set(np.unique(fd.ref8[fd.inter8 > 0]).tolist())
    assert max(used) >= 2, used


def test_plain_multiref_ippp():
    """--ref 2 without an lp structure: sliding-window last-2 refs."""
    rng = np.random.default_rng(3)
    w, h, n = 64, 64, 6
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for i in range(n):
        y = np.clip(128 + 50 * np.sin(xx / 13.0 + i * 0.5)
                    + rng.normal(0, 3, (h, w)), 0, 255).astype(np.uint8)
        cb = np.full((h // 2, w // 2), 120, np.uint8)
        frames.append((y, cb, cb.copy()))
    cfg = Config(width=w, height=h, qp=32, intra_max_cu=16,
                 intra_min_cu=16, intra_period=0, ref_frames=2)
    cfg.validate()
    enc = Encoder(cfg)
    stream, res = _encode_all(enc, frames)
    _check_bit_exact(stream, res, enc, n, w, h)
