"""Hierarchical B-pyramid GOPs: reorder buffer, two reference lists,
bipred 14-bit averaging, B-slice syntax — e2e bit-exact through the
oracle decoder (reference capability: src/input_frame_buffer.c:52,
src/encoderstate.c:990, src/inter.c:435, src/cfg.c GOP tables)."""

import numpy as np

from kvazaar_jax.config import Config
from kvazaar_jax.api import Encoder
from kvazaar_jax.bitstream.decoder import decode_stream
import pytest

pytestmark = pytest.mark.heavy


def _clip(n, w, h, seed=3):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        y = np.clip(128 + 60 * np.sin(xx / 19.0 + i * 0.35)
                    * np.cos(yy / 13.0) + rng.normal(0, 4, (h, w)),
                    0, 255).astype(np.uint8)
        cb = np.clip(110 + 20 * np.sin(xx[::2, ::2] / 11.0 + i * 0.2),
                     0, 255).astype(np.uint8)
        cr = np.clip(140 + 15 * np.cos(yy[::2, ::2] / 9.0 - i * 0.15),
                     0, 255).astype(np.uint8)
        out.append((y, cb, cr))
    return out


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


def test_gop8_bit_exact():
    w, h = 96, 64
    frames = _clip(9, w, h)
    cfg = Config(width=w, height=h, qp=30, intra_max_cu=16,
                 intra_min_cu=16, gop_len=8, intra_period=0,
                 hash="md5")
    enc = Encoder(cfg)
    stream, res = _encode_all(enc, frames)
    pocs = [i.poc for i, _ in res]
    assert pocs == [0, 8, 4, 2, 1, 3, 6, 5, 7]
    dec = decode_stream(stream, enc._intra.params)  # verifies MD5 SEIs
    assert len(dec) == 9
    for k, ((dy, dcb, dcr), fd) in enumerate(dec):
        info, rec = res[k]
        np.testing.assert_array_equal(dy[:h, :w], rec[0])
        np.testing.assert_array_equal(dcb[:h // 2, :w // 2], rec[1])
        np.testing.assert_array_equal(dcr[:h // 2, :w // 2], rec[2])
    # B slices actually used bi-prediction somewhere.
    dirs = [fd.dir8 for (_r, fd) in dec if fd.dir8 is not None]
    assert any((d == 2).any() for d in dirs)


def test_ippp_midstream_idr_poc_reset():
    """--period N: POC must restart at every IDR (8.3.1); the decoder
    rebuilds its DPB keyed by the signalled POCs."""
    w, h = 64, 64
    frames = _clip(9, w, h, seed=9)
    cfg = Config(width=w, height=h, qp=32, intra_max_cu=16,
                 intra_min_cu=16, intra_period=4)
    enc = Encoder(cfg)
    stream, res = _encode_all(enc, frames)
    dec = decode_stream(stream, enc._intra.params)
    assert len(dec) == 9
    for k, ((dy, _cb, _cr), _fd) in enumerate(dec):
        np.testing.assert_array_equal(dy[:h, :w], res[k][1][0])


def test_gop4_with_tail_flush():
    w, h = 64, 64
    frames = _clip(7, w, h, seed=5)   # IDR + one GOP4 + 2-frame tail
    cfg = Config(width=w, height=h, qp=32, intra_max_cu=16,
                 intra_min_cu=16, gop_len=4, intra_period=0)
    enc = Encoder(cfg)
    stream, res = _encode_all(enc, frames)
    assert len(res) == 7
    dec = decode_stream(stream, enc._intra.params)
    assert len(dec) == 7
    for k, ((dy, _cb, _cr), _fd) in enumerate(dec):
        np.testing.assert_array_equal(dy[:h, :w], res[k][1][0])


def test_b_merge_skip_used_and_bit_exact():
    """B merge/skip (8.5.3.2.3-8.5.3.2.5): translating content must
    produce merge-coded B CUs (incl. skips), and the stream stays
    bit-exact through the oracle (reference: src/inter.c:1130 merge
    candidate derivation, src/search_inter.c merge-mode decisions)."""
    rng = np.random.default_rng(11)
    w, h, n = 96, 64, 9
    base = rng.normal(0, 40, (h + 32, w + 64)).astype(np.float32)
    # Smooth so subpixel interp isn't forced; pure integer translation.
    from scipy.ndimage import gaussian_filter
    base = 128 + gaussian_filter(base, 5) * 6
    frames = []
    for t in range(n):
        y = np.clip(base[8:8 + h, 4 * t:4 * t + w], 0,
                    255).astype(np.uint8)
        cb = np.full((h // 2, w // 2), 120, np.uint8)
        frames.append((y, cb, cb.copy()))
    cfg = Config(width=w, height=h, qp=32, intra_max_cu=16,
                 intra_min_cu=16, gop_len=8, intra_period=0)
    enc = Encoder(cfg)
    stream, res = _encode_all(enc, frames)
    dec = decode_stream(stream, enc._intra.params)
    assert len(dec) == n
    for k, ((dy, _cb, _cr), _fd) in enumerate(dec):
        np.testing.assert_array_equal(dy[:h, :w], res[k][1][0])
    n_merge = sum(int((fd.merge8 >= 0).sum()) for _r, fd in dec)
    n_skip = sum(int(fd.skip8.sum()) for _r, fd in dec)
    assert n_merge > 0 and n_skip > 0


def test_no_bipred_b_frames():
    """--bipred 0: B slices use uni-prediction only, still bit-exact."""
    import numpy as np
    from kvazaar_jax.api import Encoder
    from kvazaar_jax.bitstream.decoder import decode_stream
    from kvazaar_jax.config import Config
    rng = np.random.default_rng(8)
    w = h = 64
    cfg = Config(width=w, height=h, qp=32, gop_len=4, intra_period=0,
                 intra_max_cu=16, intra_min_cu=16,
                 bipred=False).validate()
    enc = Encoder(cfg)
    stream = b""
    results = []
    for i in range(5):
        y = np.clip(rng.integers(0, 255, (h, w)) * 0.5 + 60 + i * 4,
                    0, 255).astype(np.uint8)
        cb = np.full((h // 2, w // 2), 110, np.uint8)
        cr = np.full((h // 2, w // 2), 130, np.uint8)
        results += enc.encode(y, cb, cr)
    results += enc.flush()
    for chunks, _i, _r in results:
        stream += chunks
    dec = decode_stream(stream, enc._intra.params)
    assert len(dec) == 5
    dirs = np.concatenate([fd.dir8.ravel() for _rec, fd in dec])
    assert not (dirs == 2).any(), "bipred disabled but BI coded"
