"""Lossless (transquant bypass) and 10-bit operating points —
BASELINE.json config #5 requirements."""

import numpy as np
import pytest

from kvazaar_jax.bitstream.decoder import decode_stream
from kvazaar_jax.config import Config
from kvazaar_jax.encoder.frame_encoder import IntraFrameEncoder

pytestmark = pytest.mark.heavy


def test_lossless_intra_bit_exact_to_source():
    rng = np.random.default_rng(0)
    y = rng.integers(0, 256, (64, 64)).astype(np.uint8)
    cb = rng.integers(0, 256, (32, 32)).astype(np.uint8)
    cr = rng.integers(0, 256, (32, 32)).astype(np.uint8)
    cfg = Config(width=64, height=64, qp=27, intra_max_cu=16,
                 intra_min_cu=16, lossless=True)
    enc = IntraFrameEncoder(cfg)
    res = enc.encode_frame(y, cb, cr)
    # --lossless bit-exact to input (north-star requirement).
    np.testing.assert_array_equal(res.recon_y, y)
    np.testing.assert_array_equal(res.recon_cb, cb)
    np.testing.assert_array_equal(res.recon_cr, cr)
    frames = decode_stream(enc.headers() + res.nals, enc.params)
    (ry, rcb, rcr), _fd = frames[0]
    np.testing.assert_array_equal(ry, y)
    np.testing.assert_array_equal(rcb, cb)
    np.testing.assert_array_equal(rcr, cr)


def test_10bit_intra_e2e():
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:64, 0:64]
    y = np.clip(512 + 300 * np.sin(xx / 9.0) * np.cos(yy / 13.0)
                + rng.normal(0, 12, (64, 64)), 0, 1023).astype(np.uint16)
    cb = np.clip(400 + 120 * np.sin(xx[::2, ::2] / 17.0), 0,
                 1023).astype(np.uint16)
    cr = np.clip(600 + 100 * np.cos(yy[::2, ::2] / 11.0), 0,
                 1023).astype(np.uint16)
    cfg = Config(width=64, height=64, qp=27, intra_max_cu=16,
                 intra_min_cu=16, input_bitdepth=10)
    enc = IntraFrameEncoder(cfg)
    res = enc.encode_frame(y, cb, cr)
    frames = decode_stream(enc.headers() + res.nals, enc.params)
    (ry, rcb, rcr), _fd = frames[0]
    np.testing.assert_array_equal(ry, res.recon_y)
    np.testing.assert_array_equal(rcb, res.recon_cb)
    np.testing.assert_array_equal(rcr, res.recon_cr)
    from kvazaar_jax.encoder.frame_encoder import psnr
    assert psnr(res.recon_y, y.astype(np.int32), 10) > 34.0


def test_signhide_intra_e2e():
    """Sign data hiding: device parity-adjusts levels, serializer omits
    hidden signs, decoder infers them — still bit-exact e2e, and the
    stream must not grow."""
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:64, 0:64]
    y = np.clip(128 + 60 * np.sin(xx / 5.0) * np.cos(yy / 7.0)
                + rng.normal(0, 10, (64, 64)), 0, 255).astype(np.uint8)
    cb = np.clip(110 + 30 * np.sin(xx[::2, ::2] / 9.0), 0,
                 255).astype(np.uint8)
    cr = np.clip(140 + 25 * np.cos(yy[::2, ::2] / 9.0), 0,
                 255).astype(np.uint8)
    res = {}
    for sh in (False, True):
        cfg = Config(width=64, height=64, qp=22, intra_max_cu=16,
                     intra_min_cu=16, signhide=sh)
        enc = IntraFrameEncoder(cfg)
        r = enc.encode_frame(y, cb, cr)
        frames = decode_stream(enc.headers() + r.nals, enc.params)
        (ry, rcb, rcr), _ = frames[0]
        np.testing.assert_array_equal(ry, r.recon_y)
        np.testing.assert_array_equal(rcb, r.recon_cb)
        np.testing.assert_array_equal(rcr, r.recon_cr)
        res[sh] = len(r.nals)
    assert res[True] <= res[False], res


def test_signhide_cu8_mode_dependent_scans():
    rng = np.random.default_rng(5)
    y = rng.integers(0, 256, (64, 64)).astype(np.uint8)
    cb = rng.integers(0, 256, (32, 32)).astype(np.uint8)
    cr = rng.integers(0, 256, (32, 32)).astype(np.uint8)
    cfg = Config(width=64, height=64, qp=27, intra_max_cu=8,
                 intra_min_cu=8, signhide=True)
    enc = IntraFrameEncoder(cfg)
    r = enc.encode_frame(y, cb, cr)
    frames = decode_stream(enc.headers() + r.nals, enc.params)
    (ry, rcb, rcr), _ = frames[0]
    np.testing.assert_array_equal(ry, r.recon_y)
    np.testing.assert_array_equal(rcb, r.recon_cb)
    np.testing.assert_array_equal(rcr, r.recon_cr)


def test_md5_picture_hash_sei():
    """--hash md5: the decoder verifies the decoded-picture-hash SEI
    against its own reconstruction (raises on mismatch)."""
    rng = np.random.default_rng(6)
    y = rng.integers(0, 256, (64, 64)).astype(np.uint8)
    cb = rng.integers(0, 256, (32, 32)).astype(np.uint8)
    cr = rng.integers(0, 256, (32, 32)).astype(np.uint8)
    cfg = Config(width=64, height=64, qp=27, intra_max_cu=16,
                 intra_min_cu=16, hash="md5")
    enc = IntraFrameEncoder(cfg)
    res = enc.encode_frame(y, cb, cr)
    stream = enc.headers() + res.nals
    frames = decode_stream(stream, enc.params)   # verifies SEI inline
    assert len(frames) == 1
    # Tampered stream must FAIL the hash check: flip a coeff-ish byte in
    # the slice NAL (keep headers + SEI intact).
    bad = bytearray(stream)
    slice_start = stream.find(b"\x00\x00\x00\x01", 10)
    # find the IDR slice NAL (type 19): scan start codes
    import re
    positions = [m.start() for m in re.finditer(b"\x00\x00\x01", stream)]
    idr_pos = None
    for sp in positions:
        t = (stream[sp + 3] >> 1) & 0x3F
        if t in (19, 20):
            idr_pos = sp
    assert idr_pos is not None
    bad[idr_pos + 40] ^= 0x10
    try:
        decode_stream(bytes(bad), enc.params)
        raised = False
    except Exception:
        raised = True
    assert raised, "tampered stream must fail decode or hash check"


def test_implicit_rdpcm_lossless():
    """--implicit-rdpcm: hor/ver intra TBs DPCM their bypass residual
    (reference rdpcm(), src/transform.c:99; SPS range extension,
    src/encoder_state-bitstream.c:304).  Still bit-exact to input, and
    the SPS + coefficients must differ from plain lossless."""
    yy, xx = np.mgrid[0:64, 0:64]
    # Strong horizontal+vertical gradients so modes 10/26 win often.
    y = ((xx * 3 + yy // 8) % 256).astype(np.uint8)
    cb = ((xx[::2, ::2] * 2) % 256).astype(np.uint8)
    cr = ((yy[::2, ::2] * 2) % 256).astype(np.uint8)
    base = dict(width=64, height=64, qp=27, intra_max_cu=16,
                intra_min_cu=16, lossless=True)
    cfg = Config(**base, implicit_rdpcm=True).validate()
    enc = IntraFrameEncoder(cfg)
    res = enc.encode_frame(y, cb, cr)
    np.testing.assert_array_equal(res.recon_y, y)
    frames = decode_stream(enc.headers() + res.nals, enc.params)
    (ry, rcb, rcr), fd = frames[0]
    np.testing.assert_array_equal(ry, y)
    np.testing.assert_array_equal(rcb, cb)
    np.testing.assert_array_equal(rcr, cr)
    assert (fd.mode4 == 10).any() or (fd.mode4 == 26).any(), \
        "no hor/ver modes chosen; test content broken"
    enc0 = IntraFrameEncoder(Config(**base).validate())
    res0 = enc0.encode_frame(y, cb, cr)
    assert enc.headers() != enc0.headers()        # SPS REXT bits
    assert res.nals != res0.nals                  # DPCM'd residuals


def test_implicit_rdpcm_requires_lossless():
    with pytest.raises(ValueError):
        Config(width=64, height=64, qp=27, intra_max_cu=16,
               intra_min_cu=16, implicit_rdpcm=True).validate()
