"""Selective encryption (--crypto): AES-CTR keystream over sign
bypass bins (reference extras/crypto.cpp behind KVZ_SEL_ENCRYPTION).
Streams stay spec-parseable without the key but reconstruct scrambled;
the key holder reconstructs bit-exact."""

import dataclasses as dc

import numpy as np
import pytest

from kvazaar_jax.bitstream.decoder import decode_stream
from kvazaar_jax.config import Config
from kvazaar_jax.encoder.frame_encoder import IntraFrameEncoder

pytestmark = pytest.mark.heavy


def test_aes_fips197_vector():
    from kvazaar_jax.bitstream.crypto import (_aes128_encrypt_block,
                                              _expand_key)
    key = bytes(range(16))
    pt = bytes.fromhex("00112233445566778899aabbccddeeff")
    ct = _aes128_encrypt_block(pt, _expand_key(key))
    assert ct.hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"


def _frame(w, h, seed=3, i=0):
    rng = np.random.default_rng(seed + i)
    yy, xx = np.mgrid[0:h, 0:w]
    y = np.clip(120 + 45 * np.sin(xx / 9.0 + i) * np.cos(yy / 7.0)
                + rng.normal(0, 6, (h, w)), 0, 255).astype(np.uint8)
    cb = np.clip(110 + 20 * np.sin(xx[::2, ::2] / 11.0), 0,
                 255).astype(np.uint8)
    cr = np.clip(135 + 18 * np.cos(yy[::2, ::2] / 5.0), 0,
                 255).astype(np.uint8)
    return y, cb, cr


def test_crypto_roundtrip_and_scramble():
    w = h = 128
    cfg = Config(width=w, height=h, qp=30, intra_period=0,
                 intra_min_cu=16, intra_max_cu=16,
                 crypto="s3cret").validate()
    enc = IntraFrameEncoder(cfg)
    r0 = enc.encode_frame(*_frame(w, h, i=0))
    r1 = enc.encode_p_frame(*_frame(w, h, i=1), poc=1, ref_poc=0)
    stream = enc.headers() + r0.nals + r1.nals
    # With the key: bit-exact reconstruction.
    frames = decode_stream(stream, enc.params)
    np.testing.assert_array_equal(frames[0][0][0], r0.recon_y)
    np.testing.assert_array_equal(frames[1][0][0], r1.recon_y)
    # Without the key (or a wrong one): parseable but scrambled.
    from kvazaar_jax.bitstream.crypto import key_from_string
    wrong = dc.replace(enc.params,
                       crypto_key=key_from_string("wrong"))
    frames_w = decode_stream(stream, wrong)
    assert not np.array_equal(frames_w[0][0][0], r0.recon_y)
    nokey = dc.replace(enc.params, crypto_key=None)
    frames_n = decode_stream(stream, nokey)
    assert not np.array_equal(frames_n[0][0][0], r0.recon_y)


def test_crypto_changes_stream_not_size_class():
    """Same content, different key -> different bytes, similar size
    (only sign bins flip)."""
    w = h = 64
    outs = {}
    for key in ("a", "b"):
        cfg = Config(width=w, height=h, qp=30, intra_period=1,
                     intra_max_cu=16, intra_min_cu=16,
                     crypto=key).validate()
        enc = IntraFrameEncoder(cfg)
        r = enc.encode_frame(*_frame(w, h))
        outs[key] = r.nals
    assert outs["a"] != outs["b"]
    assert abs(len(outs["a"]) - len(outs["b"])) < 64


def test_crypto_per_picture_nonce():
    """Two identical pictures must encrypt differently (per-picture
    CTR nonce -- no keystream reuse), and still decode bit-exact."""
    w = h = 64
    cfg = Config(width=w, height=h, qp=30, intra_period=1,
                 intra_max_cu=16, intra_min_cu=16,
                 crypto="k").validate()
    enc = IntraFrameEncoder(cfg)
    y, cb, cr = _frame(w, h)
    r0 = enc.encode_frame(y, cb, cr)
    r1 = enc.encode_frame(y, cb, cr)       # identical source
    assert r0.nals != r1.nals, "keystream reused across pictures"
    frames = decode_stream(enc.headers() + r0.nals + r1.nals,
                           enc.params)
    np.testing.assert_array_equal(frames[0][0][0], r0.recon_y)
    np.testing.assert_array_equal(frames[1][0][0], r1.recon_y)


def test_crypto_with_rate_control():
    """--crypto x --bitrate: the per-picture nonce counter is
    stream-global across the per-QP encoder instances frame-level RC
    spawns (the reference accepts the combination freely)."""
    from kvazaar_jax.api import Encoder
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:64, 0:96]
    frames = []
    for i in range(4):
        y = np.clip(120 + 50 * np.sin(xx / 9.0 + i)
                    + rng.normal(0, 4, (64, 96)), 0,
                    255).astype(np.uint8)
        cb = np.full((32, 48), 110, np.uint8)
        cr = np.full((32, 48), 140, np.uint8)
        frames.append((y, cb, cr))
    cfg = Config(width=96, height=64, qp=30, intra_period=1,
                 intra_max_cu=16, intra_min_cu=16,
                 crypto="s3cret", bitrate=64000).validate()
    enc = Encoder(cfg)
    stream = b""
    res = []
    for f in frames:
        for chunks, info, rec in enc.encode(*f):
            stream += chunks
            res.append(rec)
    dec = decode_stream(stream, enc._intra.params)
    assert len(dec) == len(res)
    for k, ((dy, dcb, dcr), _fd) in enumerate(dec):
        np.testing.assert_array_equal(dy[:64, :96], res[k][0],
                                      err_msg=f"frame {k}")
