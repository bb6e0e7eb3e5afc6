"""Temporal MVP (sps/slice_temporal_mvp_enabled): collocated-picture
merge + AMVP candidates with POC scaling, 16-aligned sampling, H/C3
positions — e2e bit-exact, identical reconstruction to TMVP-off (only
signalling changes), different bits (candidates actually used).

Reference capability: get_temporal_merge_candidates +
add_temporal_candidate (src/inter.c:713,1001)."""

import numpy as np

from kvazaar_jax.api import Encoder
from kvazaar_jax.bitstream.decoder import decode_stream
from kvazaar_jax.config import Config
import pytest

pytestmark = pytest.mark.heavy


def _clip(n, w, h):
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        y = np.clip(128 + 60 * np.sin((xx + 3 * i) / 17.0)
                    * np.cos((yy + i) / 11.0)
                    + rng.normal(0, 4, (h, w)), 0, 255).astype(np.uint8)
        cb = np.full((h // 2, w // 2), 120, np.uint8)
        out.append((y, cb, cb.copy()))
    return out


def _encode(cfg, frames):
    enc = Encoder(cfg)
    stream = b""
    res = []
    for f in frames:
        for (chunks, info, rec) in enc.encode(*f):
            stream += chunks
            res.append((info, rec))
    return enc, stream, res


def test_tmvp_bit_exact_same_recon_fewer_bits():
    w, h, n = 96, 64, 8
    frames = _clip(n, w, h)
    base = dict(width=w, height=h, qp=32, intra_max_cu=16,
                intra_min_cu=16, intra_period=0)
    enc0, s0, r0 = _encode(Config(**base).validate(), frames)
    enc1, s1, r1 = _encode(Config(**base, tmvp=True).validate(),
                           frames)
    assert s0 != s1            # temporal candidates changed signalling
    dec = decode_stream(s1, enc1._intra.params)
    assert len(dec) == n
    for k, ((dy, _cb, _cr), _fd) in enumerate(dec):
        np.testing.assert_array_equal(dy[:h, :w], r1[k][1][0])
        # TMVP changes only MV *coding*, never the motion itself.
        np.testing.assert_array_equal(r0[k][1][0], r1[k][1][0])


def test_tmvp_with_multiref_lp_gop():
    w, h, n = 96, 64, 9
    frames = _clip(n, w, h)
    cfg = Config(width=w, height=h, qp=32, intra_max_cu=16,
                 intra_min_cu=16, intra_period=0, tmvp=True,
                 ref_frames=4, hash="md5")
    cfg.set("gop", "lp-g4d2t1").validate()
    enc, stream, res = _encode(cfg, frames)
    dec = decode_stream(stream, enc._intra.params)  # verifies MD5 SEIs
    assert len(dec) == n
    for k, ((dy, _cb, _cr), _fd) in enumerate(dec):
        np.testing.assert_array_equal(dy[:h, :w], res[k][1][0])


def test_tmvp_midstream_idr_resets_collocated():
    w, h, n = 64, 64, 7
    frames = _clip(n, w, h)
    cfg = Config(width=w, height=h, qp=32, intra_max_cu=16,
                 intra_min_cu=16, intra_period=3, tmvp=True).validate()
    enc, stream, res = _encode(cfg, frames)
    dec = decode_stream(stream, enc._intra.params)
    assert len(dec) == n
    for k, ((dy, _cb, _cr), _fd) in enumerate(dec):
        np.testing.assert_array_equal(dy[:h, :w], res[k][1][0])
