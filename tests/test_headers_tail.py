"""Bitstream long tail: VUI in the SPS, access-unit delimiters,
version SEI, level computation (reference:
src/encoder_state-bitstream.c:44,194-296,1003; level checks
src/cfg.c)."""

import numpy as np

from kvazaar_jax.api import Encoder
from kvazaar_jax.bitstream.bits import split_annexb
from kvazaar_jax.bitstream.decoder import decode_stream
from kvazaar_jax.bitstream.headers import compute_level_idc
from kvazaar_jax.config import Config
import pytest

pytestmark = pytest.mark.smoke


def test_level_idc_table():
    assert compute_level_idc(352, 288, 30) == 60       # CIF@30 -> 2.0
    assert compute_level_idc(832, 480, 25) == 90       # WVGA -> 3.0
    assert compute_level_idc(1920, 1080, 30) == 120    # 1080p30 -> 4.0
    assert compute_level_idc(1920, 1080, 60) == 123    # 1080p60 -> 4.1
    assert compute_level_idc(3840, 2160, 30) == 150    # 4K30 -> 5.0
    assert compute_level_idc(3840, 2160, 60) == 153    # 4K60 -> 5.1


def test_aud_vui_sei_stream():
    rng = np.random.default_rng(2)
    frames = [(rng.integers(0, 255, (64, 64)).astype(np.uint8),
               rng.integers(90, 160, (32, 32)).astype(np.uint8),
               rng.integers(90, 160, (32, 32)).astype(np.uint8))
              for _ in range(2)]
    cfg = Config(width=64, height=64, qp=30, intra_period=1,
                 intra_max_cu=16, intra_min_cu=16, wpp=False,
                 aud=True, info=True, sar_width=4, sar_height=3,
                 videoformat=1, colorprim=1, transfer=1, colormatrix=1,
                 hash="md5")
    enc = Encoder(cfg)
    stream = b""
    recs = []
    for c, info, rec in enc.encode_stream(iter(frames),
                                          need_recon=True):
        stream += c
        recs.append(rec)
    nal_types = [t for t, _tid, _r in split_annexb(stream)]
    assert nal_types.count(35) == 2, "one AUD per access unit"
    assert 39 in nal_types, "version SEI present"
    # The oracle decoder ignores AUD/SEI and still verifies MD5.
    dec = decode_stream(stream, enc._intra.params)
    assert len(dec) == 2
    for i, ((ry, rcb, rcr), _fd) in enumerate(dec):
        assert np.array_equal(ry[:64, :64], recs[i][0])


def test_version_sei_payload():
    from kvazaar_jax.bitstream.headers import write_version_sei
    sei = write_version_sei()
    assert b"kvazaar_jax" in sei
