"""Driver-shaped operating points (BASELINE.md configs #1-#5) at tiny
resolutions: each must validate, encode, and decode bit-exact through
the oracle with its tools actually active.  The reference accepts the
full product of its tools (kvz_encoder_control_init,
/root/reference/src/encoder.c:206-520); this is the e2e gate that ours
does too."""

import numpy as np
import pytest

from kvazaar_jax.api import Encoder
from kvazaar_jax.bitstream.decoder import decode_stream
from kvazaar_jax.config import Config, config_from_preset

pytestmark = pytest.mark.smoke


def _clip(n, w, h, seed=0, depth=8):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    hi = (1 << depth) - 1
    dt = np.uint8 if depth == 8 else np.uint16
    out = []
    for i in range(n):
        y = np.clip((hi / 255.0) * (120 + 70 * np.sin(xx / 11.0 + i)
                    * np.cos(yy / 7.0) + rng.normal(0, 3, (h, w))),
                    0, hi).astype(dt)
        cb = np.clip((hi / 255.0) * (110 + 20
                     * np.sin(xx[::2, ::2] / 9.0)), 0, hi).astype(dt)
        cr = np.clip((hi / 255.0) * (140 + 20
                     * np.cos(yy[::2, ::2] / 13.0)), 0, hi).astype(dt)
        out.append((y, cb, cr))
    return out


def _run(cfg, frames):
    enc = Encoder(cfg)
    stream = b""
    res = []
    for f in frames:
        for chunks, info, rec in enc.encode(*f):
            stream += chunks
            res.append((info, rec))
    for chunks, info, rec in enc.flush():
        stream += chunks
        res.append((info, rec))
    dec = decode_stream(stream, enc._intra.params)
    assert len(dec) == len(res)
    h, w = frames[0][0].shape
    for k, ((dy, dcb, dcr), _fd) in enumerate(dec):
        _info, rec = res[k]
        np.testing.assert_array_equal(dy[:h, :w], rec[0],
                                      err_msg=f"frame {k}")
        np.testing.assert_array_equal(dcb[:h // 2, :w // 2], rec[1])
        np.testing.assert_array_equal(dcr[:h // 2, :w // 2], rec[2])
    return res, dec


def test_config1_allintra_ultrafast():
    w, h = 96, 64
    cfg = config_from_preset("ultrafast", width=w, height=h, qp=22,
                             intra_period=1).validate()
    _run(cfg, _clip(3, w, h))


def test_config2_lowdelay_multiref_fast():
    w, h = 96, 64
    cfg = config_from_preset("fast", width=w, height=h, qp=27)
    cfg.set("gop", "lp-g4d2t1")
    cfg.ref_frames = 4
    cfg.validate()
    res, dec = _run(cfg, _clip(6, w, h, seed=1))
    # Multi-ref must actually be in play: some CU references ref_idx>0.
    assert any(fd.ref8 is not None and (fd.ref8 > 0).any()
               for (_r, fd) in dec), "no CU picked a non-nearest ref"


def test_config3_gop8_slow():
    """Driver BASELINE config #3 (--gop 8 --preset slow): variable
    trees + rd2 + RDOQ + SAO in a B pyramid — the combination round 2
    rejected."""
    w, h = 96, 64
    cfg = config_from_preset("slow", width=w, height=h, qp=30)
    cfg.set("gop", "8")
    cfg.validate()
    assert cfg.rd == 2 and cfg.rdoq and cfg.sao and cfg.gop_len == 8
    assert cfg.intra_min_cu < cfg.intra_max_cu
    res, dec = _run(cfg, _clip(9, w, h, seed=2))
    pocs = [i.poc for i, _ in res]
    assert pocs[0] == 0 and sorted(pocs) == list(range(9))
    assert pocs != sorted(pocs), "no B reorder happened"


def test_config4_wpp_tiles():
    w, h = 192, 128
    cfg = Config(width=w, height=h, qp=30, intra_max_cu=16,
                 intra_min_cu=16, intra_period=1, wpp=True,
                 tiles_x=3, tiles_y=2).validate()
    _run(cfg, _clip(2, w, h, seed=3))


def test_config5_10bit_gop8_bitrate():
    w, h = 96, 64
    cfg = Config(width=w, height=h, qp=30, input_bitdepth=10,
                 gop_len=8, intra_period=0,
                 bitrate=400_000).validate()
    res, _dec = _run(cfg, _clip(9, w, h, seed=4, depth=10))
    # Rate control must move QP off the default.
    assert any(i.qp != 30 for i, _ in res)


def test_config5_lossless_bit_exact():
    w, h = 96, 64
    frames = _clip(2, w, h, seed=5)
    cfg = Config(width=w, height=h, qp=30, lossless=True,
                 deblock=False, intra_period=1).validate()
    res, dec = _run(cfg, frames)
    for k, ((dy, dcb, dcr), _fd) in enumerate(dec):
        np.testing.assert_array_equal(dy[:h, :w], frames[k][0],
                                      err_msg="lossless luma differs")
        np.testing.assert_array_equal(dcb[:h // 2, :w // 2],
                                      frames[k][1])
        np.testing.assert_array_equal(dcr[:h // 2, :w // 2],
                                      frames[k][2])
