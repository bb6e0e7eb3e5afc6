"""--slices modes: wpp (each CTU row a dependent slice segment) and
tiles (independent slice per tile) — reference src/kvazaar.h:198-201,
tests/test_slices.sh.  Bitstream-only feature: reconstruction must be
identical to the single-slice stream; the oracle decoder assembles
multi-NAL pictures."""

import numpy as np
import pytest

from kvazaar_jax.api import Encoder
from kvazaar_jax.bitstream.bits import split_annexb
from kvazaar_jax.bitstream.decoder import decode_stream
from kvazaar_jax.config import Config

pytestmark = pytest.mark.heavy


def _clip(n, w, h, seed=1):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        y = np.clip(128 + 40 * np.sin(xx / 9.0 + i * 0.7)
                    * np.cos(yy / 7.0) + rng.normal(0, 6, (h, w)),
                    0, 255).astype(np.uint8)
        cb = rng.integers(90, 160, (h // 2, w // 2)).astype(np.uint8)
        cr = rng.integers(90, 160, (h // 2, w // 2)).astype(np.uint8)
        out.append((y, cb, cr))
    return out


def _roundtrip(cfg, frames):
    enc = Encoder(cfg)
    stream = b""
    recs = []
    for c, info, rec in enc.encode_stream(iter(frames),
                                          need_recon=True):
        stream += c
        recs.append(rec)
    dec = decode_stream(stream, enc._intra.params)
    assert len(dec) == len(frames)
    h, w = cfg.height, cfg.width
    for i, ((ry, rcb, rcr), _fd) in enumerate(dec):
        assert np.array_equal(ry[:h, :w], recs[i][0]), f"frame {i}"
        assert np.array_equal(rcb[:h // 2, :w // 2], recs[i][1]), i
        assert np.array_equal(rcr[:h // 2, :w // 2], recs[i][2]), i
    return stream, enc


def test_row_slices_intra():
    """slices=wpp: one NAL per CTU row, dependent segments."""
    cfg = Config(width=192, height=128, qp=30, intra_period=1,
                 intra_max_cu=16, intra_min_cu=16, wpp=True,
                 slices="wpp", hash="md5")
    stream, enc = _roundtrip(cfg, _clip(2, 192, 128))
    slice_nals = [t for t, _tid, _r in split_annexb(stream)
                  if t in (0, 1, 19, 20)]
    # 2 CTU rows per picture x 2 pictures.
    assert len(slice_nals) == 4


def test_row_slices_ippp():
    cfg = Config(width=128, height=192, qp=32, intra_period=0,
                 intra_max_cu=16, intra_min_cu=16, wpp=True,
                 slices="wpp")
    stream, enc = _roundtrip(cfg, _clip(3, 128, 192))
    slice_nals = [t for t, _tid, _r in split_annexb(stream)
                  if t in (0, 1, 19, 20)]
    assert len(slice_nals) == 3 * 3      # 3 rows x 3 pictures


def test_tile_slices_intra():
    """slices=tiles: one independent slice NAL per tile."""
    cfg = Config(width=192, height=128, qp=30, intra_period=1,
                 intra_max_cu=16, intra_min_cu=16, wpp=False,
                 tiles_x=2, tiles_y=2, slices="tiles", hash="md5")
    stream, enc = _roundtrip(cfg, _clip(2, 192, 128))
    slice_nals = [t for t, _tid, _r in split_annexb(stream)
                  if t in (0, 1, 19, 20)]
    assert len(slice_nals) == 8          # 4 tiles x 2 pictures


def test_tile_slices_ippp():
    cfg = Config(width=192, height=128, qp=30, intra_period=0,
                 intra_max_cu=16, intra_min_cu=16, wpp=False,
                 tiles_x=2, tiles_y=1, slices="tiles")
    _roundtrip(cfg, _clip(3, 192, 128))


def test_row_slices_same_recon_as_single_slice():
    """Slice segmentation must not change reconstruction (dependent
    segments keep all prediction/context continuity)."""
    frames = _clip(2, 128, 128)
    base = Config(width=128, height=128, qp=30, intra_period=0,
                  intra_max_cu=16, intra_min_cu=16, wpp=True)
    enc_a = Encoder(base)
    rec_a = [r for _c, _i, r in enc_a.encode_stream(iter(frames),
                                                    need_recon=True)]
    cfg_b = Config(width=128, height=128, qp=30, intra_period=0,
                   intra_max_cu=16, intra_min_cu=16, wpp=True,
                   slices="wpp")
    enc_b = Encoder(cfg_b)
    rec_b = [r for _c, _i, r in enc_b.encode_stream(iter(frames),
                                                    need_recon=True)]
    for a, b in zip(rec_a, rec_b):
        np.testing.assert_array_equal(a[0], b[0])


def test_slices_config_validation():
    with pytest.raises(ValueError):
        Config(width=64, height=64, qp=30, slices="wpp",
               wpp=False).validate()
    with pytest.raises(ValueError):
        Config(width=64, height=64, qp=30, slices="tiles").validate()
    with pytest.raises(ValueError):
        Config(width=64, height=64, qp=30, slices="bogus").validate()
