"""Tiles: uniform-spacing tile grid — independent CABAC substreams
with entry points, prediction cut at tile boundaries, tile-band
multi-chip sharding.

Reference behavior: tile geometry (src/encoder.c:387-520), per-tile
encoder states (src/encoderstate.c:860-965), PPS tile syntax
(src/encoder_state-bitstream.c:463-473).
"""

import numpy as np
import pytest

from kvazaar_jax.api import Encoder
from kvazaar_jax.bitstream.decoder import decode_stream
from kvazaar_jax.config import Config

pytestmark = pytest.mark.heavy


def _clip(n, w, h, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        out.append((
            (rng.integers(0, 255, (h, w)) * 0.5 + 50 + 5 * i)
            .astype(np.uint8),
            rng.integers(90, 160, (h // 2, w // 2)).astype(np.uint8),
            rng.integers(90, 160, (h // 2, w // 2)).astype(np.uint8)))
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
        assert np.array_equal(ry[:h, :w], recs[i][0]), f"frame {i} y"
        assert np.array_equal(rcb[:h // 2, :w // 2], recs[i][1]), i
        assert np.array_equal(rcr[:h // 2, :w // 2], recs[i][2]), i
    return stream


@pytest.mark.parametrize("tiles,sao", [((2, 2), False), ((2, 2), True),
                                       ((2, 1), False)])
def test_tiles_intra_bit_exact(tiles, sao):
    cfg = Config(width=128, height=128, qp=30, intra_period=1,
                 intra_max_cu=16, intra_min_cu=16, wpp=False,
                 tiles_x=tiles[0], tiles_y=tiles[1], sao=sao,
                 hash="md5")
    _roundtrip(cfg, _clip(2, 128, 128))


def test_tiles_ippp_bit_exact():
    cfg = Config(width=128, height=128, qp=30, intra_period=0,
                 intra_max_cu=16, intra_min_cu=16, wpp=False,
                 tiles_x=2, tiles_y=2, hash="md5")
    _roundtrip(cfg, _clip(4, 128, 128))


def test_tiles_nonuniform_columns():
    """5 CTU columns over 3 tiles: uniform-spacing widths 1/2/2
    (7.4.3.3.1 rounding)."""
    cfg = Config(width=320, height=64, qp=32, intra_period=1,
                 intra_max_cu=16, intra_min_cu=16, wpp=False,
                 tiles_x=3, tiles_y=1, hash="md5")
    _roundtrip(cfg, _clip(1, 320, 64))


def test_tiles_fewer_bits_than_independent_frames():
    """Tile streams must still beat intra-heavy coding: sanity that a
    tiled stream stays within 15% of the untiled stream's size (broken
    cross-tile prediction costs a little, not a lot)."""
    frames = _clip(2, 128, 128)
    base = _roundtrip(
        Config(width=128, height=128, qp=30, intra_period=1,
               intra_max_cu=16, intra_min_cu=16, wpp=False,
               hash="md5"), frames)
    tiled = _roundtrip(
        Config(width=128, height=128, qp=30, intra_period=1,
               intra_max_cu=16, intra_min_cu=16, wpp=False,
               tiles_x=2, tiles_y=2, hash="md5"), frames)
    assert len(tiled) < len(base) * 1.15


def test_tiles_wavefront_shorter():
    """Tile boundaries cut dependencies: the recon schedule of a tiled
    plan must be strictly shorter than the untiled one."""
    from kvazaar_jax.encoder.geometry import make_intra_plan
    plain = make_intra_plan(256, 256, 16, chroma=False)
    tiled = make_intra_plan(256, 256, 16, chroma=False, tiles=(2, 2))
    assert tiled.n_steps < plain.n_steps


@pytest.mark.parametrize("ndev", [2, 4])
def test_tile_band_sharding_bit_identical(ndev):
    """Tile-row bands sharded over a device mesh: zero-communication
    per-band encode equals the single-device tiled encode."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from kvazaar_jax.encoder.geometry import make_intra_plan
    from kvazaar_jax.encoder.intra_recon import reconstruct_frames
    from kvazaar_jax.encoder.intra_search import search_frame_modes
    from kvazaar_jax.parallel.sharding import \
        intra_encode_tiles_sharded
    if len(jax.devices()) < ndev:
        pytest.skip("needs virtual device mesh")
    h = w = 64 * ndev
    rng = np.random.default_rng(3)
    y = jnp.asarray(rng.integers(0, 255, (h, w), np.int32))
    mesh = Mesh(np.array(jax.devices()[:ndev]), ("rows",))
    modes_s, rec_s = intra_encode_tiles_sharded(
        y, 30, 8.0, mesh)

    plan = make_intra_plan(w, h, 16, chroma=False, tiles=(1, ndev))
    modes, _c = search_frame_modes(y, plan, 8.0, 8, two_pass=False)
    rec = reconstruct_frames(y[None], None, None, modes[None], plan,
                             30, 30, 8)[0][0]
    assert np.array_equal(np.asarray(modes_s), np.asarray(modes))
    assert np.array_equal(np.asarray(rec_s), np.asarray(rec))


@pytest.mark.parametrize("tiles", [(2, 2), (3, 2)])
def test_tiles_plus_wpp_bit_exact(tiles):
    """Tiles x WPP combined: one CABAC substream per CTU row per tile
    (7.4.3.3; driver config #4's --wpp --tiles shape)."""
    cfg = Config(width=192, height=128, qp=30, intra_period=1,
                 intra_max_cu=16, intra_min_cu=16, wpp=True,
                 tiles_x=tiles[0], tiles_y=tiles[1], hash="md5")
    _roundtrip(cfg, _clip(2, 192, 128))


def test_tiles_plus_wpp_ippp_bit_exact():
    cfg = Config(width=192, height=128, qp=32, intra_period=0,
                 intra_max_cu=16, intra_min_cu=16, wpp=True,
                 tiles_x=2, tiles_y=2)
    _roundtrip(cfg, _clip(3, 192, 128))


def test_tiles_plus_wpp_entry_point_count():
    """Substream count = sum over tiles of tile CTU rows."""
    from kvazaar_jax.bitstream.headers import StreamParams
    from kvazaar_jax.bitstream.syntax import (FrameData,
                                              SliceDataEncoder)
    from kvazaar_jax.bitstream.bits import BitWriter
    from kvazaar_jax.bitstream.cabac import CabacEncoder
    from kvazaar_jax.bitstream.contexts import Contexts
    from kvazaar_jax.constants import SLICE_I
    import sys
    sys.path.insert(0, "tests")
    from test_syntax import random_frame_data
    rng = np.random.default_rng(2)
    W, H = 256, 128   # 4x2 CTUs; tiles 2x1 -> 2 tiles x 2 rows = 4
    params = StreamParams(width=W, height=H, qp=30,
                          chroma_format_idc=1, wpp=True,
                          tiles=(2, 1))
    fd = random_frame_data(rng, W, H, True)
    w = BitWriter()
    enc = SliceDataEncoder(params, fd, Contexts(SLICE_I, 30),
                           CabacEncoder(w))
    sizes = enc.encode_slice_data_tiles_wpp()
    assert len(sizes) == 4
