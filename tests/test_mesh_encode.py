"""Multi-device END-TO-END encode: mesh_tiles shards the frame's
tile-row bands over a device mesh (zero-comm search+recon, ppermute
halo-exchanged deblock) and the spliced bitstream must be
BYTE-IDENTICAL to the single-device encode of the same (1, N) tile
config at every mesh size — the analogue of the reference's
OWF/WPP/tiles determinism sweep (tests/test_owf_wpp_tiles.sh)."""

import numpy as np
import pytest

from kvazaar_jax.bitstream.decoder import decode_stream
from kvazaar_jax.config import Config
from kvazaar_jax.encoder.frame_encoder import IntraFrameEncoder

pytestmark = pytest.mark.smoke


def _frame(w, h, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = np.clip(128 + 50 * np.sin(xx / 7.0) * np.cos(yy / 9.0)
                + rng.normal(0, 5, (h, w)), 0, 255).astype(np.uint8)
    cb = rng.integers(90, 150, (h // 2, w // 2)).astype(np.uint8)
    cr = rng.integers(110, 170, (h // 2, w // 2)).astype(np.uint8)
    return y, cb, cr


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_mesh_bitstream_byte_identical(ndev):
    import jax
    if len(jax.devices()) < ndev:
        pytest.skip("needs virtual device mesh")
    w, h = 128, 64 * ndev
    y, cb, cr = _frame(w, h)

    mcfg = Config(width=w, height=h, qp=30, intra_max_cu=16,
                  intra_min_cu=16, intra_period=1, mesh_tiles=ndev)
    menc = IntraFrameEncoder(mcfg)
    mres = menc.encode_frame(y, cb, cr)

    scfg = Config(width=w, height=h, qp=30, intra_max_cu=16,
                  intra_min_cu=16, intra_period=1, tiles_y=ndev)
    senc = IntraFrameEncoder(scfg)
    sres = senc.encode_frame(y, cb, cr)

    assert menc.headers() == senc.headers()
    assert mres.nals == sres.nals, \
        f"mesh {ndev} bitstream differs from single-device"
    np.testing.assert_array_equal(mres.recon_y, sres.recon_y)

    # And the stream is conformant: oracle decode reproduces the recon.
    dec = decode_stream(menc.headers() + mres.nals, menc.params)
    (dy, dcb, dcr), _fd = dec[0]
    np.testing.assert_array_equal(dy, mres.recon_y)
    np.testing.assert_array_equal(dcb, mres.recon_cb)
    np.testing.assert_array_equal(dcr, mres.recon_cr)


def test_mesh_with_tile_columns():
    """mesh bands compose with tile columns: (2, ndev) tile grids."""
    import jax
    if len(jax.devices()) < 2:
        pytest.skip("needs virtual device mesh")
    w, h = 256, 128
    y, cb, cr = _frame(w, h, seed=3)
    mcfg = Config(width=w, height=h, qp=32, intra_max_cu=16,
                  intra_min_cu=16, intra_period=1, mesh_tiles=2,
                  tiles_x=2)
    menc = IntraFrameEncoder(mcfg)
    mres = menc.encode_frame(y, cb, cr)
    scfg = Config(width=w, height=h, qp=32, intra_max_cu=16,
                  intra_min_cu=16, intra_period=1, tiles_x=2,
                  tiles_y=2)
    senc = IntraFrameEncoder(scfg)
    sres = senc.encode_frame(y, cb, cr)
    assert mres.nals == sres.nals
