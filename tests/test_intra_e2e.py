"""End-to-end all-intra conformance gate (SURVEY.md §4 implication b/d):

encoder recon (device wavefront, closed loop) must EXACTLY equal the
reconstruction our oracle decoder derives from the emitted bitstream —
this encoder's stand-in for 'HM can decode it and checksums match'.
"""

import numpy as np
import pytest

from kvazaar_jax.bitstream.decoder import decode_stream
from kvazaar_jax.config import Config
from kvazaar_jax.encoder.frame_encoder import IntraFrameEncoder, psnr

pytestmark = pytest.mark.heavy


def synthetic_frame(rng, w, h):
    yy, xx = np.mgrid[0:h, 0:w]
    y = (128 + 60 * np.sin(xx / 9.0) * np.cos(yy / 13.0)
         + rng.normal(0, 6, (h, w)))
    y = np.clip(y, 0, 255).astype(np.uint8)
    cb = np.clip(110 + 30 * np.sin(xx[::2, ::2] / 17.0)
                 + rng.normal(0, 3, (h // 2, w // 2)), 0,
                 255).astype(np.uint8)
    cr = np.clip(140 + 25 * np.cos(yy[::2, ::2] / 11.0)
                 + rng.normal(0, 3, (h // 2, w // 2)), 0,
                 255).astype(np.uint8)
    return y, cb, cr


@pytest.mark.parametrize("w,h,cu,qp", [
    (64, 64, 16, 27),
    (128, 64, 32, 22),
    (96, 96, 8, 32),
    (64, 64, 16, 37),
])
def test_encode_decode_bit_exact(w, h, cu, qp):
    rng = np.random.default_rng(42)
    y, cb, cr = synthetic_frame(rng, w, h)
    cfg = Config(width=w, height=h, qp=qp, intra_max_cu=cu,
                 intra_min_cu=cu)
    enc = IntraFrameEncoder(cfg)
    res = enc.encode_frame(y, cb, cr)
    stream = enc.headers() + res.nals
    frames = decode_stream(stream, enc.params)
    assert len(frames) == 1
    (rec_y, rec_cb, rec_cr), fd = frames[0]

    np.testing.assert_array_equal(fd.mode4, res.frame_data.mode4)
    np.testing.assert_array_equal(fd.coeff_y, res.frame_data.coeff_y)
    np.testing.assert_array_equal(rec_y, res.recon_y)
    np.testing.assert_array_equal(rec_cb, res.recon_cb)
    np.testing.assert_array_equal(rec_cr, res.recon_cr)

    # Quality sanity: recon should actually resemble the source.
    p = psnr(res.recon_y, y.astype(np.int32))
    assert p > 28.0, f"implausibly low PSNR {p}"


def test_flat_frame_codes_tiny():
    cfg = Config(width=64, height=64, qp=27, intra_max_cu=32,
                 intra_min_cu=32)
    enc = IntraFrameEncoder(cfg)
    y = np.full((64, 64), 128, np.uint8)
    cb = np.full((32, 32), 128, np.uint8)
    cr = np.full((32, 32), 128, np.uint8)
    res = enc.encode_frame(y, cb, cr)
    assert np.array_equal(res.recon_y, y.astype(np.int32))
    assert len(res.nals) < 100
    frames = decode_stream(enc.headers() + res.nals, enc.params)
    np.testing.assert_array_equal(frames[0][0][0], y.astype(np.int32))
