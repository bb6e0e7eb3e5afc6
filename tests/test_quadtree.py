"""Variable-CU quadtree: e2e bit-exactness through the oracle decoder
and tree plausibility (the reference capability being matched is the
recursive CU search of /root/reference/src/search.c:424-757)."""

import numpy as np
import pytest

from kvazaar_jax.config import Config
from kvazaar_jax.encoder.frame_encoder import IntraFrameEncoder, psnr
from kvazaar_jax.bitstream.decoder import decode_stream

pytestmark = pytest.mark.smoke


def _mixed_frame(w, h, seed=7):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = (128 + 40 * np.sin(xx / 23.0)).astype(np.float64)
    y[:, w // 2:] += rng.normal(0, 28, (h, w // 2))
    y = np.clip(y, 0, 255).astype(np.uint8)
    cb = np.clip(110 + 20 * np.cos(yy[::2, ::2] / 9.0)
                 + rng.normal(0, 8, (h // 2, w // 2)), 0,
                 255).astype(np.uint8)
    cr = np.clip(140 + rng.normal(0, 12, (h // 2, w // 2)), 0,
                 255).astype(np.uint8)
    return y, cb, cr


@pytest.mark.parametrize("deblock", [False, True])
def test_quadtree_bit_exact(deblock):
    w, h = 96, 64
    y, cb, cr = _mixed_frame(w, h)
    cfg = Config(width=w, height=h, qp=27, intra_min_cu=8,
                 intra_max_cu=32, deblock=deblock)
    enc = IntraFrameEncoder(cfg)
    res = enc.encode_frame(y, cb, cr)
    depths = res.frame_data.depth8
    assert len(np.unique(depths)) >= 2, "tree should actually vary"
    (dy, dcb, dcr), fd = decode_stream(enc.headers() + res.nals,
                                       enc.params)[0]
    np.testing.assert_array_equal(dy, res.recon_y)
    np.testing.assert_array_equal(dcb, res.recon_cb)
    np.testing.assert_array_equal(dcr, res.recon_cr)
    assert psnr(res.recon_y[:h, :w], y.astype(np.int32)) > 30.0


def test_quadtree_respects_bounds():
    w, h = 64, 64
    y, cb, cr = _mixed_frame(w, h, seed=3)
    cfg = Config(width=w, height=h, qp=27, intra_min_cu=16,
                 intra_max_cu=32)
    enc = IntraFrameEncoder(cfg)
    res = enc.encode_frame(y, cb, cr)
    sizes = 64 >> res.frame_data.depth8.astype(np.int32)
    assert sizes.min() >= 16 and sizes.max() <= 32
    (dy, _, _), _ = decode_stream(enc.headers() + res.nals,
                                  enc.params)[0]
    np.testing.assert_array_equal(dy, res.recon_y)


def _smooth_plus_noise(w, h, seed=9):
    """Left half very smooth (wants 64 CUs), right half noisy."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = (100 + 30 * (xx / w)).astype(np.float64)
    y[:, w // 2:] += rng.normal(0, 30, (h, w // 2))
    y = np.clip(y, 0, 255).astype(np.uint8)
    cb = np.full((h // 2, w // 2), 110, np.uint8)
    cr = np.clip(130 + rng.normal(0, 10, (h // 2, w // 2)), 0,
                 255).astype(np.uint8)
    return y, cb, cr


def test_quadtree_cu64_bit_exact():
    """64x64 CUs (forced 32x32 TU split) decode bit-exact and appear
    on smooth content (the reference's depth-0 search level,
    src/search.c:424)."""
    w, h = 192, 128
    y, cb, cr = _smooth_plus_noise(w, h)
    cfg = Config(width=w, height=h, qp=32, intra_min_cu=8,
                 intra_max_cu=64)
    enc = IntraFrameEncoder(cfg)
    res = enc.encode_frame(y, cb, cr)
    assert (res.frame_data.depth8 == 0).any(), \
        "smooth content should pick some 64x64 CUs"
    (dy, dcb, dcr), fd = decode_stream(enc.headers() + res.nals,
                                       enc.params)[0]
    np.testing.assert_array_equal(dy, res.recon_y)
    np.testing.assert_array_equal(dcb, res.recon_cb)
    np.testing.assert_array_equal(dcr, res.recon_cr)
    assert psnr(res.recon_y[:h, :w], y.astype(np.int32)) > 28.0


def test_quadtree_cu64_saves_bits_on_smooth():
    """Allowing 64x64 CUs must not cost bits on smooth content."""
    w, h = 128, 128
    yy, xx = np.mgrid[0:h, 0:w]
    y = np.clip(100 + 30 * (xx / w) + 10 * np.sin(yy / 40.0), 0,
                255).astype(np.uint8)
    cb = np.full((h // 2, w // 2), 110, np.uint8)
    cr = np.full((h // 2, w // 2), 130, np.uint8)
    enc32 = IntraFrameEncoder(Config(width=w, height=h, qp=32,
                                     intra_min_cu=8, intra_max_cu=32))
    r32 = enc32.encode_frame(y, cb, cr)
    enc64 = IntraFrameEncoder(Config(width=w, height=h, qp=32,
                                     intra_min_cu=8, intra_max_cu=64))
    r64 = enc64.encode_frame(y, cb, cr)
    assert r64.bits <= r32.bits
    (dy, _, _), _ = decode_stream(enc64.headers() + r64.nals,
                                  enc64.params)[0]
    np.testing.assert_array_equal(dy, r64.recon_y)
