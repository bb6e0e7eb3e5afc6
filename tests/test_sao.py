"""SAO (H.265 8.7.3): search/apply round trip, e2e bit-exactness, and
native-serializer byte identity (reference capability:
/root/reference/src/sao.c:278,467,646 + encode_sao,
src/encoderstate.c:443-513)."""

import dataclasses

import numpy as np

from kvazaar_jax.config import Config
from kvazaar_jax.encoder.frame_encoder import IntraFrameEncoder, psnr
from kvazaar_jax.bitstream.decoder import decode_stream
import pytest

pytestmark = pytest.mark.heavy


def _frame(w, h, seed=11):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = np.clip(128 + 50 * np.sin(xx / 17.0) * np.cos(yy / 11.0)
                + rng.normal(0, 10, (h, w)), 0, 255).astype(np.uint8)
    cb = np.clip(110 + 25 * np.sin(xx[::2, ::2] / 13.0)
                 + rng.normal(0, 6, (h // 2, w // 2)), 0,
                 255).astype(np.uint8)
    cr = np.clip(140 + 20 * np.cos(yy[::2, ::2] / 7.0)
                 + rng.normal(0, 6, (h // 2, w // 2)), 0,
                 255).astype(np.uint8)
    return y, cb, cr


def test_sao_bit_exact_and_gain():
    w, h = 128, 96
    y, cb, cr = _frame(w, h)
    cfg = Config(width=w, height=h, qp=30, intra_max_cu=16,
                 intra_min_cu=16, sao=True, hash="md5")
    enc = IntraFrameEncoder(cfg)
    res = enc.encode_frame(y, cb, cr)
    # decode_stream also verifies the MD5 picture-hash SEI (post-SAO).
    (dy, dcb, dcr), fd = decode_stream(enc.headers() + res.nals,
                                       enc.params)[0]
    np.testing.assert_array_equal(dy, res.recon_y)
    np.testing.assert_array_equal(dcb, res.recon_cb)
    np.testing.assert_array_equal(dcr, res.recon_cr)
    assert (fd.sao_type > 0).any(), "SAO should actually engage"

    cfg0 = Config(width=w, height=h, qp=30, intra_max_cu=16,
                  intra_min_cu=16, sao=False)
    res0 = IntraFrameEncoder(cfg0).encode_frame(y, cb, cr)
    p_sao = psnr(res.recon_y[:h, :w], y.astype(np.int32))
    p_off = psnr(res0.recon_y[:h, :w], y.astype(np.int32))
    assert p_sao >= p_off, "SAO should not lose PSNR"


def test_sao_native_matches_python():
    from kvazaar_jax.bitstream import native
    from kvazaar_jax.bitstream.bits import BitWriter
    from kvazaar_jax.bitstream.cabac import CabacEncoder
    from kvazaar_jax.bitstream.contexts import Contexts
    from kvazaar_jax.bitstream.syntax import SliceDataEncoder
    from kvazaar_jax.constants import SLICE_I
    w, h = 128, 96
    y, cb, cr = _frame(w, h, seed=5)
    cfg = Config(width=w, height=h, qp=30, intra_max_cu=16,
                 intra_min_cu=16, sao=True)
    enc = IntraFrameEncoder(cfg)
    res = enc.encode_frame(y, cb, cr)
    fd = res.frame_data
    nat, nsizes = native.encode_slice_data_native_wpp(enc.params, fd,
                                                      30)
    bw = BitWriter()
    se = SliceDataEncoder(enc.params, fd, Contexts(SLICE_I, 30),
                          CabacEncoder(bw))
    psizes = se.encode_slice_data_wpp()
    assert nat == bw.get_bytes()
    assert nsizes == psizes


def test_sao_with_quadtree():
    w, h = 96, 64
    y, cb, cr = _frame(w, h, seed=9)
    cfg = Config(width=w, height=h, qp=30, intra_min_cu=8,
                 intra_max_cu=32, sao=True)
    enc = IntraFrameEncoder(cfg)
    res = enc.encode_frame(y, cb, cr)
    (dy, dcb, dcr), _fd = decode_stream(enc.headers() + res.nals,
                                        enc.params)[0]
    np.testing.assert_array_equal(dy, res.recon_y)
    np.testing.assert_array_equal(dcb, res.recon_cb)
    np.testing.assert_array_equal(dcr, res.recon_cr)
