"""RDOQ (rate-distortion optimized quantization): vectorized candidate
search + group zeroing (reference capability: kvz_rdoq,
/root/reference/src/rdo.c:548-884)."""

import numpy as np

from kvazaar_jax.config import Config
from kvazaar_jax.encoder.frame_encoder import IntraFrameEncoder, psnr
from kvazaar_jax.bitstream.decoder import decode_stream
import pytest

pytestmark = pytest.mark.smoke


def _frame(w, h, seed=11):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = np.clip(128 + 50 * np.sin(xx / 17.0) * np.cos(yy / 11.0)
                + rng.normal(0, 10, (h, w)), 0, 255).astype(np.uint8)
    cb = np.clip(110 + 25 * np.sin(xx[::2, ::2] / 13.0), 0,
                 255).astype(np.uint8)
    cr = np.clip(140 + 20 * np.cos(yy[::2, ::2] / 7.0), 0,
                 255).astype(np.uint8)
    return y, cb, cr


def test_rdoq_bit_exact_and_rd():
    w, h = 128, 96
    y, cb, cr = _frame(w, h)
    results = {}
    for rdoq in (False, True):
        cfg = Config(width=w, height=h, qp=32, intra_max_cu=16,
                     intra_min_cu=16, rdoq=rdoq)
        enc = IntraFrameEncoder(cfg)
        res = enc.encode_frame(y, cb, cr)
        (dy, dcb, dcr), _fd = decode_stream(enc.headers() + res.nals,
                                            enc.params)[0]
        np.testing.assert_array_equal(dy, res.recon_y)
        np.testing.assert_array_equal(dcb, res.recon_cb)
        results[rdoq] = (res.bits, psnr(res.recon_y[:h, :w],
                                        y.astype(np.int32)))
    bits0, p0 = results[False]
    bits1, p1 = results[True]
    # The RD objective must not be worse on both axes.
    assert bits1 <= bits0 * 1.10
    assert p1 >= p0 - 0.05
    assert (bits1 < bits0) or (p1 > p0)


def test_rdoq_levels_subset_sane():
    from kvazaar_jax.ops.quant import quantize, quantize_rdoq
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    c = jnp.asarray(rng.integers(-2000, 2000, (8, 16, 16), np.int32))
    base = np.asarray(quantize(c, 30, 16, 8, intra=True))
    opt = np.asarray(quantize_rdoq(c, 30, 16, 8, intra=True, lam=20.0))
    # Candidates are {0, l-1, l} of the round-half level, which bounds
    # the plain (171/512-offset) level + 1.
    assert (np.abs(opt) <= np.abs(base) + 1).all()
    both = (opt != 0) & (base != 0)
    assert (np.sign(opt[both]) == np.sign(base[both])).all()
