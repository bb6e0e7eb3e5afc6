"""--rd 2: true-roundtrip RDO mode decision with the vectorized TB
rate model (reference search_intra_rdo src/search_intra.c:573 +
kvz_get_coeff_cost src/rdo.c:208)."""

import numpy as np
import pytest

from kvazaar_jax.bitstream.decoder import decode_stream
from kvazaar_jax.config import Config, config_from_preset
from kvazaar_jax.encoder.frame_encoder import IntraFrameEncoder, psnr

pytestmark = pytest.mark.heavy


def _frame(w, h, seed=4):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = np.clip(128 + 45 * np.sin(xx / 11.0) * np.cos(yy / 17.0)
                + rng.normal(0, 7, (h, w)), 0, 255).astype(np.uint8)
    cb = np.clip(110 + 25 * np.sin(xx[::2, ::2] / 13.0), 0,
                 255).astype(np.uint8)
    cr = np.clip(135 + 20 * np.cos(yy[::2, ::2] / 7.0), 0,
                 255).astype(np.uint8)
    return y, cb, cr


def test_rate_model_tracks_cabac():
    """The rate model must rank TBs like the real CABAC (correlation
    gate — the model feeds argmins, not bit budgets)."""
    import jax.numpy as jnp
    from kvazaar_jax.bitstream.bits import BitWriter
    from kvazaar_jax.bitstream.cabac import CabacEncoder
    from kvazaar_jax.bitstream.contexts import Contexts
    from kvazaar_jax.bitstream.headers import StreamParams
    from kvazaar_jax.bitstream.syntax import FrameData, SliceDataEncoder
    from kvazaar_jax.constants import SLICE_I
    from kvazaar_jax.ops.rate import tb_rate_bits
    rng = np.random.default_rng(1)
    for size in (4, 16, 32):
        actual, est = [], []
        for _ in range(50):
            dens = rng.uniform(0.03, 0.4)
            blk = np.where(
                rng.random((size, size)) < dens,
                rng.integers(1, 30, (size, size))
                * rng.choice([-1, 1], (size, size)), 0).astype(np.int32)
            if not blk.any():
                blk[0, 0] = 1
            W = H = max(size * 2, 64)
            params = StreamParams(width=W, height=H, qp=30,
                                  chroma_format_idc=0)
            fd = FrameData.empty(W, H, False)
            fd.mode4[:] = 1
            fd.coeff_y[:size, :size] = blk
            w = BitWriter()
            enc = SliceDataEncoder(params, fd, Contexts(SLICE_I, 30),
                                   CabacEncoder(w))
            bw = BitWriter()
            bc = CabacEncoder(bw)
            bc.encode_terminate(1)
            bw.align_zero()
            base = len(bw.get_bytes()) * 8
            enc.residual_coding(0, 0, size.bit_length() - 1, 0)
            enc.c.encode_terminate(1)
            w.align_zero()
            actual.append(len(w.get_bytes()) * 8 - base)
            est.append(float(tb_rate_bits(jnp.asarray(blk[None]))[0]))
        corr = np.corrcoef(np.array(actual, float),
                           np.array(est, float))[0, 1]
        assert corr > 0.95, f"size {size}: corr {corr}"


def test_rd2_bit_exact_fixed_grid():
    w = h = 128
    cfg = Config(width=w, height=h, qp=30, intra_min_cu=16,
                 intra_max_cu=16, rd=2)
    enc = IntraFrameEncoder(cfg)
    y, cb, cr = _frame(w, h)
    res = enc.encode_frame(y, cb, cr)
    (dy, dcb, dcr), _fd = decode_stream(enc.headers() + res.nals,
                                        enc.params)[0]
    np.testing.assert_array_equal(dy, res.recon_y)
    np.testing.assert_array_equal(dcb, res.recon_cb)
    np.testing.assert_array_equal(dcr, res.recon_cr)


def test_rd2_bit_exact_quadtree_cu64():
    w, h = 128, 128
    cfg = Config(width=w, height=h, qp=32, intra_min_cu=8,
                 intra_max_cu=64, rd=2)
    enc = IntraFrameEncoder(cfg)
    y, cb, cr = _frame(w, h, seed=6)
    res = enc.encode_frame(y, cb, cr)
    (dy, dcb, dcr), _fd = decode_stream(enc.headers() + res.nals,
                                        enc.params)[0]
    np.testing.assert_array_equal(dy, res.recon_y)
    np.testing.assert_array_equal(dcb, res.recon_cb)
    np.testing.assert_array_equal(dcr, res.recon_cr)


def test_rd2_improves_rd_tradeoff():
    """rd 2 should beat rd 1 on the Lagrangian (D + lambda*R) it
    optimizes, at the same QP."""
    from kvazaar_jax.encoder.frame_encoder import qp_to_lambda
    w = h = 128
    y, cb, cr = _frame(w, h, seed=8)
    outs = {}
    for rd in (1, 2):
        cfg = Config(width=w, height=h, qp=32, intra_min_cu=16,
                     intra_max_cu=16, rd=rd)
        enc = IntraFrameEncoder(cfg)
        res = enc.encode_frame(y, cb, cr)
        d = float(((res.recon_y[:h, :w].astype(np.int64)
                    - y.astype(np.int64)) ** 2).sum())
        outs[rd] = d + qp_to_lambda(32) * res.bits
    assert outs[2] <= outs[1] * 1.005, outs


def test_slow_preset_runs_rd2():
    cfg = config_from_preset("slow", width=64, height=64, qp=32,
                             intra_period=1)
    assert cfg.rd == 2
    cfg.validate()
