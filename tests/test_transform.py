import numpy as np
import jax.numpy as jnp

from kvazaar_jax.ops import transform as tr
from kvazaar_jax.ops import quant as q
import pytest

pytestmark = pytest.mark.smoke


def test_dct4_matches_spec_table():
    expect = np.array(
        [
            [64, 64, 64, 64],
            [83, 36, -36, -83],
            [64, -64, -64, 64],
            [36, -83, 83, -36],
        ]
    )
    np.testing.assert_array_equal(tr.dct_matrix_np(4), expect)


def test_dct8_matches_spec_table():
    expect = np.array(
        [
            [64, 64, 64, 64, 64, 64, 64, 64],
            [89, 75, 50, 18, -18, -50, -75, -89],
            [83, 36, -36, -83, -83, -36, 36, 83],
            [75, -18, -89, -50, 50, 89, 18, -75],
            [64, -64, -64, 64, 64, -64, -64, 64],
            [50, -89, 18, 75, -75, -18, 89, -50],
            [36, -83, 83, -36, -36, 83, -83, 36],
            [18, -50, 75, -89, 89, -75, 50, -18],
        ]
    )
    np.testing.assert_array_equal(tr.dct_matrix_np(8), expect)


def test_dct16_32_row_properties():
    for n in (16, 32):
        t = tr.dct_matrix_np(n).astype(np.int64)
        # DC row is all 64.
        assert (t[0] == 64).all()
        # Row norms are all ~64*sqrt(n) (hand-tuned integer approximation).
        norms = np.sqrt((t * t).sum(axis=1))
        np.testing.assert_allclose(norms, 64 * np.sqrt(n), rtol=0.01)
        # Near-orthogonality of distinct rows.
        gram = t @ t.T
        off = gram - np.diag(np.diag(gram))
        assert np.abs(off).max() < 0.02 * gram[0, 0]
        # Even rows symmetric, odd rows antisymmetric.
        for k in range(n):
            sign = 1 if k % 2 == 0 else -1
            np.testing.assert_array_equal(t[k], sign * t[k][::-1])


def test_dct32_known_first_odd_row():
    t = tr.dct_matrix_np(32)
    expect_half = [90, 90, 88, 85, 82, 78, 73, 67,
                   61, 54, 46, 38, 31, 22, 13, 4]
    np.testing.assert_array_equal(t[1][:16], expect_half)


def test_forward_inverse_roundtrip_all_sizes():
    rng = np.random.default_rng(0)
    for size in (4, 8, 16, 32):
        resid = rng.integers(-255, 256, size=(5, size, size), dtype=np.int32)
        coeff = tr.forward_transform(jnp.asarray(resid), size, 8)
        back = np.asarray(tr.inverse_transform(coeff, size, 8))
        err = np.abs(back - resid)
        # Integer transform is near-lossless without quantization; the
        # 16/32-point hand-tuned tables are slightly less orthogonal.
        tol = 2 if size <= 8 else 4
        assert err.max() <= tol, (size, err.max())


def test_dst4_roundtrip():
    rng = np.random.default_rng(1)
    resid = rng.integers(-255, 256, size=(7, 4, 4), dtype=np.int32)
    coeff = tr.forward_transform(jnp.asarray(resid), 4, 8, dst=True)
    back = np.asarray(tr.inverse_transform(coeff, 4, 8, dst=True))
    assert np.abs(back - resid).max() <= 2


def test_dc_block_energy_compaction():
    block = np.full((1, 8, 8), 100, dtype=np.int32)
    coeff = np.asarray(tr.forward_transform(jnp.asarray(block), 8, 8))
    assert coeff[0, 0, 0] != 0
    assert np.abs(coeff[0].ravel()[1:]).max() == 0


def test_quant_dequant_consistency():
    rng = np.random.default_rng(2)
    for size in (4, 8, 16, 32):
        for qp in (0, 10, 22, 37, 51):
            resid = rng.integers(-200, 200, size=(3, size, size),
                                 dtype=np.int32)
            coeff = tr.forward_transform(jnp.asarray(resid), size, 8)
            lev = q.quantize(coeff, qp, size, 8, intra=True)
            deq = q.dequantize(lev, qp, size, 8)
            back = np.asarray(tr.inverse_transform(deq, size, 8))
            # Reconstruction error bounded by ~the quantizer step size
            # (deadzone rounding makes per-coeff error up to ~0.67*qstep,
            # and errors from several coefficients can add in one pixel).
            qstep = 0.63 * 2 ** (qp / 6.0)
            err = np.abs(back - resid)
            assert err.max() <= 1.5 * qstep + 4, (size, qp, err.max())


def test_quant_zero_preserved():
    z = jnp.zeros((2, 8, 8), jnp.int32)
    assert np.asarray(q.quantize(z, 22, 8)).max() == 0
    assert np.asarray(q.dequantize(z, 22, 8)).max() == 0


def test_bitdepth10_roundtrip():
    rng = np.random.default_rng(3)
    # Full-range 10-bit white noise is the transform's worst case: the
    # integer DCT's non-orthogonality admits errors ~1% of range there
    # (HM behaves identically).  Natural/smooth residuals stay tight.
    resid = rng.integers(-1023, 1024, size=(4, 16, 16), dtype=np.int32)
    coeff = tr.forward_transform(jnp.asarray(resid), 16, 10)
    back = np.asarray(tr.inverse_transform(coeff, 16, 10))
    assert np.abs(back - resid).max() <= 16

    smooth = (np.cumsum(rng.integers(-8, 9, size=(4, 16, 16)), axis=-1)
              .astype(np.int32))
    coeff = tr.forward_transform(jnp.asarray(smooth), 16, 10)
    back = np.asarray(tr.inverse_transform(coeff, 16, 10))
    assert np.abs(back - smooth).max() <= 2
