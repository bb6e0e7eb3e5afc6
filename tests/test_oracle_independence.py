"""Oracle independence: naive-spec models for the two op families the
bitstream oracle (bitstream/decoder.py:29-33) imports FROM the encoder —
`inverse_transform` and `predict_modes` — so a shared bug in those ops
can no longer pass the conformance gate unnoticed (VERDICT r4 weak #8).

Both models (kvazaar_jax/refmodels.py) are written straight from the H.265 text with scalar
loops and none of the encoder's machinery:

- the DCT table is built by direct angle reduction of
  cos(i*(2j+1)*pi/64) against the hand-tuned magnitude list of the
  standard (the encoder derives it via the DCT-II even/odd recursion,
  ops/transform.py:41 — a recursion bug would not reproduce here);
- the inverse transform is the two-stage scalar sum of 8.6.4.2 with
  explicit intermediate clipping (the encoder runs exact float einsums,
  ops/exactmm.py);
- intra prediction is the literal per-pixel 8.4.4.2.4/.5/.6 equations
  including the inverse-angle projection and the DC/10/26 boundary
  filters (the encoder bakes every mode into a (35, N*N, 2R) weight
  tensor and predicts by matmul, ops/intra.py:73).

Reference anchors: src/strategies/generic/dct-generic.c (partial
butterflies), src/intra.c:482 (kvz_intra_predict).
"""

import numpy as np
import pytest

from kvazaar_jax.ops.transform import dct_matrix_np, inverse_transform
from kvazaar_jax.ops.intra import predict_modes
from kvazaar_jax.refmodels import (spec_dct, spec_intra_predict,
                                   spec_inverse_transform)

pytestmark = pytest.mark.smoke


def test_dct_tables_match_direct_angle_model():
    # 32-point rows of the spec table vs the encoder's recursion.
    for n in (4, 8, 16, 32):
        enc = dct_matrix_np(n)
        ref = spec_dct(n)
        assert np.array_equal(enc, ref), f"DCT{n} table mismatch"


@pytest.mark.parametrize("size", [4, 8, 16, 32])
@pytest.mark.parametrize("bitdepth", [8, 10])
def test_inverse_transform_matches_scalar_spec_model(size, bitdepth):
    rng = np.random.default_rng(size * 10 + bitdepth)
    # include near-dynamic-range coefficients to exercise the clipping
    c = rng.integers(-32768, 32768, (3, size, size)).astype(np.int32)
    c[0] //= 64          # typical small coefficients
    ours = np.asarray(inverse_transform(c, size, bitdepth=bitdepth))
    for b in range(c.shape[0]):
        want = spec_inverse_transform(c[b], size, bitdepth=bitdepth)
        assert np.array_equal(ours[b], want), (size, bitdepth, b)


@pytest.mark.parametrize("bitdepth", [8, 10])
def test_inverse_dst_matches_scalar_spec_model(bitdepth):
    rng = np.random.default_rng(7 + bitdepth)
    c = rng.integers(-8000, 8000, (4, 4, 4)).astype(np.int32)
    ours = np.asarray(inverse_transform(c, 4, bitdepth=bitdepth,
                                        dst=True))
    for b in range(c.shape[0]):
        want = spec_inverse_transform(c[b], 4, bitdepth=bitdepth,
                                      dst=True)
        assert np.array_equal(ours[b], want), (bitdepth, b)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("luma", [True, False])
def test_intra_pred_matches_scalar_spec_model(n, luma):
    if not luma and n == 32:
        pytest.skip("chroma TBs are 4..16")
    bitdepth = 8
    rng = np.random.default_rng(n + luma)
    refs = rng.integers(0, 256, (2, 4 * n + 1)).astype(np.int32)
    for mode in range(35):
        ours = np.asarray(predict_modes(
            refs, np.full((2,), mode, np.int32), n, luma=luma,
            bitdepth=bitdepth))
        for b in range(2):
            want = spec_intra_predict(refs[b], mode, n, luma=luma,
                                      bitdepth=bitdepth)
            assert np.array_equal(ours[b], want), (n, luma, mode, b)


@pytest.mark.parametrize("n", [8, 16])
def test_intra_pred_matches_scalar_spec_model_10bit(n):
    rng = np.random.default_rng(42 + n)
    refs = rng.integers(0, 1024, (2, 4 * n + 1)).astype(np.int32)
    for mode in (0, 1, 2, 10, 18, 26, 34, 7, 23):
        ours = np.asarray(predict_modes(
            refs, np.full((2,), mode, np.int32), n, luma=True,
            bitdepth=10))
        for b in range(2):
            want = spec_intra_predict(refs[b], mode, n, luma=True,
                                      bitdepth=10)
            assert np.array_equal(ours[b], want), (n, mode, b)
