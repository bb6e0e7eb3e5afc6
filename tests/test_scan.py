import numpy as np

from kvazaar_jax.ops import scan
import pytest

pytestmark = pytest.mark.smoke


def test_diag_4x4_pattern():
    # H.265 6.5.3 up-right diagonal scan for a 4x4 block.
    expect = [
        (0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0), (0, 3), (1, 2),
        (2, 1), (3, 0), (1, 3), (2, 2), (3, 1), (2, 3), (3, 2), (3, 3),
    ]
    np.testing.assert_array_equal(scan.scan_order(4, scan.SCAN_DIAG), expect)


def test_scans_are_permutations():
    for log2 in (2, 3, 4, 5):
        n = 1 << log2
        for s in (0, 1, 2):
            order = scan.coeff_scan(log2, s)
            lin = order[:, 1] * n + order[:, 0]
            assert sorted(lin.tolist()) == list(range(n * n))


def test_hierarchical_scan_is_subblock_contiguous():
    order = scan.coeff_scan(3, scan.SCAN_DIAG)  # 8x8
    for g in range(4):
        grp = order[g * 16:(g + 1) * 16]
        assert len(set((x // 4, y // 4) for x, y in grp)) == 1


def test_mode_dependent_scan_selection():
    assert scan.intra_scan_idx(10, 2, False) == scan.SCAN_VER
    assert scan.intra_scan_idx(26, 2, False) == scan.SCAN_HOR
    assert scan.intra_scan_idx(0, 2, False) == scan.SCAN_DIAG
    assert scan.intra_scan_idx(10, 3, False) == scan.SCAN_VER
    assert scan.intra_scan_idx(10, 3, True) == scan.SCAN_DIAG
    assert scan.intra_scan_idx(10, 4, False) == scan.SCAN_DIAG
