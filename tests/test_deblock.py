"""Deblocking filter: batched device implementation vs an independent
scalar per-pixel implementation of H.265 8.7.2 (all-intra, bs=2)."""

import numpy as np
import pytest

from kvazaar_jax.ops.deblock import (BETA_TABLE, TC_TABLE, deblock_plane,
                                     luma_params)

pytestmark = pytest.mark.heavy


def scalar_deblock_luma(plane, qp, step, bitdepth=8):
    """Direct per-pixel spec implementation (vertical then horizontal)."""
    beta, tc = luma_params(qp, 0, 0, bitdepth)
    maxv = (1 << bitdepth) - 1
    out = plane.astype(np.int64).copy()

    def clip3(lo, hi, v):
        return max(lo, min(hi, v))

    def filter_edge_columns(a, xs):
        h = a.shape[0]
        for x in xs:
            for gy in range(0, h, 4):
                # gather p/q for the 4 lines
                P = [[a[gy + i, x - 1 - k] for k in range(4)]
                     for i in range(4)]
                Q = [[a[gy + i, x + k] for k in range(4)]
                     for i in range(4)]
                dp = [abs(P[i][2] - 2 * P[i][1] + P[i][0])
                      for i in range(4)]
                dq = [abs(Q[i][2] - 2 * Q[i][1] + Q[i][0])
                      for i in range(4)]
                dp03, dq03 = dp[0] + dp[3], dq[0] + dq[3]
                d = dp03 + dq03
                if d >= beta:
                    continue
                strong = all(
                    2 * (dp[i] + dq[i]) < (beta >> 2)
                    and abs(P[i][3] - P[i][0]) + abs(Q[i][0] - Q[i][3])
                    < (beta >> 3)
                    and abs(P[i][0] - Q[i][0]) < ((5 * tc + 1) >> 1)
                    for i in (0, 3))
                for i in range(4):
                    p3, p2, p1, p0 = (P[i][3], P[i][2], P[i][1],
                                      P[i][0])
                    q0, q1, q2, q3 = (Q[i][0], Q[i][1], Q[i][2],
                                      Q[i][3])
                    if strong:
                        a[gy + i, x - 1] = clip3(
                            p0 - 2 * tc, p0 + 2 * tc,
                            (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4)
                            >> 3)
                        a[gy + i, x - 2] = clip3(
                            p1 - 2 * tc, p1 + 2 * tc,
                            (p2 + p1 + p0 + q0 + 2) >> 2)
                        a[gy + i, x - 3] = clip3(
                            p2 - 2 * tc, p2 + 2 * tc,
                            (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3)
                        a[gy + i, x] = clip3(
                            q0 - 2 * tc, q0 + 2 * tc,
                            (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4)
                            >> 3)
                        a[gy + i, x + 1] = clip3(
                            q1 - 2 * tc, q1 + 2 * tc,
                            (p0 + q0 + q1 + q2 + 2) >> 2)
                        a[gy + i, x + 2] = clip3(
                            q2 - 2 * tc, q2 + 2 * tc,
                            (p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3)
                    else:
                        delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
                        if abs(delta) >= 10 * tc:
                            continue
                        delta = clip3(-tc, tc, delta)
                        a[gy + i, x - 1] = clip3(0, maxv, p0 + delta)
                        a[gy + i, x] = clip3(0, maxv, q0 - delta)
                        if dp03 < ((beta + (beta >> 1)) >> 3):
                            dp1 = clip3(-(tc >> 1), tc >> 1,
                                        (((p2 + p0 + 1) >> 1) - p1
                                         + delta) >> 1)
                            a[gy + i, x - 2] = clip3(0, maxv, p1 + dp1)
                        if dq03 < ((beta + (beta >> 1)) >> 3):
                            dq1 = clip3(-(tc >> 1), tc >> 1,
                                        (((q2 + q0 + 1) >> 1) - q1
                                         - delta) >> 1)
                            a[gy + i, x + 1] = clip3(0, maxv, q1 + dq1)

    xs = list(range(step, plane.shape[1], step))
    filter_edge_columns(out, xs)
    outT = np.ascontiguousarray(out.T)
    filter_edge_columns(outT, list(range(step, plane.shape[0], step)))
    return outT.T


@pytest.mark.parametrize("step,qp,seed", [
    (8, 22, 0), (16, 27, 1), (32, 37, 2), (16, 45, 3), (16, 10, 4),
])
def test_luma_deblock_matches_scalar(step, qp, seed):
    rng = np.random.default_rng(seed)
    h, w = 64, 96
    # Blocky content: constant blocks + noise → exercises strong+weak.
    base = rng.integers(0, 256, (h // step, w // step))
    plane = np.kron(base, np.ones((step, step), np.int64))
    plane += rng.integers(-6, 7, (h, w))
    plane = np.clip(plane, 0, 255).astype(np.int32)

    want = scalar_deblock_luma(plane.copy(), qp, step)
    import jax.numpy as jnp
    got = np.asarray(deblock_plane(jnp.asarray(plane), qp, step))
    np.testing.assert_array_equal(got, want)


def test_chroma_deblock_basic():
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    plane = rng.integers(0, 256, (32, 32)).astype(np.int32)
    got = np.asarray(deblock_plane(jnp.asarray(plane), 30, 8,
                                   chroma=True))
    # p0/q0 at each 8-grid edge must move toward each other or stay.
    assert got.shape == plane.shape
    # Spec scalar check on one edge, one row:
    from kvazaar_jax.encoder.frame_encoder import chroma_qp
    cqp = chroma_qp(30)
    tc = int(TC_TABLE[min(max(cqp + 2, 0), 53)])
    x, y = 8, 3
    p1, p0, q0, q1 = (int(plane[y, x - 2]), int(plane[y, x - 1]),
                      int(plane[y, x]), int(plane[y, x + 1]))
    delta = max(-tc, min(tc, (((q0 - p0) * 4) + p1 - q1 + 4) >> 3))
    # column x filtered vertically first; row y may be changed by the
    # horizontal pass only if y is at an edge — pick y=3 (not near one).
    assert got[y, x - 1] == max(0, min(255, p0 + delta))
    assert got[y, x] == max(0, min(255, q0 - delta))
