"""Frame-level R-lambda rate control: the controller must steer the
produced bitrate toward the target across a short IPPP sequence
(analogue of the reference's tests/test_rate_control.sh)."""

import numpy as np
import pytest

from kvazaar_jax.encoder.rate_control import RateController


@pytest.mark.smoke
def test_controller_math_converges():
    rc = RateController(target_bps=1_000_000, fps=25, width=832,
                        height=480)
    # Simulated encoder: bits produced follow a power law of lambda.
    rng = np.random.default_rng(0)
    produced = []
    for i in range(60):
        lam, qp = rc.frame_lambda_qp(is_intra=(i == 0))
        bits = int(3.5e6 * lam ** -0.8 * rng.uniform(0.9, 1.1))
        rc.update(bits, lam)
        produced.append(bits)
    # Average of the second half within 25% of the per-frame target.
    avg = np.mean(produced[30:])
    target = 1_000_000 / 25
    assert abs(avg - target) / target < 0.25, (avg, target)


@pytest.mark.smoke
def test_controller_qp_bounds():
    rc = RateController(target_bps=100, fps=25, width=1920, height=1080)
    lam, qp = rc.frame_lambda_qp()
    assert 4 <= qp <= 47
    rc2 = RateController(target_bps=1e9, fps=25, width=64, height=64)
    lam2, qp2 = rc2.frame_lambda_qp()
    assert 4 <= qp2 <= 47
    assert qp2 < qp


@pytest.mark.heavy
def test_encoder_rate_control_small():
    """End-to-end: tiny all-intra clip under rate control lands near
    the target and the stream still decodes bit-exactly."""
    from kvazaar_jax.api import Encoder
    from kvazaar_jax.bitstream.decoder import decode_stream
    from kvazaar_jax.config import Config

    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:64, 0:64]
    cfg = Config(width=64, height=64, qp=30, intra_max_cu=16,
                 intra_min_cu=16, intra_period=1, bitrate=200_000,
                 framerate_num=25)
    enc = Encoder(cfg)
    stream = b""
    bits = []
    recons = []
    for i in range(6):
        y = np.clip(128 + 60 * np.sin(xx / 5.0 + i) * np.cos(yy / 7.0)
                    + rng.normal(0, 5, (64, 64)), 0, 255).astype(np.uint8)
        cb = np.full((32, 32), 108, np.uint8)
        cr = np.full((32, 32), 145, np.uint8)
        [(chunks, info, rec)] = enc.encode(y, cb, cr)
        stream += chunks
        bits.append(info.bits)
        recons.append(rec)
    target = 200_000 / 25
    avg_tail = np.mean(bits[2:])
    assert 0.3 * target < avg_tail < 3.0 * target, (avg_tail, target)
    # Conformance still holds with per-frame QP changes.
    frames = decode_stream(stream, enc._intra.params)
    assert len(frames) == 6
    for i, ((ry, rcb, rcr), _fd) in enumerate(frames):
        np.testing.assert_array_equal(ry, recons[i][0])


@pytest.mark.smoke
def test_gop_allocation_math():
    """GOP-level allocation (gop_allocate_bits, src/rate_control.c:72):
    the GOP target follows the smoothed spending plan and the anchor
    (lowest qp_offset) gets the largest per-picture share."""
    from kvazaar_jax.api import GOP_TABLES

    rc = RateController(target_bps=800_000, fps=25, width=416,
                        height=240)
    table = GOP_TABLES[8]
    t = rc.allocate_gop(table)
    assert len(t) == 8 and all(x > 0 for x in t)
    # Coding order entry 0 is the P anchor (qp_offset 1) — biggest.
    assert t[0] == max(t)
    # Fresh controller: total == bits_per_frame * 8 (no deficit yet,
    # frames_coded == 0 -> plan = window * bpp; spent = 0).
    assert abs(sum(t) - rc.s.bits_per_frame * 8) / sum(t) < 1e-9
    # After overspending heavily, the next GOP gets squeezed.
    for _ in range(8):
        rc.update(int(rc.s.bits_per_frame * 3), 40.0)
    t2 = rc.allocate_gop(table)
    assert sum(t2) < sum(t)
    # pic_lambda_qp: smaller target -> higher QP.
    _, qp_rich = rc.pic_lambda_qp(t[0])
    _, qp_poor = rc.pic_lambda_qp(t[0] * 0.2)
    assert qp_poor > qp_rich


@pytest.mark.heavy
def test_encoder_gop8_rate_control():
    """End-to-end GOP-8 B pyramid under rate control: GOP-level
    allocation drives per-picture QPs (traced data on the var path,
    so one compiled program set serves the whole ladder); the stream
    still decodes bit-exactly and lands in a sane range of the
    target (driver config #5 shape, VERDICT r4 item 7)."""
    from kvazaar_jax.api import Encoder
    from kvazaar_jax.bitstream.decoder import decode_stream
    from kvazaar_jax.config import Config

    rng = np.random.default_rng(3)
    w, h = 96, 64
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for i in range(9):
        y = np.clip(128 + 50 * np.sin((xx + 3 * i) / 11.0)
                    * np.cos(yy / 7.0) + rng.normal(0, 4, (h, w)),
                    0, 255).astype(np.uint8)
        cb = np.full((h // 2, w // 2), 108, np.uint8)
        cr = np.full((h // 2, w // 2), 145, np.uint8)
        frames.append((y, cb, cr))
    cfg = Config(width=w, height=h, qp=32, gop_len=8, intra_period=0,
                 bitrate=120_000, framerate_num=25)
    enc = Encoder(cfg)
    stream = b""
    res = []
    qps = []
    for f in frames:
        for (chunks, info, rec) in enc.encode(*f):
            stream += chunks
            res.append((info, rec))
            qps.append(info.qp)
    for (chunks, info, rec) in enc.flush():
        stream += chunks
        res.append((info, rec))
        qps.append(info.qp)
    assert len(res) == 9
    # RC actually varied QP across the pyramid (GOP allocation gives
    # higher layers smaller targets -> higher QP than the anchor).
    assert len(set(qps[1:])) > 1, qps
    dec = decode_stream(stream, enc._intra.params)
    assert len(dec) == 9
    for k, ((dy, dcb, dcr), _fd) in enumerate(dec):
        _info, rec = res[k]
        np.testing.assert_array_equal(dy[:h, :w], rec[0])
        np.testing.assert_array_equal(dcb[:h // 2, :w // 2], rec[1])
        np.testing.assert_array_equal(dcr[:h // 2, :w // 2], rec[2])
