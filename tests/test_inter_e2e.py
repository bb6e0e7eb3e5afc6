"""End-to-end low-delay P conformance gate: IPPP encode of a moving
scene; every frame's encoder reconstruction must EXACTLY match the
oracle decoder's reconstruction of the emitted bitstream (which
re-derives MVs sequentially from candidates + parsed mvd/merge syntax
and runs an independent MC + recon path)."""

import numpy as np
import pytest

from kvazaar_jax.bitstream.decoder import decode_stream
from kvazaar_jax.config import Config
from kvazaar_jax.encoder.frame_encoder import IntraFrameEncoder, psnr

pytestmark = pytest.mark.heavy


def moving_clip(rng, w, h, n):
    """Textured background translating by (2, 1) px/frame + noise."""
    bw, bh = w + 8 * n, h + 8 * n
    yy, xx = np.mgrid[0:bh, 0:bw]
    base = (128 + 50 * np.sin(xx / 7.0) * np.cos(yy / 11.0)
            + 20 * np.sin((xx + yy) / 23.0))
    frames = []
    for i in range(n):
        ox, oy = 2 * i, i
        y = np.clip(base[oy:oy + h, ox:ox + w]
                    + rng.normal(0, 2, (h, w)), 0, 255).astype(np.uint8)
        cb = np.clip(110 + 30 * np.sin(xx[oy:oy + h:2, ox:ox + w:2]
                                       / 17.0), 0, 255).astype(np.uint8)
        cr = np.clip(140 + 25 * np.cos(yy[oy:oy + h:2, ox:ox + w:2]
                                       / 13.0), 0, 255).astype(np.uint8)
        frames.append((y, cb, cr))
    return frames


@pytest.mark.parametrize("w,h,cu,qp,me", [
    (64, 64, 16, 27, 8),
    (96, 64, 16, 32, 8),
])
def test_ippp_encode_decode_bit_exact(w, h, cu, qp, me):
    rng = np.random.default_rng(3)
    frames = moving_clip(rng, w, h, 3)
    cfg = Config(width=w, height=h, qp=qp, intra_max_cu=cu,
                 intra_min_cu=cu, me_range=me, intra_period=0)
    enc = IntraFrameEncoder(cfg)
    stream = enc.headers()
    results = []
    res = enc.encode_frame(*frames[0])
    stream += res.nals
    results.append(res)
    for i, f in enumerate(frames[1:], start=1):
        res = enc.encode_p_frame(*f, poc=i, ref_poc=i - 1)
        stream += res.nals
        results.append(res)

    decoded = decode_stream(stream, enc.params)
    assert len(decoded) == len(frames)
    for i, ((rec_y, rec_cb, rec_cr), fd) in enumerate(decoded):
        np.testing.assert_array_equal(rec_y, results[i].recon_y,
                                      err_msg=f"frame {i} luma")
        np.testing.assert_array_equal(rec_cb, results[i].recon_cb,
                                      err_msg=f"frame {i} cb")
        np.testing.assert_array_equal(rec_cr, results[i].recon_cr,
                                      err_msg=f"frame {i} cr")

    # P-frames of a translating scene must be much cheaper than the IDR
    # and still look like the source.
    assert results[1].bits < results[0].bits * 0.8
    p = psnr(results[1].recon_y, frames[1][0].astype(np.int32))
    assert p > 28.0, p


def test_p_frame_static_scene_mostly_skip():
    rng = np.random.default_rng(1)
    y = np.clip(128 + 40 * np.sin(np.arange(64) / 5.0)[None]
                * np.cos(np.arange(64) / 7.0)[:, None], 0,
                255).astype(np.uint8)
    cb = np.full((32, 32), 100, np.uint8)
    cr = np.full((32, 32), 150, np.uint8)
    cfg = Config(width=64, height=64, qp=27, intra_max_cu=16,
                 intra_min_cu=16, me_range=8, intra_period=0)
    enc = IntraFrameEncoder(cfg)
    enc.encode_frame(y, cb, cr)
    res = enc.encode_p_frame(y, cb, cr, poc=1, ref_poc=0)
    # Identical frame: essentially everything should be skip, and the
    # frame should be tiny.
    assert res.frame_data.skip8.mean() > 0.8
    assert len(res.nals) < 60
