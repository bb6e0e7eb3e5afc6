"""SMP inter partitions (PART_2NxN / PART_Nx2N): quadrant-aggregated
ME + partition decision, per-PU merge/AMVP with the 6.4.2 availability
rules, PU-boundary deblocking — reference kvz_search_cu_smp
(src/search_inter.c:1627), tests/test_smp.sh."""

import numpy as np
import pytest

from kvazaar_jax.api import Encoder
from kvazaar_jax.bitstream.decoder import decode_stream
from kvazaar_jax.config import Config
from kvazaar_jax.encoder.frame_encoder import IntraFrameEncoder

pytestmark = pytest.mark.heavy


def _clip(n, w, h, seed=13, split="h"):
    """Half-plane motion: one half static, the other shifts — the SMP
    sweet spot."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        if split == "h":
            shift = (i * 6) * (yy > h // 2)
        else:
            shift = (i * 6) * (xx > w // 2)
        y = np.clip(100 + 60 * ((xx + shift) % 32 < 16)
                    + rng.normal(0, 3, (h, w)), 0, 255).astype(np.uint8)
        cb = np.full((h // 2, w // 2), 110, np.uint8)
        cr = np.clip(130 + 15 * np.cos(yy[::2, ::2] / 9.0), 0,
                     255).astype(np.uint8)
        out.append((y, cb, cr))
    return out


@pytest.mark.parametrize("split", ["h", "v"])
def test_smp_e2e_bit_exact(split):
    w = h = 128
    cfg = Config(width=w, height=h, qp=30, intra_period=0,
                 intra_min_cu=16, intra_max_cu=16, smp=True).validate()
    enc = IntraFrameEncoder(cfg)
    clip = _clip(3, w, h, split=split)
    res = [enc.encode_frame(*clip[0])]
    for i in (1, 2):
        res.append(enc.encode_p_frame(*clip[i], poc=i, ref_poc=i - 1))
    n_smp = sum(int((r.frame_data.part8 > 0).sum()) for r in res[1:])
    assert n_smp > 0, "motion split content should pick SMP"
    stream = enc.headers() + b"".join(r.nals for r in res)
    frames = decode_stream(stream, enc.params)
    for i, (r, ((ry, rcb, rcr), _fd)) in enumerate(zip(res, frames)):
        np.testing.assert_array_equal(ry, r.recon_y, err_msg=f"f{i}")
        np.testing.assert_array_equal(rcb, r.recon_cb)
        np.testing.assert_array_equal(rcr, r.recon_cr)


def test_smp_cu32_e2e():
    w, h = 128, 64
    cfg = Config(width=w, height=h, qp=32, intra_period=0,
                 intra_min_cu=32, intra_max_cu=32, smp=True).validate()
    enc = IntraFrameEncoder(cfg)
    clip = _clip(2, w, h, seed=5)
    r0 = enc.encode_frame(*clip[0])
    r1 = enc.encode_p_frame(*clip[1], poc=1, ref_poc=0)
    frames = decode_stream(enc.headers() + r0.nals + r1.nals,
                           enc.params)
    np.testing.assert_array_equal(frames[1][0][0], r1.recon_y)


def test_smp_api_stream():
    """Through the public API + hash SEI verification."""
    w = h = 128
    cfg = Config(width=w, height=h, qp=30, intra_period=0,
                 intra_min_cu=16, intra_max_cu=16, smp=True,
                 hash="md5").validate()
    enc = Encoder(cfg)
    stream = b""
    for f in _clip(3, w, h):
        for chunks, _info, _rec in enc.encode(*f):
            stream += chunks
    frames = decode_stream(stream, enc._intra.params)
    assert len(frames) == 3      # MD5 SEIs verified inside decode


def test_smp_validation():
    with pytest.raises(ValueError):
        Config(width=64, height=64, qp=30, smp=True, ref_frames=2,
               intra_period=0).validate()
    with pytest.raises(ValueError):
        Config(width=64, height=64, qp=30, smp=True, gop_len=8,
               intra_period=0).validate()
    with pytest.raises(ValueError):
        Config(width=64, height=64, qp=30, smp=True, intra_min_cu=8,
               intra_max_cu=32).validate()


def _band_clip(n, w, h, seed=17):
    """Only the bottom quarter rows of each 32-band move — AMP's
    sweet spot (2NxnD splits)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        band = (yy % 32) >= 24
        y = np.clip(100 + 60 * ((xx + (i * 7) * band) % 24 < 12)
                    + rng.normal(0, 3, (h, w)), 0, 255).astype(np.uint8)
        cb = np.full((h // 2, w // 2), 110, np.uint8)
        cr = np.clip(130 + 15 * np.cos(yy[::2, ::2] / 9.0), 0,
                     255).astype(np.uint8)
        out.append((y, cb, cr))
    return out


def test_amp_e2e_bit_exact():
    w = h = 128
    cfg = Config(width=w, height=h, qp=30, intra_period=0,
                 intra_min_cu=32, intra_max_cu=32, smp=True,
                 amp=True).validate()
    enc = IntraFrameEncoder(cfg)
    clip = _band_clip(3, w, h)
    res = [enc.encode_frame(*clip[0])]
    for i in (1, 2):
        res.append(enc.encode_p_frame(*clip[i], poc=i, ref_poc=i - 1))
    parts = np.concatenate([r.frame_data.part8.ravel()
                            for r in res[1:]])
    assert (parts >= 4).any(), "band motion should pick AMP splits"
    stream = enc.headers() + b"".join(r.nals for r in res)
    frames = decode_stream(stream, enc.params)
    for i, (r, ((ry, rcb, rcr), _fd)) in enumerate(zip(res, frames)):
        np.testing.assert_array_equal(ry, r.recon_y, err_msg=f"f{i}")
        np.testing.assert_array_equal(rcb, r.recon_cb)
        np.testing.assert_array_equal(rcr, r.recon_cr)


def test_amp_validation():
    with pytest.raises(ValueError):
        Config(width=64, height=64, qp=30, amp=True,
               intra_period=0).validate()      # needs smp
    with pytest.raises(ValueError):
        Config(width=64, height=64, qp=30, smp=True, amp=True,
               intra_min_cu=16, intra_max_cu=16,
               intra_period=0).validate()      # needs CU 32
