"""Intra NxN / 4x4 TU operating point: 8x8 CUs coded PART_NxN with
four 4x4 PUs (per-PU modes + MPMs), forced 4x4 TU split, DST-VII luma
transform, chroma as one 4x4 TB per CU riding the last child TU.

Reference behavior: NxN intra search (src/search_intra.c:189), intra CU
serialization (src/encode_coding_tree.c:683), DST dispatch
(src/transform.c:189).
"""

import numpy as np
import pytest

from kvazaar_jax.api import Encoder
from kvazaar_jax.bitstream.decoder import decode_stream
from kvazaar_jax.config import Config

pytestmark = pytest.mark.smoke


def _clip(n, w, h, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    base = rng.integers(0, 200, (h, w)).astype(np.float32)
    for i in range(n):
        out.append((
            np.clip(base + rng.normal(0, 12, (h, w)) + 8 * i, 0, 255)
            .astype(np.uint8),
            rng.integers(90, 160, (h // 2, w // 2)).astype(np.uint8),
            rng.integers(90, 160, (h // 2, w // 2)).astype(np.uint8)))
    return out


def _roundtrip(cfg, frames):
    enc = Encoder(cfg)
    stream = b""
    recs = []
    for c, info, rec in enc.encode_stream(iter(frames),
                                          need_recon=True):
        stream += c
        recs.append(rec)
    dec = decode_stream(stream, enc._intra.params)
    assert len(dec) == len(frames)
    h, w = cfg.height, cfg.width
    for i, ((ry, rcb, rcr), fdd) in enumerate(dec):
        assert np.array_equal(ry[:h, :w], recs[i][0]), f"frame {i} y"
        if rcb is not None:
            assert np.array_equal(rcb[:h // 2, :w // 2], recs[i][1]), i
            assert np.array_equal(rcr[:h // 2, :w // 2], recs[i][2]), i
    return stream, dec


def test_dst4_matches_numpy_spec():
    """Forward+inverse DST-VII against an int64 transcription of
    8.6.4.1 (the 4x4 DST matrix applied with the standard shifts)."""
    import jax.numpy as jnp

    from kvazaar_jax.ops.transform import (dst4_matrix_np,
                                           forward_transform,
                                           inverse_transform)
    rng = np.random.default_rng(0)
    resid = rng.integers(-255, 256, (13, 4, 4)).astype(np.int64)
    t = dst4_matrix_np().astype(np.int64)
    e = (t @ resid + 1) >> 1                     # shift1 = 2+8-9 = 1
    c = (e @ t.T + 128) >> 8                     # shift2 = 2+6 = 8
    got = np.asarray(forward_transform(jnp.asarray(resid, jnp.int32),
                                       4, 8, dst=True))
    assert np.array_equal(got, c)
    ei = np.clip((t.T @ c + 64) >> 7, -32768, 32767)
    ri = np.clip((ei @ t + (1 << 11)) >> 12, -32768, 32767)
    goti = np.asarray(inverse_transform(jnp.asarray(c, jnp.int32), 4,
                                        8, dst=True))
    assert np.array_equal(goti, ri)


@pytest.mark.parametrize("wpp,signhide", [(False, False), (True, True)])
def test_intra4_bit_exact(wpp, signhide):
    cfg = Config(width=64, height=64, qp=30, intra_period=1,
                 intra_max_cu=4, intra_min_cu=4, wpp=wpp,
                 signhide=signhide, hash="md5")
    stream, dec = _roundtrip(cfg, _clip(2, 64, 64))
    assert dec[0][1].nxn8.all(), "every CU must be PART_NxN"


def test_intra4_mono_10bit():
    cfg = Config(width=32, height=32, qp=28, intra_period=1,
                 intra_max_cu=4, intra_min_cu=4, wpp=False,
                 chroma_format=400, input_bitdepth=10, hash="md5")
    rng = np.random.default_rng(9)
    frames = [(rng.integers(0, 1023, (32, 32)).astype(np.uint16),
               None, None)]
    enc = Encoder(cfg)
    stream = b""
    recs = []
    for c, info, rec in enc.encode_stream(iter(frames),
                                          need_recon=True):
        stream += c
        recs.append(rec)
    dec = decode_stream(stream, enc._intra.params)
    assert np.array_equal(dec[0][0][0], recs[0][0])


def test_transform_skip_bit_exact():
    """TS flags coded per 4x4 TB (7.3.8.11); try-both encoder decision;
    oracle reconstructs TS blocks via the 8.6.4.2 shift path."""
    cfg = Config(width=64, height=64, qp=32, intra_period=1,
                 intra_max_cu=4, intra_min_cu=4, wpp=False,
                 transform_skip=True, hash="md5")
    # Piecewise-flat content with sharp steps: the place TS wins.
    rng = np.random.default_rng(3)
    y = np.kron(rng.integers(0, 255, (8, 8)),
                np.ones((8, 8))).astype(np.uint8)
    y[::3, :] = 255 - y[::3, :]
    frames = [(y, np.full((32, 32), 120, np.uint8),
               np.full((32, 32), 130, np.uint8))]
    stream, dec = _roundtrip(cfg, frames)
    assert dec[0][1].tskip4.any(), \
        "encoder should pick TS somewhere on step content"


def test_transform_skip_rejected_without_4x4():
    with pytest.raises(ValueError):
        Config(width=64, height=64, transform_skip=True,
               intra_max_cu=16, intra_min_cu=16).validate()


def test_intra4_beats_cu8_on_detail():
    """At equal QP the 4x4 point must reconstruct detailed content with
    lower distortion than 8x8 CUs (the point of finer prediction)."""
    frames = _clip(1, 64, 64, seed=11)
    cfg4 = Config(width=64, height=64, qp=30, intra_period=1,
                  intra_max_cu=4, intra_min_cu=4, wpp=False)
    cfg8 = Config(width=64, height=64, qp=30, intra_period=1,
                  intra_max_cu=8, intra_min_cu=8, wpp=False)
    sse = {}
    for name, cfg in (("cu4", cfg4), ("cu8", cfg8)):
        enc = Encoder(cfg)
        for _c, info, rec in enc.encode_stream(iter(frames),
                                               need_recon=True):
            sse[name] = float(
                np.sum((rec[0].astype(np.float64)
                        - frames[0][0].astype(np.float64)) ** 2))
    assert sse["cu4"] < sse["cu8"]
