"""Inter variable-CU quadtree e2e: P and B frames with mixed CU sizes
(8/16/32, optionally 64) must encode → decode bit-exact through the
oracle, and the chosen trees must actually mix sizes and inter/intra
CUs (reference capability: the inter half of search_cu,
/root/reference/src/search.c:424-757 + src/search_inter.c:1588)."""

import numpy as np
import pytest

from kvazaar_jax.api import Encoder
from kvazaar_jax.bitstream.decoder import decode_stream
from kvazaar_jax.config import Config

pytestmark = pytest.mark.smoke


def _clip(n, w, h, seed=5):
    """Shear motion with the boundary OFF the 32 grid (y = 24): CUs
    straddling it need different MVs per half, forcing size mixing and
    an inter/intra mix."""
    rng = np.random.default_rng(seed)
    tex = rng.integers(0, 255, (h + 64, w + 64)).astype(np.float64)
    b = 24
    yy, xx = np.mgrid[0:h // 2, 0:w // 2]
    out = []
    for i in range(n):
        y = np.zeros((h, w))
        y[:b] = tex[:b, 3 * i:3 * i + w]
        y[b:] = tex[b:h, 48 - 3 * i:48 - 3 * i + w]
        # Flat pulsing rectangle: inter prediction misses the DC jump,
        # intra prediction from same-frame neighbors nails it.
        y[40:56, 8:56] = 60 + 60 * (i % 3)
        y += rng.normal(0, 2, (h, w))
        y = np.clip(y, 0, 255).astype(np.uint8)
        cb = np.clip(110 + 20 * np.sin(xx / 7.0 + i * 0.3), 0,
                     255).astype(np.uint8)
        cr = np.clip(140 + 15 * np.cos(yy / 5.0), 0,
                     255).astype(np.uint8)
        out.append((y, cb, cr))
    return out


def _encode_all(enc, frames):
    res = []
    stream = b""
    for f in frames:
        for (chunks, info, rec) in enc.encode(*f):
            stream += chunks
            res.append((info, rec))
    for (chunks, info, rec) in enc.flush():
        stream += chunks
        res.append((info, rec))
    return stream, res


def _assert_decode_matches(stream, params, res, w, h):
    dec = decode_stream(stream, params)
    assert len(dec) == len(res)
    for k, ((dy, dcb, dcr), fd) in enumerate(dec):
        info, rec = res[k]
        np.testing.assert_array_equal(dy[:h, :w], rec[0],
                                      err_msg=f"frame {k} luma")
        np.testing.assert_array_equal(dcb[:h // 2, :w // 2], rec[1],
                                      err_msg=f"frame {k} cb")
        np.testing.assert_array_equal(dcr[:h // 2, :w // 2], rec[2],
                                      err_msg=f"frame {k} cr")
    return dec


def test_var_p_ippp_bit_exact():
    w, h = 96, 64
    frames = _clip(4, w, h)
    cfg = Config(width=w, height=h, qp=32, intra_min_cu=8,
                 intra_max_cu=32, intra_period=0, hash="md5")
    enc = Encoder(cfg)
    stream, res = _encode_all(enc, frames)
    dec = _assert_decode_matches(stream, enc._intra.params, res, w, h)
    # P frames must mix CU sizes and carry inter CUs.
    p_fds = [fd for (_r, fd) in dec[1:]]
    assert any(np.unique(fd.depth8).size > 1 for fd in p_fds), \
        "no P frame chose a mixed tree"
    assert any(fd.inter8.any() for fd in p_fds)
    assert any((fd.inter8 == 0).any() for fd in p_fds)


def test_var_p_merge_and_amvp_used():
    w, h = 96, 64
    frames = _clip(4, w, h, seed=11)
    cfg = Config(width=w, height=h, qp=30, intra_min_cu=8,
                 intra_max_cu=32, intra_period=0)
    enc = Encoder(cfg)
    stream, res = _encode_all(enc, frames)
    dec = _assert_decode_matches(stream, enc._intra.params, res, w, h)
    merged = mvds = 0
    for (_r, fd) in dec[1:]:
        inter = fd.inter8.astype(bool)
        merged += int((inter & (fd.merge8 >= 0)).sum())
        mvds += int((inter & (fd.merge8 < 0)).sum())
    assert merged > 0, "no merge CUs signalled"
    assert mvds > 0, "no AMVP CUs signalled"


def test_var_b_gop4_bit_exact():
    w, h = 96, 64
    frames = _clip(5, w, h, seed=7)
    cfg = Config(width=w, height=h, qp=32, intra_min_cu=8,
                 intra_max_cu=32, gop_len=4, intra_period=0,
                 hash="md5")
    enc = Encoder(cfg)
    stream, res = _encode_all(enc, frames)
    pocs = [i.poc for i, _ in res]
    assert pocs == [0, 4, 2, 1, 3]
    dec = _assert_decode_matches(stream, enc._intra.params, res, w, h)
    b_fds = [fd for (_r, fd) in dec if fd.inter8.any()
             and fd.dir8 is not None]
    assert any(np.unique(fd.depth8).size > 1 for fd in b_fds), \
        "no inter frame chose a mixed tree"


def test_var_p_with_64_cus():
    """slower-preset shape: 8..64 trees on a frame with flat regions
    big enough for 64x64 CUs."""
    w, h = 128, 128
    frames = _clip(3, w, h, seed=13)
    cfg = Config(width=w, height=h, qp=34, intra_min_cu=8,
                 intra_max_cu=64, intra_period=0)
    enc = Encoder(cfg)
    stream, res = _encode_all(enc, frames)
    dec = _assert_decode_matches(stream, enc._intra.params, res, w, h)
    assert any((fd.depth8 == 0).any() for (_r, fd) in dec), \
        "no 64x64 CU chosen anywhere"


def test_var_p_sao_rdoq():
    """Tool composition on the var inter path: SAO + RDOQ + signhide."""
    w, h = 96, 64
    frames = _clip(3, w, h, seed=17)
    cfg = Config(width=w, height=h, qp=32, intra_min_cu=8,
                 intra_max_cu=32, intra_period=0, sao=True, rdoq=True,
                 signhide=True)
    enc = Encoder(cfg)
    stream, res = _encode_all(enc, frames)
    _assert_decode_matches(stream, enc._intra.params, res, w, h)

