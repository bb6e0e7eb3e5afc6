"""--tr-depth-intra 1: explicit one-level intra TU splits
(split_transform_flag, H.265 7.3.8.8) through search, reconstruction,
serialization and the oracle decoder (reference capability:
search_intra_trdepth /root/reference/src/search_intra.c:189 +
kvz_encode_transform_coeff src/encode_coding_tree.c:461-472)."""

import numpy as np
import pytest

from kvazaar_jax.api import Encoder
from kvazaar_jax.bitstream.decoder import decode_stream
from kvazaar_jax.config import Config

pytestmark = pytest.mark.smoke


def _clip(n, w, h, seed=9):
    """Mixed content: large smooth gradients (favor big CUs) with one
    sharp sub-quadrant texture patch per 32 block (favors keeping the
    32 CU's single mode but splitting its TBs)."""
    rng = np.random.default_rng(seed)
    out = []
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n):
        y = 40 + (xx + yy + 4 * i) / (w + h) * 150
        for by in range(0, h - 31, 32):
            for bx in range(0, w - 31, 32):
                if (bx // 32 + by // 32) % 2 == 0:
                    y[by + 16:by + 32, bx:bx + 16] += rng.integers(
                        -70, 70, (16, 16))
        y = np.clip(y, 0, 255).astype(np.uint8)
        cb = np.full((h // 2, w // 2), 120, np.uint8)
        cr = np.clip(128 + (xx[::2, ::2] // 4), 0, 255).astype(np.uint8)
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


def test_tr_split_chosen_and_bit_exact():
    w, h = 128, 64
    frames = _clip(2, w, h)
    cfg = Config(width=w, height=h, qp=27, intra_min_cu=8,
                 intra_max_cu=32, intra_period=1, rd=2,
                 tr_depth_intra=1, hash="md5")
    enc = Encoder(cfg)
    stream, res = _encode_all(enc, frames)
    # Decode bit-exactness proves the whole chain; the parsed split
    # maps prove the search actually chose TU splits.
    dec = _assert_decode_matches(stream, enc._intra.params, res, w, h)
    split_cells = sum(int(fd.trsplit8.sum()) for _planes, fd in dec)
    assert split_cells > 0, "no TU splits chosen on split-bait content"


def test_tr_split_rd_not_worse():
    w, h = 128, 64
    frames = _clip(1, w, h)
    outs = {}
    for td in (0, 1):
        cfg = Config(width=w, height=h, qp=27, intra_min_cu=8,
                     intra_max_cu=32, intra_period=1, rd=2,
                     tr_depth_intra=td, hash="none")
        enc = Encoder(cfg)
        stream, res = _encode_all(enc, frames)
        rec = res[0][1]
        err = (rec[0].astype(np.int64)
               - frames[0][0].astype(np.int64))
        outs[td] = (len(stream) * 8, float((err * err).sum()))
    from kvazaar_jax.encoder.frame_encoder import qp_to_lambda
    lam = qp_to_lambda(27)
    rd0 = outs[0][1] + lam * outs[0][0]
    rd1 = outs[1][1] + lam * outs[1][0]
    assert rd1 <= rd0 * 1.005, (outs, rd0, rd1)


def test_tr_split_flag_coded_in_p_stream():
    """P/B streams under max_tr_depth_intra=1 code the (zero) flag on
    every intra 2Nx2N CU — decode must stay bit-exact."""
    w, h = 96, 64
    rng = np.random.default_rng(3)
    base = rng.integers(0, 255, (h + 16, w + 16)).astype(np.uint8)
    frames = []
    for i in range(3):
        y = base[i:i + h, 2 * i:2 * i + w]
        cb = np.full((h // 2, w // 2), 100, np.uint8)
        cr = np.full((h // 2, w // 2), 150, np.uint8)
        frames.append((y, cb, cr))
    cfg = Config(width=w, height=h, qp=30, intra_min_cu=8,
                 intra_max_cu=32, intra_period=0, rd=2,
                 tr_depth_intra=1, hash="md5")
    enc = Encoder(cfg)
    stream, res = _encode_all(enc, frames)
    _assert_decode_matches(stream, enc._intra.params, res, w, h)


def test_tr_split_rejected_combos():
    import pytest as _pt
    with _pt.raises(ValueError):
        Config(width=64, height=64, qp=30, intra_min_cu=32,
               intra_max_cu=32, tr_depth_intra=1).validate()
    with _pt.raises(ValueError):
        Config(width=64, height=64, qp=30, intra_min_cu=8,
               intra_max_cu=32, tr_depth_intra=2).validate()
