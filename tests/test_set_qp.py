"""Encoder reuse across base QPs (set_base_qp + reset_stream).

QP/lambda ride the variable-tree device programs as traced data, so
one encoder instance must produce byte-identical streams to a fresh
instance at each QP of a ladder (the BD-rate bench and any production
QP switch depend on this).  Reference behavior: a fresh
kvz_encoder_open per operating point (src/encoder.c) — recast here
as runtime re-pointing because program compilation is the expensive
resource on the accelerator.
"""

import numpy as np
import pytest

from kvazaar_jax.api import Encoder
from kvazaar_jax.config import config_from_preset

pytestmark = pytest.mark.smoke


def _clip(n, w, h, seed=7):
    r = np.random.RandomState(seed)
    base = r.randint(0, 255, (h, w)).astype(np.uint8)
    out = []
    for i in range(n):
        y = np.roll(base, i * 2, axis=1)
        cb = (base[::2, ::2] // 2 + 40 + i).astype(np.uint8)
        cr = (base[::2, ::2] // 3 + 60).astype(np.uint8)
        out.append((y, cb, cr))
    return out


def _encode_all(enc, frames):
    stream = b""
    for y, cb, cr in frames:
        for data, _info, _rec in enc.encode(y, cb, cr):
            stream += data
    for data, _info, _rec in enc.flush():
        stream += data
    return stream


def _fresh_stream(qp, frames, w, h, **over):
    cfg = config_from_preset("medium", width=w, height=h, qp=qp,
                             **over)
    return _encode_all(Encoder(cfg), cfg.validate() and frames)


@pytest.mark.parametrize("mode", ["intra", "gop8"])
def test_qp_ladder_bit_identical(mode):
    w, h = 96, 64
    over = (dict(intra_period=1) if mode == "intra"
            else dict(intra_period=0, gop_len=8))
    frames = _clip(9 if mode == "gop8" else 3, w, h)
    qps = (27, 37)
    fresh = {qp: _fresh_stream(qp, frames, w, h, **over)
             for qp in qps}
    cfg = config_from_preset("medium", width=w, height=h, qp=qps[0],
                             **over)
    enc = Encoder(cfg)
    got = {qps[0]: _encode_all(enc, frames)}
    enc.set_base_qp(qps[1])
    enc.reset_stream()
    got[qps[1]] = _encode_all(enc, frames)
    for qp in qps:
        assert got[qp] == fresh[qp], f"qp {qp}: stream differs"
    assert fresh[qps[0]] != fresh[qps[1]]


def test_ippp_reset_stream():
    w, h = 96, 64
    frames = _clip(4, w, h)
    over = dict(intra_period=0, gop_len=1, ref_frames=1)
    fresh = _fresh_stream(32, frames, w, h, **over)
    cfg = config_from_preset("medium", width=w, height=h, qp=22,
                             **over)
    enc = Encoder(cfg)
    _encode_all(enc, frames)
    enc.set_base_qp(32)
    enc.reset_stream()
    assert _encode_all(enc, frames) == fresh
