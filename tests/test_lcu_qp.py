"""LCU-level rate control machinery: per-CTU QP through quant ops,
wavefront recon, deblock, cu_qp_delta syntax, and the API (RC / ROI /
AQ).  Conformance gate: encoder recon must equal the oracle decoder's
reconstruction of the emitted bitstream."""

import dataclasses as dc

import jax.numpy as jnp
import numpy as np
import pytest

from kvazaar_jax.bitstream.bits import BitReader, BitWriter
from kvazaar_jax.bitstream.cabac import CabacDecoder, CabacEncoder
from kvazaar_jax.bitstream.contexts import Contexts
from kvazaar_jax.bitstream.decoder import decode_stream
from kvazaar_jax.bitstream.headers import StreamParams
from kvazaar_jax.bitstream.syntax import (FrameData, SliceDataDecoder,
                                          SliceDataEncoder)
from kvazaar_jax.config import Config
from kvazaar_jax.constants import SLICE_I

pytestmark = pytest.mark.heavy


def test_quant_ops_array_qp_match_scalar():
    from kvazaar_jax.ops.quant import (dequantize, quantize,
                                       quantize_rdoq)
    rng = np.random.default_rng(0)
    n = 10
    coeff = rng.integers(-3000, 3000, (n, 16, 16)).astype(np.int32)
    qps = rng.integers(10, 45, (n,)).astype(np.int32)
    arr = np.asarray(quantize(jnp.asarray(coeff), jnp.asarray(qps), 16,
                              8, intra=True))
    ref = np.stack([np.asarray(quantize(jnp.asarray(coeff[i]),
                                        int(qps[i]), 16, 8, intra=True))
                    for i in range(n)])
    np.testing.assert_array_equal(arr, ref)
    lv = jnp.asarray(ref)
    arr = np.asarray(dequantize(lv, jnp.asarray(qps), 16, 8))
    ref2 = np.stack([np.asarray(dequantize(lv[i], int(qps[i]), 16, 8))
                     for i in range(n)])
    np.testing.assert_array_equal(arr, ref2)
    arr = np.asarray(quantize_rdoq(jnp.asarray(coeff),
                                   jnp.asarray(qps), 16, 8,
                                   intra=True, lam=3.0))
    ref3 = np.stack([np.asarray(quantize_rdoq(jnp.asarray(coeff[i]),
                                              int(qps[i]), 16, 8,
                                              intra=True, lam=3.0))
                     for i in range(n)])
    np.testing.assert_array_equal(arr, ref3)


def test_deblock_qp_map_uniform_equals_scalar():
    from kvazaar_jax.ops.deblock import deblock_frame
    h = w = 64
    s = 16
    yy, xx = np.mgrid[0:h, 0:w]
    y = (120 + 8 * ((xx // s + yy // s) % 2)).astype(np.int32)
    cb = y[::2, ::2] // 2 + 60
    cr = cb + 5
    base = deblock_frame(jnp.asarray(y), jnp.asarray(cb),
                         jnp.asarray(cr), 32, s)
    qm = jnp.full((h // s, w // s), 32, jnp.int32)
    unif = deblock_frame(jnp.asarray(y), jnp.asarray(cb),
                         jnp.asarray(cr), 32, s, qp_map=qm)
    for a, b in zip(base, unif):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    qm2 = np.full((h // s, w // s), 32, np.int32)
    qm2[::2] = 45
    var = deblock_frame(jnp.asarray(y), jnp.asarray(cb),
                        jnp.asarray(cr), 32, s,
                        qp_map=jnp.asarray(qm2))
    assert not np.array_equal(np.asarray(var[0]), np.asarray(base[0]))


@pytest.mark.parametrize("wpp", [False, True])
def test_dqp_syntax_roundtrip(wpp):
    """cu_qp_delta serializer/parser roundtrip, including CTUs without
    coded coefficients (effective-QP predictor chain)."""
    import sys
    sys.path.insert(0, "tests")
    from test_syntax import random_frame_data
    rng = np.random.default_rng(9)
    W, H = 192, 128
    params = StreamParams(width=W, height=H, qp=30,
                          chroma_format_idc=1, cu_qp_delta=True,
                          wpp=wpp)
    fd = random_frame_data(rng, W, H, True)
    # Zero out one CTU entirely: its delta cannot be coded.
    fd.coeff_y[64:128, 64:128] = 0
    fd.coeff_cb[32:64, 32:64] = 0
    fd.coeff_cr[32:64, 32:64] = 0
    cy, cx = -(-H // 64), -(-W // 64)
    fd.qp_ctu = (30 + rng.integers(-6, 7, (cy, cx))).astype(np.int32)
    intended = fd.qp_ctu.copy()
    w = BitWriter()
    enc = SliceDataEncoder(params, fd, Contexts(SLICE_I, 30),
                           CabacEncoder(w))
    sizes = enc.encode_slice_data_wpp() if wpp \
        else enc.encode_slice_data()
    if not wpp:
        w.align_zero()
    data = w.get_bytes()
    out = FrameData.empty(W, H, True)
    out.qp_ctu = np.full((cy, cx), 30, np.int32)
    dec = SliceDataDecoder(params, out, Contexts(SLICE_I, 30),
                           CabacDecoder(BitReader(data)))
    if wpp:
        dec.decode_slice_data_wpp(data, 0, sizes)
    else:
        dec.decode_slice_data()
    np.testing.assert_array_equal(out.coeff_y, fd.coeff_y)
    # Serializer normalizes fd.qp_ctu to effective; parser must agree.
    np.testing.assert_array_equal(out.qp_ctu, fd.qp_ctu)
    # The zeroed CTU (1, 1) must carry a chain value, not its intended.
    assert fd.qp_ctu[1, 1] != intended[1, 1] or \
        fd.qp_ctu[1, 1] == (30 if wpp and cx < 2 else fd.qp_ctu[1, 0])


def _synth(rng, w, h, i=0):
    yy, xx = np.mgrid[0:h, 0:w]
    y = np.clip(128 + 50 * np.sin(xx / 7.0 + i * 0.8)
                * np.cos(yy / 11.0) + rng.normal(0, 5, (h, w)),
                0, 255).astype(np.uint8)
    cb = np.clip(110 + 20 * np.sin(xx[::2, ::2] / 13.0), 0,
                 255).astype(np.uint8)
    cr = np.clip(130 + 20 * np.cos(yy[::2, ::2] / 9.0 + i), 0,
                 255).astype(np.uint8)
    return y, cb, cr


def test_dqp_i_p_e2e_bit_exact():
    from kvazaar_jax.encoder.frame_encoder import IntraFrameEncoder
    rng = np.random.default_rng(11)
    w = h = 128
    cfg = Config(width=w, height=h, qp=30, bitrate=400000,
                 lcu_rc=True).validate()
    enc = IntraFrameEncoder(cfg)
    assert enc.params.cu_qp_delta
    qmap = (30 + rng.integers(-4, 5, (2, 2))).astype(np.int32)
    res_i = enc.encode_frame(*_synth(rng, w, h, 0), qp_ctu=qmap)
    qmap2 = (30 + rng.integers(-4, 5, (2, 2))).astype(np.int32)
    res_p = enc.encode_p_frame(*_synth(rng, w, h, 1), poc=1,
                               ref_poc=0, qp_ctu=qmap2)
    frames = decode_stream(enc.headers() + res_i.nals + res_p.nals,
                           enc.params)
    assert len(frames) == 2
    for res, ((ry, rcb, rcr), fd) in zip((res_i, res_p), frames):
        np.testing.assert_array_equal(ry, res.recon_y)
        np.testing.assert_array_equal(rcb, res.recon_cb)
        np.testing.assert_array_equal(rcr, res.recon_cr)
    np.testing.assert_array_equal(frames[0][1].qp_ctu, qmap)
    np.testing.assert_array_equal(frames[1][1].qp_ctu, qmap2)


def test_lcu_rc_api_stream():
    """--bitrate with LCU allocation: streams decode, per-CTU weights
    feed back, and the bitrate lands in a sane band."""
    from kvazaar_jax.api import Encoder
    rng = np.random.default_rng(3)
    w = h = 128
    n = 6
    fps = 25.0
    target = 600_000
    cfg = Config(width=w, height=h, qp=30, bitrate=target,
                 intra_period=0).validate()
    assert cfg.cu_qp_delta_active
    enc = Encoder(cfg)
    out = b""
    total_bits = 0
    for i in range(n):
        for chunks, info, _rec in enc.encode(*_synth(rng, w, h, i)):
            out += chunks
            total_bits += info.bits
    assert enc._rc_wts, "no per-CTU weights fed back"
    frames = decode_stream(out, enc._intra.params)
    assert len(frames) == n
    # Loose band: short clip + adaptation transient.
    bps = total_bits * fps / n
    assert 0.2 * target < bps < 5 * target


def test_roi_and_aq_e2e(tmp_path):
    from kvazaar_jax.api import Encoder
    rng = np.random.default_rng(5)
    w = h = 128
    roi = tmp_path / "roi.txt"
    roi.write_text("2 2\n-4 3 0 2\n")
    cfg = Config(width=w, height=h, qp=32, roi=str(roi),
                 aq=1.0).validate()
    assert cfg.cu_qp_delta_active
    enc = Encoder(cfg)
    out = b""
    srcs = [_synth(rng, w, h, i) for i in range(2)]
    recs = []
    for f in srcs:
        for chunks, info, rec in enc.encode(*f):
            out += chunks
            recs.append(rec)
    frames = decode_stream(out, enc._intra.params)
    assert len(frames) == 2
    for (ry, rcb, rcr), rec in zip([f[0] for f in frames], recs):
        np.testing.assert_array_equal(ry[:h, :w], rec[0])
    # ROI offsets visible in the decoded per-CTU QP (CTU 0 lower).
    q = frames[0][1].qp_ctu
    assert q[0, 0] < q[0, 1]


def test_config_dqp_combos():
    base = dict(width=128, height=128, qp=30)
    # Explicit ROI/AQ requests on unsupported structures are rejected.
    with pytest.raises(ValueError):
        Config(**base, roi="x", gop_len=8, intra_period=0).validate()
    with pytest.raises(ValueError):
        Config(**base, aq=1.0, ref_frames=2, intra_period=0).validate()
    with pytest.raises(ValueError):
        Config(**base, aq=1.0, lossless=True).validate()
    # LCU RC degrades to frame-level RC on those structures instead
    # (driver config #5: B pyramid + --bitrate must work).
    cfg = Config(**base, bitrate=100000, gop_len=8,
                 intra_period=0).validate()
    assert not cfg.cu_qp_delta_active
    cfg = Config(**base, bitrate=100000, ref_frames=2,
                 intra_period=0).validate()
    assert not cfg.cu_qp_delta_active
    cfg = Config(**base, bitrate=100000, intra_period=0).validate()
    assert cfg.cu_qp_delta_active


def test_gop_bitrate_frame_rc():
    """B-pyramid + --bitrate: frame-level R-lambda drives per-frame QP
    and the stream still decodes bit-exact (driver config #5 shape)."""
    from kvazaar_jax.api import Encoder
    rng = np.random.default_rng(7)
    w = h = 128
    cfg = Config(width=w, height=h, qp=30, bitrate=500000,
                 gop_len=4, intra_period=0).validate()
    enc = Encoder(cfg)
    out = b""
    results = []
    for i in range(5):
        results += enc.encode(*_synth(rng, w, h, i))
    results += enc.flush()
    qps = set()
    for chunks, info, _rec in results:
        out += chunks
        qps.add(info.qp)
    frames = decode_stream(out, enc._intra.params)
    assert len(frames) == 5
    assert enc._rc.s.frames_coded == 5
