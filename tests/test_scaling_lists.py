"""Scaling lists (quantization matrices): default and custom (cqmfile)
lists through quant/dequant, SPS signalling, and the oracle decoder —
e2e bit-exact and actually changing the coded bits.

Reference capability: src/scalinglist.c (defaults, cqmfile parse,
table generation), kvz_dequant scaling branch
(src/strategies/generic/quant-generic.c:290)."""

import numpy as np
import pytest

from kvazaar_jax.api import Encoder
from kvazaar_jax.bitstream.decoder import decode_stream
from kvazaar_jax.config import Config
from kvazaar_jax.ops.scaling import (DEFAULT_INTRA_8X8, ScalingLists,

                                     diag_scan_order, parse_cqmfile,
                                     upsample)

pytestmark = pytest.mark.heavy


def test_upsample_and_dc():
    m16 = upsample(DEFAULT_INTRA_8X8, 16, dc=20)
    assert m16.shape == (16, 16)
    assert m16[0, 0] == 20                      # DC override
    assert m16[0, 2] == DEFAULT_INTRA_8X8[0, 1]  # 2x2 replication
    assert m16[15, 15] == DEFAULT_INTRA_8X8[7, 7]
    m4 = upsample(np.full((4, 4), 16, np.int32), 4, dc=16)
    assert (m4 == 16).all()


def test_diag_scan_order_4():
    o = diag_scan_order(4)
    assert o.shape == (16, 2)
    assert [tuple(v) for v in o[:6]] == [
        (0, 0), (1, 0), (0, 1), (2, 0), (1, 1), (0, 2)]


def _clip(n, w, h, seed=7):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        y = np.clip(128 + 55 * np.sin(xx / 15.0 + i * 0.4)
                    * np.cos(yy / 12.0) + rng.normal(0, 5, (h, w)),
                    0, 255).astype(np.uint8)
        cb = np.clip(118 + 18 * np.sin(xx[::2, ::2] / 8.0), 0,
                     255).astype(np.uint8)
        out.append((y, cb, cb.copy()))
    return out


def _encode(cfg, frames):
    enc = Encoder(cfg)
    stream = b""
    res = []
    for f in frames:
        for (chunks, info, rec) in enc.encode(*f):
            stream += chunks
            res.append((info, rec))
    return enc, stream, res


def test_default_scaling_lists_e2e_bit_exact():
    w, h, n = 64, 64, 4
    frames = _clip(n, w, h)
    base = dict(width=w, height=h, qp=30, intra_max_cu=16,
                intra_min_cu=16, intra_period=4)
    enc_f, stream_f, _ = _encode(Config(**base).validate(), frames)
    cfg = Config(**base, scaling_list="default").validate()
    enc, stream, res = _encode(cfg, frames)
    dec = decode_stream(stream, enc.params if hasattr(enc, "params")
                        else enc._intra.params)
    assert len(dec) == n
    for k, ((dy, dcb, dcr), _fd) in enumerate(dec):
        info, rec = res[k]
        np.testing.assert_array_equal(dy[:h, :w], rec[0])
        np.testing.assert_array_equal(dcb[:h // 2, :w // 2], rec[1])
        np.testing.assert_array_equal(dcr[:h // 2, :w // 2], rec[2])
    # Non-flat matrices must change the coded output.
    assert stream != stream_f


CQM_SECTIONS = []
for nm, size in [("INTRA4X4_LUMA", 4), ("INTRA4X4_CHROMAU", 4),
                 ("INTRA4X4_CHROMAV", 4), ("INTER4X4_LUMA", 4),
                 ("INTER4X4_CHROMAU", 4), ("INTER4X4_CHROMAV", 4),
                 ("INTRA8X8_LUMA", 8), ("INTRA8X8_CHROMAU", 8),
                 ("INTRA8X8_CHROMAV", 8), ("INTER8X8_LUMA", 8),
                 ("INTER8X8_CHROMAU", 8), ("INTER8X8_CHROMAV", 8),
                 ("INTRA16X16_LUMA", 8), ("INTRA16X16_CHROMAU", 8),
                 ("INTRA16X16_CHROMAV", 8), ("INTER16X16_LUMA", 8),
                 ("INTER16X16_CHROMAU", 8), ("INTER16X16_CHROMAV", 8),
                 ("INTRA32X32_LUMA", 8), ("INTER32X32_LUMA", 8)]:
    vals = (np.arange(size * size) % 9 + 16).tolist()
    CQM_SECTIONS.append(
        nm + "\n" + ",".join(str(v) for v in vals) + "\n")
for nm in ["INTRA16X16_LUMA_DC", "INTRA16X16_CHROMAU_DC",
           "INTRA16X16_CHROMAV_DC", "INTER16X16_LUMA_DC",
           "INTER16X16_CHROMAU_DC", "INTER16X16_CHROMAV_DC",
           "INTRA32X32_LUMA_DC", "INTER32X32_LUMA_DC"]:
    CQM_SECTIONS.append(nm + "\n18\n")


def test_custom_cqmfile_e2e_bit_exact(tmp_path):
    path = tmp_path / "m.cqm"
    path.write_text("".join(CQM_SECTIONS))
    sl = parse_cqmfile(str(path))
    assert sl.custom[(1, 0)].shape == (8, 8)
    assert sl.dc[(2, 0)] == 18
    w, h, n = 64, 64, 3
    frames = _clip(n, w, h, seed=11)
    cfg = Config(width=w, height=h, qp=30, intra_max_cu=16,
                 intra_min_cu=16, intra_period=1,
                 cqmfile=str(path)).validate()
    assert cfg.scaling_list == "custom"
    enc, stream, res = _encode(cfg, frames)
    dec = decode_stream(stream, enc._intra.params)
    assert len(dec) == n
    for k, ((dy, _cb, _cr), _fd) in enumerate(dec):
        np.testing.assert_array_equal(dy[:h, :w], res[k][1][0])


def test_custom_below_8_rejected(tmp_path):
    sl = ScalingLists("custom",
                      {(0, 0): np.full((4, 4), 4, np.int32)}, {})
    with pytest.raises(ValueError):
        sl.validate()


def test_variable_cu_with_default_lists():
    w, h, n = 64, 64, 2
    frames = _clip(n, w, h, seed=13)
    cfg = Config(width=w, height=h, qp=30, intra_min_cu=8,
                 intra_max_cu=32, intra_period=1,
                 scaling_list="default").validate()
    enc, stream, res = _encode(cfg, frames)
    dec = decode_stream(stream, enc._intra.params)
    assert len(dec) == n
    for k, ((dy, _cb, _cr), _fd) in enumerate(dec):
        np.testing.assert_array_equal(dy[:h, :w], res[k][1][0])


def test_rdoq_with_default_lists_e2e_bit_exact():
    """RDOQ x scaling lists (per-position forward scale + inverse m in
    the RDOQ candidate costs) — the reference accepts the combination
    freely (kvz_rdoq uses the scaling-list err_scale, src/rdo.c:588)."""
    w, h, n = 64, 64, 2
    frames = _clip(n, w, h)
    cfg = Config(width=w, height=h, qp=30, intra_max_cu=16,
                 intra_min_cu=16, intra_period=1, rdoq=True,
                 scaling_list="default").validate()
    enc, stream, res = _encode(cfg, frames)
    dec = decode_stream(stream, enc.params if hasattr(enc, "params")
                        else enc._intra.params)
    assert len(dec) == n
    for k, ((dy, dcb, dcr), _fd) in enumerate(dec):
        info, rec = res[k]
        np.testing.assert_array_equal(dy[:h, :w], rec[0])
        np.testing.assert_array_equal(dcb[:h // 2, :w // 2], rec[1])
        np.testing.assert_array_equal(dcr[:h // 2, :w // 2], rec[2])
    # And it must differ from the no-scaling RDOQ stream.
    cfg2 = Config(width=w, height=h, qp=30, intra_max_cu=16,
                  intra_min_cu=16, intra_period=1, rdoq=True).validate()
    _, stream2, _ = _encode(cfg2, frames)
    assert stream != stream2
