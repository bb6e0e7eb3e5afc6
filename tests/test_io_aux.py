"""YUV I/O parity (depth conversion, endianness, seek, reader thread)
and the checkpoint record/replay oracle."""

import os

import numpy as np
import pytest

from kvazaar_jax.io.yuv import (frame_size_bytes, read_frames,
                                read_frames_async, write_frame)

pytestmark = pytest.mark.smoke


def _write_clip(path, frames, bitdepth=8, big_endian=False):
    with open(path, "wb") as f:
        for y, cb, cr in frames:
            for p in (y, cb, cr):
                if p is None:
                    continue
                if bitdepth > 8:
                    dt = ">u2" if big_endian else "<u2"
                    f.write(p.astype(dt).tobytes())
                else:
                    f.write(p.astype(np.uint8).tobytes())


def _mk(rng, w, h, maxv):
    y = rng.integers(0, maxv + 1, (h, w))
    cb = rng.integers(0, maxv + 1, (h // 2, w // 2))
    cr = rng.integers(0, maxv + 1, (h // 2, w // 2))
    return y, cb, cr


def test_read_seek_and_count(tmp_path):
    rng = np.random.default_rng(3)
    frames = [_mk(rng, 16, 8, 255) for _ in range(5)]
    p = str(tmp_path / "c.yuv")
    _write_clip(p, frames)
    got = list(read_frames(p, 16, 8, 8, True, max_frames=2, skip=2))
    assert len(got) == 2
    np.testing.assert_array_equal(got[0][0], frames[2][0])
    np.testing.assert_array_equal(got[1][2], frames[3][2])


def test_depth_upconvert_8_to_10(tmp_path):
    rng = np.random.default_rng(4)
    frames = [_mk(rng, 8, 8, 255)]
    p = str(tmp_path / "c8.yuv")
    _write_clip(p, frames)
    (y, cb, cr), = read_frames(p, 8, 8, bitdepth=10, file_bitdepth=8)
    assert y.dtype == np.uint16
    np.testing.assert_array_equal(y, frames[0][0].astype(np.uint16) << 2)


def test_depth_downconvert_10_to_8_rounds(tmp_path):
    p = str(tmp_path / "c10.yuv")
    y = np.array([[0, 1, 2, 3, 509, 510, 511, 1023]], np.uint16)
    y = np.repeat(y, 2, axis=0)
    cb = np.full((1, 4), 512, np.uint16)
    cr = np.full((1, 4), 2, np.uint16)
    _write_clip(p, [(y, cb, cr)], bitdepth=10)
    (gy, gcb, gcr), = read_frames(p, 8, 2, bitdepth=8, file_bitdepth=10)
    assert gy.dtype == np.uint8
    np.testing.assert_array_equal(gy[0], [0, 0, 1, 1, 127, 128, 128, 255])
    assert gcb[0, 0] == 128 and gcr[0, 0] == 1


def test_big_endian_input(tmp_path):
    rng = np.random.default_rng(5)
    frames = [_mk(rng, 8, 4, 1023)]
    p = str(tmp_path / "be.yuv")
    _write_clip(p, frames, bitdepth=10, big_endian=True)
    (y, _, _), = read_frames(p, 8, 4, bitdepth=10, file_bitdepth=10,
                             big_endian=True)
    np.testing.assert_array_equal(y, frames[0][0])


def test_async_reader_matches_sync(tmp_path):
    rng = np.random.default_rng(6)
    frames = [_mk(rng, 16, 16, 255) for _ in range(7)]
    p = str(tmp_path / "a.yuv")
    _write_clip(p, frames)
    sync = list(read_frames(p, 16, 16))
    async_ = list(read_frames_async(p, 16, 16))
    assert len(sync) == len(async_) == 7
    for (a, b, c), (d, e, f) in zip(sync, async_):
        np.testing.assert_array_equal(a, d)
        np.testing.assert_array_equal(b, e)
        np.testing.assert_array_equal(c, f)


def test_async_reader_propagates_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        list(read_frames_async(str(tmp_path / "missing.yuv"), 8, 8))


# ---------------------------------------------------------------------
# Checkpoint record/replay oracle (reference src/checkpoint.h:42).
# ---------------------------------------------------------------------

def _frame_args(seed, bits=1000):
    rng = np.random.default_rng(seed)
    rec = (rng.integers(0, 255, (8, 8)), None, None)

    class FD:
        def __init__(self):
            self.mode4 = rng.integers(0, 35, (2, 2))
    return dict(poc=0, qp=27, nal_type=19, slice_type=2, bits=bits,
                rec=rec, frame_data=FD())


def test_checkpoint_roundtrip(tmp_path, monkeypatch):
    from kvazaar_jax.checkpoint import Checkpointer, CheckpointMismatch
    log = str(tmp_path / "ckpt.log")
    monkeypatch.setenv("CHECKPOINTS", "record")
    monkeypatch.setenv("CHECKPOINTS_FILE", log)
    ck = Checkpointer()
    a = _frame_args(1)
    ck.mark_frame(a["poc"], a["qp"], a["nal_type"], a["slice_type"],
                  a["bits"], a["rec"], a["frame_data"])
    ck.close()

    monkeypatch.setenv("CHECKPOINTS", "check")
    ck2 = Checkpointer()
    b = _frame_args(1)   # identical content
    ck2.mark_frame(b["poc"], b["qp"], b["nal_type"], b["slice_type"],
                   b["bits"], b["rec"], b["frame_data"])

    ck3 = Checkpointer()
    c = _frame_args(2)   # different content -> mismatch
    with pytest.raises(CheckpointMismatch):
        ck3.mark_frame(c["poc"], c["qp"], c["nal_type"],
                       c["slice_type"], c["bits"], c["rec"],
                       c["frame_data"])


def test_checkpoint_inactive_by_default(monkeypatch):
    from kvazaar_jax.checkpoint import Checkpointer
    monkeypatch.delenv("CHECKPOINTS", raising=False)
    ck = Checkpointer()
    assert not ck.active
    ck.mark_frame(0, 22, 19, 2, 0, (None, None, None), None)  # no-op


def test_cli_flag_mapping():
    """CLI flags land on the config (no encode)."""
    from kvazaar_jax.cli import build_argparser
    ap = build_argparser()
    args = ap.parse_args([
        "-i", "x.yuv", "--input-res", "64x64", "-o", "y.hevc",
        "--gop", "lp-g4d2t1", "--ref", "2", "--no-wpp", "--seek", "3",
        "--input-fps", "30000/1001", "--sar", "16:9", "--subme", "0"])
    assert args.gop == "lp-g4d2t1" and args.ref == 2
    assert args.no_wpp and args.seek == 3 and args.subme == 0


def test_level_tier_config():
    from kvazaar_jax.config import Config
    cfg = Config(width=1920, height=1080, qp=30, level="4.1").validate()
    assert cfg.level == "4.1"
    with pytest.raises(ValueError):
        Config(width=3840, height=2160, qp=30, level="3.1").validate()
    with pytest.raises(ValueError):
        Config(width=64, height=64, qp=30, level="9.9").validate()
    with pytest.raises(ValueError):
        Config(width=64, height=64, qp=30, tier="bogus").validate()
    cfg = Config(width=1920, height=1080, qp=30, level="5",
                 tier="high").validate()


def test_forced_level_reaches_sps():
    import numpy as np
    from kvazaar_jax.config import Config
    from kvazaar_jax.encoder.frame_encoder import IntraFrameEncoder
    cfg = Config(width=64, height=64, qp=30, level="5.1").validate()
    enc = IntraFrameEncoder(cfg)
    assert enc.params.level_idc == 153
    cfg2 = Config(width=64, height=64, qp=30, tier="high",
                  level="4").validate()
    enc2 = IntraFrameEncoder(cfg2)
    assert enc2.params.tier == 1


def test_cli_stats_and_threads(tmp_path):
    """--stats/--threads/--owf run e2e through the CLI."""
    import numpy as np
    rng = np.random.default_rng(0)
    p = tmp_path / "c.yuv"
    with open(p, "wb") as f:
        for _ in range(3):
            f.write(rng.integers(0, 255, (64, 64)).astype(
                np.uint8).tobytes())
            f.write(np.full((32, 32), 110, np.uint8).tobytes())
            f.write(np.full((32, 32), 130, np.uint8).tobytes())
    from kvazaar_jax.cli import main
    rc = main(["-i", str(p), "--input-res", "64x64", "-o",
               str(tmp_path / "o.hevc"), "-q", "32", "-p", "1",
               "--threads", "2", "--owf", "2", "--stats",
               "--no-psnr"])
    assert rc == 0


def test_async_feed_drain():
    """Reference-shaped feed/drain (kvazaar_encode async contract):
    results trail the feed by the pipeline depth and flush(None)
    drains the tail."""
    from kvazaar_jax.api import Encoder
    from kvazaar_jax.config import Config
    rng = np.random.default_rng(9)
    w = h = 64
    enc = Encoder(Config(width=w, height=h, qp=32, intra_period=0,
                         intra_max_cu=16, intra_min_cu=16))
    results = []
    n = 5
    for i in range(n):
        y = rng.integers(0, 255, (h, w)).astype(np.uint8)
        cb = np.full((h // 2, w // 2), 110, np.uint8)
        cr = np.full((h // 2, w // 2), 130, np.uint8)
        results += enc.feed(y, cb, cr)
    results += enc.feed(None)            # flush
    assert len(results) == n
    pocs = [info.poc for _c, info, _r in results]
    assert pocs == list(range(n))


def test_profiler_phases_and_trace(tmp_path):
    from kvazaar_jax.profiler import device_trace, phase, phases
    phases.reset()
    with phase("demo"):
        pass
    with phase("demo"):
        pass
    d = phases.as_dict()
    assert d["demo"][1] == 2
    assert "demo" in phases.report()
    import jax.numpy as jnp
    with device_trace(str(tmp_path / "tr")):
        _ = jnp.ones((8, 8)).sum().block_until_ready()
    import os
    assert any(os.scandir(tmp_path / "tr"))
