"""Transfer packing roundtrips (ops/xfer.py): the device->host level
path must be EXACT — a wrong coefficient silently corrupts every
benched bitstream (the conformance oracle is the backstop; this is the
unit gate).  Analogue of the reference's generic-vs-SIMD equivalence
suites (/root/reference/tests/test_strategies.c:28-53) for the packing
'backend'."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from kvazaar_jax.ops.xfer import (esc_capacity, pack_levels,
                                  unpack_levels)


def roundtrip(x, qp):
    nib, esc, ec = jax.jit(lambda v: pack_levels(v, qp))(jnp.asarray(x))
    nib, esc, ec = np.asarray(nib), np.asarray(esc), int(ec)
    if ec > esc_capacity(x.shape[0], qp):
        return None     # dense-fallback regime
    return unpack_levels(nib, esc, ec, x.shape[0])


@pytest.mark.smoke
@pytest.mark.parametrize("t,sparsity,escfrac,qp", [
    (59904, 0.6, 0.007, 22),     # noisy-content profile
    (12345, 0.95, 0.0, 32),      # clean content, odd length
    (257, 0.0, 0.12, 12),        # dense + many escapes, low QP
    (4096, 1.0, 0.0, 22),        # all zero
    (64, 0.5, 0.5, 0),           # escape-heavy
])
def test_pack_roundtrip(t, sparsity, escfrac, qp):
    rng = np.random.default_rng(t)
    x = np.zeros(t, np.int16)
    nzm = rng.random(t) > sparsity
    x[nzm] = rng.integers(-7, 8, nzm.sum())
    em = rng.random(t) < escfrac
    x[em] = rng.integers(-3000, 3000, em.sum())
    y = roundtrip(x, qp)
    if y is None:
        return          # overflow regime is the caller's dense path
    assert np.array_equal(y.astype(np.int32), x.astype(np.int32))


@pytest.mark.smoke
def test_escape_overflow_flagged():
    """esc_count must exceed capacity when content blows the escape
    budget — never silently corrupt."""
    t = 4096
    x = np.full(t, 300, np.int16)        # every coefficient escapes
    nib, esc, ec = jax.jit(lambda v: pack_levels(v, 30))(jnp.asarray(x))
    assert int(ec) > esc_capacity(t, 30)


@pytest.mark.smoke
def test_int16_escape_values():
    x = np.zeros(1024, np.int16)
    x[5] = 30000
    x[900] = -30000
    y = roundtrip(x, 0)
    assert y is not None and y.dtype == np.int16
    assert y[5] == 30000 and y[900] == -30000


# ---- source (host->device) delta pack ----

from kvazaar_jax.ops.xfer import pack_source_host, unpack_source_device


def _src_roundtrip(planes):
    buf = pack_source_host(planes)
    if buf is None:
        return None
    shapes = tuple(p.shape for p in planes)
    total = sum(p.size for p in planes)
    out = jax.jit(lambda b: unpack_source_device(b, total, shapes))(
        jnp.asarray(buf))
    return [np.asarray(o) for o in out]


@pytest.mark.smoke
def test_source_pack_roundtrip_natural():
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:64, 0:96]
    y = np.clip(120 + 55 * np.sin(xx / 17.0) + 20 * (yy // 16 % 2),
                0, 255).astype(np.uint8)
    cb = np.clip(110 + 30 * np.cos(xx[::2, ::2] / 9.0), 0,
                 255).astype(np.uint8)
    cr = np.clip(140 + rng.integers(-3, 4, (32, 48)), 0,
                 255).astype(np.uint8)
    out = _src_roundtrip([y, cb, cr])
    assert out is not None
    for got, want in zip(out, (y, cb, cr)):
        np.testing.assert_array_equal(got, want.astype(np.int32))


@pytest.mark.smoke
def test_source_pack_overflow_returns_none():
    rng = np.random.default_rng(1)
    noise = rng.integers(0, 256, (64, 96)).astype(np.uint8)
    assert pack_source_host([noise]) is None


@pytest.mark.smoke
def test_source_pack_flat_long_gaps():
    flat = np.full((128, 512), 5, np.uint8)   # zero deltas everywhere
    out = _src_roundtrip([flat])
    assert out is not None
    np.testing.assert_array_equal(out[0], flat.astype(np.int32))


@pytest.mark.smoke
def test_source_pack_encode_equivalence():
    """submit_frames' packed upload must produce the identical
    bitstream as the raw upload path."""
    from kvazaar_jax.config import Config
    from kvazaar_jax.encoder.frame_encoder import IntraFrameEncoder
    yy, xx = np.mgrid[0:64, 0:96]
    y = np.clip(128 + 50 * np.sin(xx / 13.0) * np.cos(yy / 7.0),
                0, 255).astype(np.uint8)
    cb = np.clip(120 + 25 * np.sin(xx[::2, ::2] / 11.0), 0,
                 255).astype(np.uint8)
    cr = np.clip(130 + 25 * np.cos(yy[::2, ::2] / 9.0), 0,
                 255).astype(np.uint8)
    cfg = Config(width=96, height=64, qp=30, intra_period=1,
                 intra_min_cu=16, intra_max_cu=16).validate()
    enc = IntraFrameEncoder(cfg)
    res_packed = enc.encode_frames([(y, cb, cr)])
    assert hasattr(enc, "_packed_fns"), "packed path not taken"
    buf, _ = enc.host_pack_sources([(y, cb, cr)])
    res_raw = enc.finalize_frames((1, enc._device_encode_batch(buf),
                                   None))
    assert res_packed[0].nals == res_raw[0].nals
