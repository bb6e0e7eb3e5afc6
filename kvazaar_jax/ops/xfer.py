"""Device<->host transfer packing.

Written for a slow remote host link, where every transfer call had a
high fixed cost and bytes were expensive in either direction.  Whether
this packing pays on PCIe is not measured (ROADMAP A7).  Rules here:

- ONE host->device buffer per batch (sources concatenated; split +
  bitcast on device) and ONE device->host buffer (adding a second
  transfer call measurably loses to shipping more bytes in one).
- Quantized levels travel as 4-bit two's-complement nibbles (two
  coefficients per byte).  |level| <= 7 covers >99% of coefficients at
  QP >= 22 even on noise-heavy content; the rest ride an exact
  (position, value) int32-pair escape list with a QP-scaled static
  capacity.  Capacity overflow (very low QP / pathological content)
  falls back to the dense int16 tensors kept on device.

The reference encoder has no analogue (everything shares one address
space); the closest design input is kvz_bitstream_move's zero-copy
substream splicing (/root/reference/src/bitstream.c:160) — never move
bytes you can avoid moving.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def esc_capacity(total_coeffs: int, qp: int) -> int:
    """Static escape-record capacity (records are 8 bytes).  The
    |level| > 7 rate falls fast with QP: measured ~0.7% at QP22 on
    noise-heavy synthetic content, <0.1% at QP32."""
    if qp >= 30:
        frac = 256
    elif qp >= 22:
        frac = 96
    elif qp >= 16:
        frac = 16
    else:
        frac = 6
    return max(total_coeffs // frac, 1024)


def pack_levels(levels_i16_flat, qp: int):
    """Device-side pack of a flat int16 level tensor.

    Returns (nib_u8, esc_u8, esc_count):
    - nib_u8: (ceil(T/2),) dense 4-bit nibbles, two coefficients/byte
    - esc_u8: (cap*8,) escape records [(pos i32, val i32), ...]
    - esc_count: int32; > capacity means the caller must use its dense
      fallback
    """
    x = levels_i16_flat.astype(jnp.int16)
    t = x.shape[0]
    if t % 2:
        x = jnp.concatenate([x, jnp.zeros(1, jnp.int16)])
    c4 = jnp.clip(x, -8, 7)
    nib = (c4 & 15).astype(jnp.uint8)
    nib_b = (nib[0::2] | (nib[1::2] << 4))

    cap = esc_capacity(t, qp)
    ef = x != c4
    esc_count = jnp.sum(ef.astype(jnp.int32))
    ep = jnp.cumsum(ef.astype(jnp.int32)) - 1
    eidx = jnp.where(ef, jnp.minimum(ep, cap), cap)
    esc_rec = jnp.zeros((cap + 1, 2), jnp.int32)
    esc_rec = esc_rec.at[eidx, 0].set(
        jnp.arange(x.shape[0], dtype=jnp.int32))
    esc_rec = esc_rec.at[eidx, 1].set(x.astype(jnp.int32))
    u8 = lambda a: jax.lax.bitcast_convert_type(a, jnp.uint8)
    return nib_b, u8(esc_rec[:cap]).reshape(-1), esc_count


# ---- Source (host->device) delta packing --------------------------
#
# Written for a slow host->device link, on which raw 4:2:0 sources
# (1080p: 3.1 MB/frame) were the e2e bottleneck at fast operating
# points.  Pack sources as per-row horizontal deltas: 4-bit nibbles for |d| <= 7 (covers
# >95% of natural content) + a gap-chained escape list ((u16 gap,
# i16 delta) records; row starts are escapes carrying the raw pixel).
# Escape overflow (noise-like content) falls back to the raw upload.

SRC_ESC_DIV = 24


def src_esc_capacity(total: int) -> int:
    return max(total // SRC_ESC_DIV, 4096)


def pack_source_host(planes) -> np.ndarray | None:
    """Host pack of 8-bit source planes for upload.

    planes: list of 2-D uint8 arrays (rows, W_p), one per plane with
    the batch stacked into rows.  Returns ONE uint8 buffer
    [nibbles][gaps u16][vals i16] or None when the escape capacity
    would overflow (caller uploads raw)."""
    parts = []
    for p in planes:
        d = p.astype(np.int16)
        d[:, 1:] -= p[:, :-1].astype(np.int16)
        parts.append(d.reshape(-1))
    d = np.concatenate(parts)
    t = d.shape[0]
    cap = src_esc_capacity(t)
    esc_mask = (d < -8) | (d > 7)
    esc_mask[0] = True                 # anchor: position 0 is always
    pos = np.flatnonzero(esc_mask)     # an escape (first row start)
    if pos.size > cap:
        return None
    gaps64 = np.diff(pos, prepend=-1)
    if (gaps64 > 65535).any():
        # Very flat content: split long gaps with no-op dummies (the
        # dummy rewrites the clipped nibble value at its position).
        ppos, pval = [], []
        prev = -1
        for p_ in pos:
            while p_ - prev > 65535:
                prev += 65535
                ppos.append(prev)
                pval.append(int(np.clip(d[prev], -8, 7)))
            ppos.append(int(p_))
            pval.append(int(d[p_]))
            prev = int(p_)
        if len(ppos) > cap:
            return None
        pos = np.asarray(ppos, np.int64)
        vals = np.asarray(pval, np.int16)
        gaps64 = np.diff(pos, prepend=-1)
    else:
        vals = d[pos]
    n = pos.size
    gaps = np.zeros(cap, np.uint16)
    vals_out = np.zeros(cap, np.int16)
    gaps[:n] = gaps64.astype(np.uint16)
    # Trailing pads: gap 0 re-writes the last escape's value (no-op).
    vals_out[:n] = vals
    if n < cap:
        vals_out[n:] = vals[-1] if n else 0
    c4 = np.clip(d, -8, 7)
    nib = (c4 & 15).astype(np.uint8)
    if t % 2:
        nib = np.concatenate([nib, np.zeros(1, np.uint8)])
    nib_b = nib[0::2] | (nib[1::2] << 4)
    return np.concatenate([nib_b, gaps.view(np.uint8),
                           vals_out.view(np.uint8)])


def unpack_source_device(buf, total: int, plane_shapes):
    """Device-side inverse of pack_source_host (traced).

    buf: (bytes,) uint8; plane_shapes: tuple of (rows, width) per
    plane.  Returns a list of (rows, width) int32 planes."""
    cap = src_esc_capacity(total)
    nbytes = (total + 1) // 2
    nib = buf[:nbytes]
    gaps = jax.lax.bitcast_convert_type(
        buf[nbytes:nbytes + 2 * cap].reshape(cap, 2), jnp.uint16
    ).reshape(cap).astype(jnp.int32)
    vals = jax.lax.bitcast_convert_type(
        buf[nbytes + 2 * cap:nbytes + 4 * cap].reshape(cap, 2),
        jnp.int16).reshape(cap)
    lo = ((nib & 15) ^ 8).astype(jnp.int16) - 8
    hi = ((nib >> 4) ^ 8).astype(jnp.int16) - 8
    d = jnp.stack([lo, hi], axis=1).reshape(-1)[:total]
    pos = jnp.cumsum(gaps) - 1
    d = d.at[pos].set(vals)
    out = []
    off = 0
    for rows, w in plane_shapes:
        n = rows * w
        out.append(jnp.cumsum(
            jax.lax.slice(d, (off,), (off + n,)).reshape(rows, w)
            .astype(jnp.int32), axis=1))
        off += n
    return out


def unpack_levels(nib: np.ndarray, esc: np.ndarray, esc_count: int,
                  total: int) -> np.ndarray:
    """Host inverse of pack_levels -> flat levels.  int8 when every
    escape fits (the common case), else int16."""
    if esc_count:
        rec = esc[:esc_count * 8].copy().view(np.int32) \
            .reshape(esc_count, 2)
        esc_pos, esc_val = rec[:, 0], rec[:, 1]
    else:
        esc_pos = esc_val = np.empty(0, np.int32)
    dt = np.int8
    if esc_count and (np.abs(esc_val) > 127).any():
        dt = np.int16
    n2 = nib.shape[0]
    out = np.empty(n2 * 2, dt)
    # Sign-extend the 4-bit fields: (v ^ 8) - 8 over 0..15.
    out[0::2] = (((nib & 15) ^ 8).astype(np.int16) - 8).astype(dt)
    out[1::2] = (((nib >> 4) ^ 8).astype(np.int16) - 8).astype(dt)
    if esc_count:
        out[esc_pos] = esc_val.astype(dt)
    return out[:total]
