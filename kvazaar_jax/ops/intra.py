"""HEVC intra prediction (H.265 8.4.4.2) — batched, all modes at once.

Reference: src/intra.c (kvz_intra_build_reference, kvz_intra_predict) and
the per-mode kernels in src/strategies/*/intra-*.c.  The reference predicts
one mode at a time per PU; its rough search calls SATD per candidate mode
(src/search_intra.c:404).

Device design: every HEVC intra mode (planar, DC base value, all 33 angular
modes, including the negative-angle inverse projection) is an *integer
linear map* from the 1D reference-sample vector followed by a rounding
shift.  We precompute, per block size, a weight tensor
    W: (35, N*N, 2*(4N+1)) int32
over the concatenation [unfiltered refs, smoothed refs] (each mode reads
the ref array the spec assigns it), so prediction of ALL modes for a batch
of blocks is a single einsum → one matmul:
    pred[b, m, p] = (W[m] @ refs2[b]  + round) >> shift[m].
The only non-linear parts of the spec — reference substitution, the DC/
mode-10/26 boundary fixups (nested integer divisions + clipping) — are
small vectorized post-passes.

Reference-vector layout (length 4N+1), following the spec's substitution
scan order bottom-left → corner → top-right:
    ref[i]        = p[-1][2N-1-i]   for i in [0, 2N)   (left column, bottom-up)
    ref[2N]       = p[-1][-1]        (corner)
    ref[2N+1+x]   = p[x][-1]         for x in [0, 2N)   (top row)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from kvazaar_jax.ops.exactmm import einsum_exact

# H.265 Table 8-4/8-5.
INTRA_PRED_ANGLE = np.array(
    [32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26, -32,
     -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26, 32],
    dtype=np.int32)  # index = mode - 2
INV_ANGLE = np.array(
    [-4096, -1638, -910, -630, -482, -390, -315, -256,
     -315, -390, -482, -630, -910, -1638, -4096],
    dtype=np.int32)  # index = mode - 11, for modes 11..25


def _ref_index_left(n: int, y: int) -> int:
    """Index of p[-1][y] in the ref vector (y in [-1, 2N-1])."""
    return 2 * n - 1 - y


def _ref_index_top(n: int, x: int) -> int:
    """Index of p[x][-1] in the ref vector (x in [-1, 2N-1])."""
    return 2 * n + 1 + x


def _filter_flag(mode: int, n: int) -> bool:
    """H.265 8.4.4.2.3 filterFlag (luma)."""
    if mode == 1 or n == 4:
        return False
    min_dist = min(abs(mode - 26), abs(mode - 10))
    thresh = {8: 7, 16: 1, 32: 0}[n]
    return min_dist > thresh


def weight_key(n: int, luma: bool) -> str:
    """devconst key for the (35, N*N, 2R) mode-weight tensor."""
    return f"iw.{'l' if luma else 'c'}{n}"


@functools.lru_cache(maxsize=None)
def mode_weights_np(n: int, luma: bool):
    """(W, shifts): W is (35, N*N, 2*(4N+1)) int32; shifts is (35,) int32.

    Column space = [unfiltered refs | smoothed refs]; each mode's taps live
    in the half the spec assigns it (chroma always unfiltered).
    """
    rlen = 4 * n + 1
    w = np.zeros((35, n * n, 2 * rlen), dtype=np.int32)
    shifts = np.zeros((35,), dtype=np.int32)
    log2n = int(n).bit_length() - 1

    def col(mode, ridx):
        use_filt = luma and _filter_flag(mode, n)
        return ridx + (rlen if use_filt else 0)

    # --- Planar (8.4.4.2.4) ---
    shifts[0] = log2n + 1
    for y in range(n):
        for x in range(n):
            p = y * n + x
            w[0, p, col(0, _ref_index_left(n, y))] += n - 1 - x
            w[0, p, col(0, _ref_index_top(n, n))] += x + 1
            w[0, p, col(0, _ref_index_top(n, x))] += n - 1 - y
            w[0, p, col(0, _ref_index_left(n, n))] += y + 1

    # --- DC base value (8.4.4.2.5); boundary fixup applied separately ---
    shifts[1] = log2n + 1
    for y in range(n):
        for x in range(n):
            p = y * n + x
            for xx in range(n):
                w[1, p, col(1, _ref_index_top(n, xx))] += 1
            for yy in range(n):
                w[1, p, col(1, _ref_index_left(n, yy))] += 1

    # --- Angular modes 2..34 (8.4.4.2.6) ---
    for mode in range(2, 35):
        shifts[mode] = 5
        angle = int(INTRA_PRED_ANGLE[mode - 2])
        vertical = mode >= 18

        def ext_ref(k: int) -> int:
            # Index into the ref vector of extended array ref_v/ref_h[k].
            if vertical:
                if k >= 0:
                    return _ref_index_top(n, k - 1)
                inv = int(INV_ANGLE[mode - 11])
                return _ref_index_left(n, -1 + ((k * inv + 128) >> 8))
            else:
                if k >= 0:
                    return _ref_index_left(n, k - 1)
                inv = int(INV_ANGLE[mode - 11])
                return _ref_index_top(n, -1 + ((k * inv + 128) >> 8))

        for y in range(n):
            for x in range(n):
                p = y * n + x
                t = (y + 1) if vertical else (x + 1)
                idx = (t * angle) >> 5
                fact = (t * angle) & 31
                base = (x if vertical else y) + idx + 1
                w[mode, p, col(mode, ext_ref(base))] += 32 - fact
                if fact:
                    w[mode, p, col(mode, ext_ref(base + 1))] += fact
    return w, shifts


def substitute_refs(refs, avail, bitdepth: int = 8):
    """Reference sample substitution (8.4.4.2.2), batched.

    refs:  (..., 4N+1) int32 (garbage where unavailable)
    avail: (..., 4N+1) bool
    """
    default = 1 << (bitdepth - 1)
    any_avail = jnp.any(avail, axis=-1, keepdims=True)
    # Value of the first available sample (scan order = vector order).
    idx_first = jnp.argmax(avail, axis=-1)
    first_val = jnp.take_along_axis(refs, idx_first[..., None], axis=-1)
    seed = jnp.where(avail[..., :1], refs[..., :1], first_val)
    refs0 = jnp.concatenate([seed, refs[..., 1:]], axis=-1)
    avail0 = jnp.concatenate(
        [jnp.ones_like(avail[..., :1]), avail[..., 1:]], axis=-1)

    # Fill-forward: unavailable positions inherit the previous value.
    def step(carry, va):
        v, a = va
        out = jnp.where(a, v, carry)
        return out, out

    moved_refs = jnp.moveaxis(refs0, -1, 0)
    moved_avail = jnp.moveaxis(avail0, -1, 0)
    _, filled = jax.lax.scan(step, moved_refs[0], (moved_refs, moved_avail))
    filled = jnp.moveaxis(filled, 0, -1)
    return jnp.where(any_avail, filled, jnp.full_like(refs, default))


def smooth_refs(refs):
    """[1 2 1]/4 smoothing along the ref vector, endpoints kept
    (8.4.4.2.3)."""
    left = refs[..., :-2]
    mid = refs[..., 1:-1]
    right = refs[..., 2:]
    f = (left + 2 * mid + right + 2) >> 2
    return jnp.concatenate([refs[..., :1], f, refs[..., -1:]], axis=-1)


def strong_smooth_refs(refs, n: int, bitdepth: int = 8):
    """Bilinear 'strong intra smoothing' for 32x32 luma (8.4.4.2.3),
    applied where the flatness conditions hold; otherwise normal smoothing.

    refs: (..., 4N+1). Returns the filtered ref vector.
    """
    assert n == 32
    corner = refs[..., 2 * n]
    top_last = refs[..., 4 * n]
    left_last = refs[..., 0]
    top_mid = refs[..., 2 * n + 1 + (n - 1)]
    left_mid = refs[..., _ref_index_left(n, n - 1)]
    thr = 1 << (bitdepth - 5)
    flat = (jnp.abs(corner + top_last - 2 * top_mid) < thr) & \
           (jnp.abs(corner + left_last - 2 * left_mid) < thr)

    i = jnp.arange(1, 2 * n)  # positions 1..63 along each arm
    # Top arm: pF[x][-1] = ((63-x)*corner + (x+1)*top[63] + 32) >> 6, x=i-1
    top = (( (2 * n - 1 - (i - 1)) * corner[..., None]
            + i * top_last[..., None] + n) >> 6)
    left = (( (2 * n - 1 - (i - 1)) * corner[..., None]
             + i * left_last[..., None] + n) >> 6)
    strong = jnp.concatenate(
        [refs[..., :1], left[..., ::-1], corner[..., None], top,
         refs[..., -1:]], axis=-1)
    normal = smooth_refs(refs)
    return jnp.where(flat[..., None], strong, normal)


def _clip_pix(x, bitdepth):
    return jnp.clip(x, 0, (1 << bitdepth) - 1)


def predict_all_modes(refs, n: int, luma: bool = True, bitdepth: int = 8,
                      strong_smoothing: bool = False,
                      fixups: bool = True):
    """Predict all 35 modes for a batch of blocks.

    refs: (B, 4N+1) int32 substituted reference vectors (unfiltered).
    Returns (B, 35, N, N) int32 predictions.
    """
    from kvazaar_jax.ops.devconst import fetch
    w = fetch(weight_key(n, luma), lambda: mode_weights_np(n, luma)[0])
    shifts = jnp.asarray(mode_weights_np(n, luma)[1])
    if luma and n >= 8:
        filt = (strong_smooth_refs(refs, n, bitdepth) if (strong_smoothing and n == 32)
                else smooth_refs(refs))
    else:
        filt = refs
    refs2 = jnp.concatenate([refs, filt], axis=-1)
    raw = einsum_exact("mpr,br->bmp", w, refs2, 1 << bitdepth)
    pred = (raw + (1 << (shifts - 1))[None, :, None]) >> shifts[None, :, None]
    pred = pred.reshape(pred.shape[0], 35, n, n)
    if not fixups:
        # Lossless + implicit RDPCM disables the luma boundary filters
        # (reference filter_boundary, src/intra.c:621).
        return pred
    return _apply_fixups(pred, refs, n, luma, bitdepth)


def _boundary_pieces(refs, n):
    top = refs[..., 2 * n + 1: 2 * n + 1 + n]            # p[0..N-1][-1]
    left = refs[..., n: 2 * n][..., ::-1]                 # p[-1][0..N-1]
    corner = refs[..., 2 * n]
    return top, left, corner


def _apply_fixups(pred, refs, n, luma, bitdepth):
    """DC boundary smoothing and mode 10/26 edge filters (luma, N<32)."""
    if not luma or n >= 32:
        return pred
    top, left, corner = _boundary_pieces(refs, n)
    dc = pred[:, 1, n // 2, n // 2]  # DC base value (constant over block)

    p_dc = pred[:, 1]
    row0 = (top + 3 * dc[:, None] + 2) >> 2
    col0 = (left + 3 * dc[:, None] + 2) >> 2
    c00 = (left[:, 0] + 2 * dc + top[:, 0] + 2) >> 2
    p_dc = p_dc.at[:, 0, :].set(row0)
    p_dc = p_dc.at[:, :, 0].set(col0)
    p_dc = p_dc.at[:, 0, 0].set(c00)

    # Mode 10 (horizontal): first row filtered against the top refs.
    p10 = pred[:, 10].at[:, 0, :].set(
        _clip_pix(left[:, :1] + ((top - corner[:, None]) >> 1), bitdepth))
    # Mode 26 (vertical): first column filtered against the left refs.
    p26 = pred[:, 26].at[:, :, 0].set(
        _clip_pix(top[:, :1] + ((left - corner[:, None]) >> 1), bitdepth))

    pred = pred.at[:, 1].set(p_dc)
    pred = pred.at[:, 10].set(p10)
    pred = pred.at[:, 26].set(p26)
    return pred


def predict_modes(refs, modes, n: int, luma: bool = True, bitdepth: int = 8,
                  strong_smoothing: bool = False, fixups: bool = True):
    """Predict one chosen mode per block.

    refs: (B, 4N+1) int32; modes: (B,) int32. Returns (B, N, N) int32.
    """
    from kvazaar_jax.ops.devconst import fetch
    w = fetch(weight_key(n, luma), lambda: mode_weights_np(n, luma)[0])
    shifts = jnp.asarray(mode_weights_np(n, luma)[1])
    if luma and n >= 8:
        filt = (strong_smooth_refs(refs, n, bitdepth) if (strong_smoothing and n == 32)
                else smooth_refs(refs))
    else:
        filt = refs
    refs2 = jnp.concatenate([refs, filt], axis=-1)
    wsel = w[modes]                      # (B, N*N, 2R)
    ssel = shifts[modes]                 # (B,)
    raw = einsum_exact("bpr,br->bp", wsel, refs2, 1 << bitdepth)
    pred = (raw + (1 << (ssel - 1))[:, None]) >> ssel[:, None]
    pred = pred.reshape(pred.shape[0], n, n)
    if not luma or n >= 32 or not fixups:
        return pred
    # Apply the same fixups, selected per block by mode.
    top, left, corner = _boundary_pieces(refs, n)
    dc = pred[:, n // 2, n // 2]
    row0 = (top + 3 * dc[:, None] + 2) >> 2
    col0 = (left + 3 * dc[:, None] + 2) >> 2
    c00 = (left[:, 0] + 2 * dc + top[:, 0] + 2) >> 2
    p_dc = pred.at[:, 0, :].set(row0).at[:, :, 0].set(col0).at[:, 0, 0].set(c00)
    p10 = pred.at[:, 0, :].set(
        _clip_pix(left[:, :1] + ((top - corner[:, None]) >> 1), bitdepth))
    p26 = pred.at[:, :, 0].set(
        _clip_pix(top[:, :1] + ((left - corner[:, None]) >> 1), bitdepth))
    pred = jnp.where((modes == 1)[:, None, None], p_dc, pred)
    pred = jnp.where((modes == 10)[:, None, None], p10, pred)
    pred = jnp.where((modes == 26)[:, None, None], p26, pred)
    return pred
