"""Exactness checks of the encoder's device ops on a chosen device.

Every op checked here is integer-exact by design (ops/exactmm.py: bf16
operands, f32 accumulation, partial sums within 2^24), so each check
runs the op jitted on the given device and compares it with a host
integer model (kvazaar_jax.refmodels) at tolerance 0.  Checks return
{case: number of mismatching values}.  chip_smoke.py runs them at
deployment widths on the GPU; the test suite runs them at tiny widths
on the CPU.
"""

from __future__ import annotations

import time

import jax
import numpy as np

from kvazaar_jax import refmodels as rm

# Operand bounds the encoder passes to einsum_exact: 8-bit samples,
# 10-bit samples/residuals, Hadamard and transform intermediates.
EINSUM_BOUNDS = (1 << 8, 1 << 10, 1 << 13, 1 << 14, 1 << 15)
_TMAX = 90          # largest |entry| of the HEVC DCT tables


def run_on(dev, fn, *args):
    """fn jitted on `dev` (inputs committed there); outputs as numpy."""
    out = jax.jit(fn)(*[jax.device_put(a, dev) for a in args])
    return jax.tree.map(np.asarray, out)


def einsum_mismatches(dev, batch: int, k: int = 32, seed: int = 0):
    """einsum_exact at every bound of EINSUM_BOUNDS (and einsum_exact_f32
    where its partial sums stay within 2^24) against int64 NumPy."""
    from kvazaar_jax.ops.exactmm import einsum_exact, einsum_exact_f32
    rng = np.random.default_rng(seed)
    t = rng.integers(-_TMAX, _TMAX + 1, (k, k)).astype(np.int32)
    out = {}
    for b in EINSUM_BOUNDS:
        x = rng.integers(-b + 1, b, (batch, k, k)).astype(np.int32)
        want = np.einsum("kn,bnm->bkm", t.astype(np.int64),
                         x.astype(np.int64))
        got = run_on(dev, lambda t_, x_: einsum_exact(
            "kn,bnm->bkm", t_, x_, b), t, x)
        out[f"einsum_exact bound 2^{b.bit_length() - 1}"] = \
            int((got != want).sum())
        if k * _TMAX * b < (1 << 24):
            got = run_on(dev, lambda t_, x_: einsum_exact_f32(
                "kn,bnm->bkm", t_, x_), t, x)
            out[f"einsum_exact_f32 bound 2^{b.bit_length() - 1}"] = \
                int((got != want).sum())
    return out


def transform_mismatches(dev, pixels: int, sample: int = 4,
                         seed: int = 1):
    """Forward and inverse DCT 4..32 and DST 4x4, 8- and 10-bit, on as
    many blocks as tile `pixels`: every block against the int64 models,
    `sample` blocks against the scalar spec inverse transform."""
    from kvazaar_jax.ops.transform import (forward_transform,
                                           inverse_transform)
    rng = np.random.default_rng(seed)
    out = {}
    for size, dst in ((4, True), (4, False), (8, False), (16, False),
                      (32, False)):
        batch = max(pixels // (size * size), sample)
        for bd in (8, 10):
            resid = rng.integers(-(1 << bd) + 1, 1 << bd,
                                 (batch, size, size)).astype(np.int32)
            got = run_on(dev, lambda r: forward_transform(
                r, size, bd, dst=dst), resid)
            bad = (got != rm.np_forward_transform(resid, size, bd,
                                                  dst)).sum()
            coeff = rng.integers(-32768, 32768,
                                 (batch, size, size)).astype(np.int32)
            got = run_on(dev, lambda c: inverse_transform(
                c, size, bd, dst=dst), coeff)
            bad += (got != rm.np_inverse_transform(coeff, size, bd,
                                                   dst)).sum()
            for i in rng.choice(batch, min(sample, batch), replace=False):
                bad += (got[i] != rm.spec_inverse_transform(
                    coeff[i], size, bd, dst)).sum()
            out[f"{'dst' if dst else 'dct'}{size} {bd}-bit"] = int(bad)
    return out


def intra_mismatches(dev, pixels: int, sample: int = 2, seed: int = 2,
                     sizes=(4, 8, 16, 32)):
    """All 35 modes for as many random reference vectors as blocks of
    each size tile `pixels` (luma 4..32, chroma 4..16), 8- and 10-bit;
    `sample` vectors of each against the scalar spec prediction."""
    from kvazaar_jax.ops.intra import predict_all_modes
    rng = np.random.default_rng(seed)
    out = {}
    for n in sizes:
        batch = max(pixels // (n * n), sample)
        for luma in (True, False):
            if not luma and n == 32:
                continue
            for bd in (8, 10):
                refs = rng.integers(0, 1 << bd, (batch, 4 * n + 1)) \
                    .astype(np.int32)
                got = run_on(dev, lambda r: predict_all_modes(
                    r, n, luma, bd), refs)
                bad = 0
                for i in rng.choice(batch, min(sample, batch),
                                    replace=False):
                    for m in range(35):
                        bad += (got[i, m] != rm.spec_intra_predict(
                            refs[i], m, n, luma, bd)).sum()
                out[f"intra {'luma' if luma else 'chroma'}{n} "
                    f"{bd}-bit"] = int(bad)
    return out


def _planes(rng, w: int, h: int):
    """A reference plane and a shifted, noisy current plane."""
    ref = rng.integers(0, 256, (h, w)).astype(np.int32)
    cur = np.clip(np.roll(ref, (3, -5), (0, 1))
                  + rng.integers(-8, 9, (h, w)), 0, 255).astype(np.int32)
    return cur, ref


def sad_mismatches(dev, w: int, h: int, radius: int = 16,
                   size: int = 16, seed: int = 3):
    """Whole-frame integer-pel SAD surfaces against NumPy."""
    from kvazaar_jax.ops.inter import sad_surfaces
    cur, ref = _planes(np.random.default_rng(seed), w, h)
    got = run_on(dev, lambda c, r: sad_surfaces(c, r, radius, size),
                 cur, ref)
    want = rm.np_sad_surfaces(cur, ref, radius, size)
    return {f"sad {w}x{h} radius {radius} block {size}":
            int((got != want).sum())}


def mc_mismatches(dev, w: int, h: int, cu: int = 16, sample: int = 16,
                  seed: int = 4):
    """Whole-frame quarter-pel MC (mc_planes: luma phase planes plus
    chroma taps) for a random MV field; `sample` blocks against the
    per-sample spec filters."""
    from kvazaar_jax.encoder.geometry import make_intra_plan
    from kvazaar_jax.encoder.inter_search import mc_planes
    rng = np.random.default_rng(seed)
    plan = make_intra_plan(w, h, cu)
    y = rng.integers(0, 256, (h, w)).astype(np.int32)
    cb = rng.integers(0, 256, (h // 2, w // 2)).astype(np.int32)
    cr = rng.integers(0, 256, (h // 2, w // 2)).astype(np.int32)
    by, bx = h // cu, w // cu
    mv = rng.integers(-64, 65, (by, bx, 2)).astype(np.int32)
    py, pcb, pcr = run_on(dev, lambda a, b, c, m: mc_planes(
        a, b, c, m, plan, 8), y, cb, cr, mv)
    bad_y = bad_c = 0
    c2 = cu // 2
    for k in rng.choice(by * bx, min(sample, by * bx), replace=False):
        j, i = divmod(int(k), bx)
        v = tuple(int(a) for a in mv[j, i])
        bad_y += (py[j * cu:(j + 1) * cu, i * cu:(i + 1) * cu]
                  != rm.np_mc_luma(y, i * cu, j * cu, v, cu)).sum()
        for src, pred in ((cb, pcb), (cr, pcr)):
            bad_c += (pred[j * c2:(j + 1) * c2, i * c2:(i + 1) * c2]
                      != rm.np_mc_chroma(src, i * c2, j * c2, v,
                                         c2)).sum()
    return {f"mc luma {w}x{h}": int(bad_y),
            f"mc chroma {w // 2}x{h // 2}": int(bad_c)}


def recon_parity(devs, w: int, h: int, cu: int = 16, batch: int = 8,
                 qp: int = 22, reps: int = 5, seed: int = 5):
    """Wavefront reconstruction (reconstruct_frames, the lax.scan over
    wavefront steps) of the same random frames and modes on every
    device in `devs`.  Returns (bit-identical on all devices, median ms
    per batch on devs[0] over `reps` timed calls, wavefront steps)."""
    from kvazaar_jax.encoder.frame_encoder import chroma_qp
    from kvazaar_jax.encoder.geometry import make_intra_plan
    from kvazaar_jax.encoder.intra_recon import reconstruct_frames
    rng = np.random.default_rng(seed)
    plan = make_intra_plan(w, h, cu)
    ys = rng.integers(0, 256, (batch, h, w)).astype(np.int32)
    cbs = rng.integers(0, 256, (batch, h // 2, w // 2)).astype(np.int32)
    crs = rng.integers(0, 256, (batch, h // 2, w // 2)).astype(np.int32)
    modes = rng.integers(0, 35, (batch, h // cu, w // cu)) \
        .astype(np.int32)
    qp_c = chroma_qp(qp)
    fn = jax.jit(lambda y, cb, cr, m: reconstruct_frames(
        y, cb, cr, m, plan, qp, qp_c, 8))
    outs, ts = [], []
    for i, dev in enumerate(devs):
        args = [jax.device_put(a, dev) for a in (ys, cbs, crs, modes)]
        out = jax.block_until_ready(fn(*args))
        for _ in range(reps if i == 0 else 0):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args))
            ts.append(time.perf_counter() - t0)
        outs.append([np.asarray(o) for o in out if o is not None])
    same = all(len(o) == len(outs[0])
               and all(np.array_equal(a, b) for a, b in zip(o, outs[0]))
               for o in outs[1:])
    return same, 1000.0 * float(np.median(ts)), plan.n_steps
