"""Benchmark: all-intra 832x480 QP22 encode fps (BASELINE.json config #1)
plus the north-star-shaped extras.

Emits the result JSON line INCREMENTALLY: the headline line prints as
soon as config #1 is measured, and an enriched line re-prints after
every completed section — the LAST line printed is the round's record,
so a slow or wedged later section can never zero the artifact (round 3
lost its entire record to one print-at-the-end + a driver timeout).

A hard wall-clock budget (KVZ_BENCH_BUDGET_S, default 480 s) gates each
section: sections that no longer fit are recorded in "skipped".  A
SIGALRM backstop at budget+90 s force-emits and exits 0 even if a
section wedges inside a long device compile.

- vs_baseline compares against the reference kvazaar CLI compiled from
  /root/reference with generic (no-asm) strategies, run on THIS host's
  CPU with all cores (--preset ultrafast -p 1 -q 22), median of runs.
- veryslow_1080p_fps / vs_ref_veryslow_1080p: the north-star operating
  point (BASELINE.md: >= 10x reference veryslow 1080p fps per chip).
- conformance: one benched stream per run is decoded by the in-repo
  oracle (bitstream/decoder.py) and must reconstruct bit-exactly —
  this exercises the lax.scan wavefront reconstruction end-to-end.
- Every emitted line names the device (platform, device_kind, count).
  The bench refuses to run unless JAX's first device is a GPU.
- bd_rate_intra_vs_ref_medium_pct / bd_rate_ippp_vs_ref_medium_pct /
  bd_rate_gop8_vs_ref_medium_pct: Bjontegaard delta-rate of OUR medium
  operating points vs the reference's `--preset medium` over four QPs
  (negative = we need fewer bits at equal PSNR).
"""

import json
import math
import os
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

import kvazaar_jax
kvazaar_jax.enable_compile_cache()

W, H, FRAMES, QP = 832, 480, 8, 22
BUDGET_S = float(os.environ.get("KVZ_BENCH_BUDGET_S", "900"))
# Incremental emission keeps every completed section in the stdout
# tail even if the driver cuts the run early; the SIGALRM backstop
# force-emits and exits 0 at budget+90 s.
# The headline clip is video-like (synth_clip_natural): BASELINE.md
# config #1 names BQMall, a natural sequence.  White-noise synthetics
# distort everything — bits/frame 8x too high, PSNR floors, and a
# degenerate RD curve (see measure_bd_rate_intra).


def synth_clip(n, w, h, seed=0):
    rng = np.random.default_rng(seed)
    frames = []
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n):
        y = np.clip(128 + 60 * np.sin(xx / 9.0 + i * 0.3)
                    * np.cos(yy / 13.0) + rng.normal(0, 6, (h, w)),
                    0, 255).astype(np.uint8)
        cb = np.clip(110 + 30 * np.sin(xx[::2, ::2] / 17.0 + i * 0.2)
                     + rng.normal(0, 3, (h // 2, w // 2)), 0,
                     255).astype(np.uint8)
        cr = np.clip(140 + 25 * np.cos(yy[::2, ::2] / 11.0)
                     + rng.normal(0, 3, (h // 2, w // 2)), 0,
                     255).astype(np.uint8)
        frames.append((y, cb, cr))
    return frames


def synth_clip_natural(n, w, h, seed=0):
    """Video-like synthetic content for RD measurement: smooth
    gradients, moving edges, and spatially-correlated texture (white
    noise gives every encoder a degenerate RD curve — PSNR floors at
    the noise level and BD-rate fits explode)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)

    def blur(a):
        k = np.array([1.0, 4, 6, 4, 1])
        k /= k.sum()
        a = np.apply_along_axis(
            lambda r: np.convolve(r, k, mode="same"), 1, a)
        return np.apply_along_axis(
            lambda c: np.convolve(c, k, mode="same"), 0, a)

    tex = blur(blur(rng.normal(0, 30, (h, w))))
    texc = blur(rng.normal(0, 20, (h // 2, w // 2)))
    frames = []
    for i in range(n):
        dx = 3.1 * i
        dy_ = 1.7 * i
        y = (120 + 55 * np.sin((xx + dx) / 37.0)
             * np.cos((yy + dy_) / 29.0)
             + 25 * ((((xx + 2 * dx) // 64) + ((yy + dy_) // 48)) % 2)
             + np.roll(tex, (int(dy_), int(dx)), (0, 1)))
        cb = (118 + 28 * np.sin((xx[::2, ::2] + dx) / 53.0)
              + np.roll(texc, int(dx) // 2, 1))
        cr = (132 + 24 * np.cos((yy[::2, ::2] + dy_) / 41.0)
              + np.roll(texc, int(dy_) // 2, 0))
        frames.append(tuple(np.clip(p, 0, 255).astype(np.uint8)
                            for p in (y, cb, cr)))
    return frames


def _write_yuv(path, frames):
    with open(path, "wb") as f:
        for y, cb, cr in frames:
            f.write(y.tobytes())
            f.write(cb.tobytes())
            f.write(cr.tobytes())


def build_reference():
    """Build the reference CLI once (generic strategies, -O2)."""
    import glob
    ref = "/root/reference/src"
    if not os.path.isdir(ref):
        return None
    exe = os.path.join(tempfile.gettempdir(), "kvazaar_ref_bench")
    if os.path.exists(exe):
        return exe
    srcs = (glob.glob(f"{ref}/*.c")
            + glob.glob(f"{ref}/strategies/*.c")
            + glob.glob(f"{ref}/strategies/*/*.c")
            + [f"{ref}/extras/libmd5.c"])
    r = subprocess.run(
        ["gcc", "-O2", "-pthread", "-DNDEBUG", f"-I{ref}",
         f"-I{ref}/extras"] + srcs + ["-lm", "-lpthread", "-o", exe],
        capture_output=True, timeout=600)
    return exe if r.returncode == 0 else None


def run_reference(exe, yuv, w, h, args, timeout=600):
    """Run the reference CLI; returns (fps, bits, psnr_y) or None."""
    out_path = os.path.join(tempfile.gettempdir(), "ref_out.hevc")
    out = subprocess.run(
        [exe, "-i", yuv, "--input-res", f"{w}x{h}", "-o", out_path]
        + args, capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        return None
    fps = bits = psnr = None
    for line in out.stderr.splitlines():
        t = line.strip()
        if t.startswith("FPS:"):
            fps = float(t.split(":")[1])
        # " Processed N frames, B bits AVG PSNR Y y U u V v"
        toks = t.split()
        if "PSNR" in toks:
            i = toks.index("PSNR")
            if len(toks) > i + 2 and toks[i + 1] == "Y":
                psnr = float(toks[i + 2])
    if os.path.exists(out_path):
        bits = os.path.getsize(out_path) * 8
    return fps, bits, psnr


def measure_reference_fps(exe, yuv, w, h, qp, reps=5):
    fps = []
    for _ in range(reps):
        r = run_reference(exe, yuv, w, h,
                          ["--preset", "ultrafast", "-p", "1",
                           "-q", str(qp)])
        if r and r[0]:
            fps.append(r[0])
    return sorted(fps)[len(fps) // 2] if fps else None


def _run_pipeline(ife, submit, frames_per_batch, reps, depth=3):
    """Generic 3-stage pipeline: the main thread ONLY dispatches device
    batches (submit()); download workers pull the packed transfer;
    finalize workers run the CABAC stage.  Returns (elapsed_s, results
    list).  Keeping the main thread free of download/finalize work
    keeps downloads and host CABAC from serializing against dispatch."""
    import queue as _q
    import threading
    dlq: "_q.Queue" = _q.Queue(maxsize=depth)
    finq: "_q.Queue" = _q.Queue(maxsize=depth)
    outq: "_q.Queue" = _q.Queue()

    def downloader():
        while True:
            hd = dlq.get()
            if hd is None:
                break
            finq.put(ife.download_frames(hd))

    def finalizer():
        while True:
            dl = finq.get()
            if dl is None:
                break
            outq.put(ife.finalize_downloaded(dl, need_recon=False))

    dls = [threading.Thread(target=downloader) for _ in range(2)]
    fins = [threading.Thread(target=finalizer) for _ in range(2)]
    t0 = time.time()
    for th in dls + fins:
        th.start()
    results = []
    done = submitted = 0
    while done < reps:
        while submitted < reps and submitted - done < depth:
            dlq.put(submit())
            submitted += 1
        results.extend(outq.get())
        done += 1
    dt = time.time() - t0
    for _ in dls:
        dlq.put(None)
    for th in dls:
        th.join()
    for _ in fins:
        finq.put(None)
    for th in fins:
        th.join()
    return dt, results


def measure_intra_fps(frames, w, h, qp, reps=6, ife=None):
    """Pipelined batched all-intra fps (our ultrafast speed point:
    fixed 16 grid).  Three stages overlap: device dispatch+H2D (main
    thread), download + unpack (2 workers), host CABAC (2 finalize
    workers + pool)."""
    from kvazaar_jax.config import Config
    from kvazaar_jax.encoder.frame_encoder import IntraFrameEncoder
    if ife is None:
        cfg = Config(width=w, height=h, qp=qp, intra_max_cu=16,
                     intra_min_cu=16, intra_period=1)
        ife = IntraFrameEncoder(cfg)
    ife.encode_frames(frames)          # warmup/compile
    npix = w * h
    dt, results = _run_pipeline(
        ife, lambda: ife.submit_frames(frames), len(frames), reps)
    total_bits = sum(r.bits for r in results)
    psnr_y = sum(10.0 * math.log10(255.0 * 255.0 * npix
                                   / max(r.sse[0], 1e-9))
                 for r in results)
    nf = reps * len(frames)
    return (nf / dt, total_bits // nf, psnr_y / nf, ife)


def verify_conformance(ife, frames):
    """Decode one benched stream through the oracle; encoder recon
    must equal decoded recon bit-for-bit."""
    from kvazaar_jax.bitstream.decoder import decode_stream
    res = ife.finalize_frames(ife.submit_frames(frames[:1]))
    stream = ife.headers() + b"".join(r.nals for r in res)
    dec = decode_stream(stream, ife.params)
    if len(dec) != len(res):
        return f"MISMATCH:frames {len(dec)} != {len(res)}"
    for k, ((dy, dcb, dcr), _fd) in enumerate(dec):
        r = res[k]
        if not (np.array_equal(dy, r.recon_y)
                and np.array_equal(dcb, r.recon_cb)
                and np.array_equal(dcr, r.recon_cr)):
            return f"MISMATCH:frame {k}"
    return "bit-exact"


def measure_ippp_fps(frames, w, h, qp, warm=6, timed=40):
    """Low-delay IPPP through the pipelined public API."""
    from kvazaar_jax.api import Encoder
    from kvazaar_jax.config import Config
    cfg = Config(width=w, height=h, qp=qp, intra_period=0,
                 intra_max_cu=16, intra_min_cu=16)
    enc = Encoder(cfg)

    def src():
        for i in range(warm + timed):
            yield frames[i % len(frames)]

    t0 = None
    done = 0
    for _res in enc.encode_stream(src()):
        done += 1
        if done == warm:
            t0 = time.time()
    return (done - warm) / max(time.time() - t0, 1e-9)


def bd_rate(rate_a, psnr_a, rate_b, psnr_b):
    """Bjontegaard delta-rate of B vs A (negative: B cheaper at equal
    quality).  Cubic fit of log-rate over PSNR, integrated over the
    overlapping PSNR range."""
    la, lb = np.log10(rate_a), np.log10(rate_b)
    pa = np.polyfit(psnr_a, la, 3)
    pb = np.polyfit(psnr_b, lb, 3)
    lo = max(min(psnr_a), min(psnr_b))
    hi = min(max(psnr_a), max(psnr_b))
    ia = np.polyint(pa)
    ib = np.polyint(pb)
    va = (np.polyval(ia, hi) - np.polyval(ia, lo)) / (hi - lo)
    vb = (np.polyval(ib, hi) - np.polyval(ib, lo)) / (hi - lo)
    return (10 ** (vb - va) - 1) * 100.0


def measure_bd_rate_intra(exe, seed=1, w=416, h=240, n=6,
                          qps=(22, 27, 32, 37)):
    """BD-rate of OUR medium all-intra point vs the reference's
    `--preset medium -p 1` (variable 8..32 trees + rd1 + RDOQ + SAO on
    our side), on video-like structured content."""
    from kvazaar_jax.api import Encoder
    from kvazaar_jax.config import config_from_preset
    clip = synth_clip_natural(n, w, h, seed=seed)
    yuv = os.path.join(tempfile.gettempdir(), f"bdn_{w}x{h}.yuv")
    if not os.path.exists(yuv):
        _write_yuv(yuv, clip)
    ours_r, ours_p, ref_r, ref_p = [], [], [], []
    enc = None
    for qp in qps:
        if enc is None:
            cfg = config_from_preset("medium", width=w, height=h,
                                     qp=qp, intra_period=1)
            enc = Encoder(cfg)
        else:
            enc.set_base_qp(qp)
            enc.reset_stream()
        bits = 0
        psnr = 0.0
        for f in clip:
            (chunks, info, _rec), = enc.encode(*f)
            bits += len(chunks) * 8
            psnr += info.psnr_y
        ours_r.append(bits / n)
        ours_p.append(psnr / n)
        rr = run_reference(exe, yuv, w, h,
                           ["--preset", "medium", "-p", "1",
                            "-q", str(qp)])
        if rr is None or rr[1] is None or rr[2] is None:
            return None
        ref_r.append(rr[1] / n)
        ref_p.append(rr[2])
    return round(bd_rate(ref_r, ref_p, ours_r, ours_p), 2)


def measure_preset_fps_ours(preset, w, h, qp, warm=None, timed=8,
                            seed=4, deadline=None, **cfg_over):
    """Our fps at a full preset operating point (GOP structure, var
    trees, rd level, rdoq/sao as the preset defines) through the
    public API.  The warmup is ONE full pass over the clip: the var
    path compiles one recon program per content-dependent n_steps
    bucket, so warm frames must cover the same trees the timed pass
    re-encodes (frames repeat).  A deadline (absolute time.time())
    stops the timed pass early at a GOP boundary — partial but valid."""
    from kvazaar_jax.api import Encoder
    from kvazaar_jax.config import config_from_preset
    clip = synth_clip_natural(8, w, h, seed=seed)
    cfg = config_from_preset(preset, width=w, height=h, qp=qp,
                             **cfg_over)
    enc = Encoder(cfg)
    g = max(cfg.gop_len, 1)
    if warm is None:
        warm = len(clip)
    if cfg.gop_len > 1:
        # Steady-state GOP throughput: warm through the IDR + one full
        # pyramid flush (covers every compile — the recon schedule is
        # one static depth), then time whole GOPs only — the timed
        # window starts and ends at a flush boundary with an empty
        # reorder buffer, so it covers exactly k*gop_len coded
        # pictures and no partial-GOP tail (the tail is a one-time
        # stream-end cost that a production stream amortizes to zero).
        warm = g + 1
        timed = max(g, (timed // g) * g)
    done = 0
    t0 = None
    fed = 0
    for i in range(warm + timed):
        for _out in enc.encode(*clip[i % len(clip)]):
            pass
        done += 1
        if done == warm:
            from kvazaar_jax.profiler import phases as _ph
            _ph.reset()          # stage table covers the timed window
            t0 = time.time()
        elif (t0 is not None and deadline is not None
                and time.time() > deadline
                and (done - warm) % g == 0
                and done - warm >= 2):
            fed = done - warm
            break
    else:
        fed = timed
    if cfg.gop_len > 1:
        return fed / max(time.time() - t0, 1e-9)
    for _out in enc.flush():
        pass
    return fed / max(time.time() - t0, 1e-9)


def measure_bd_rate_inter(exe, mode, seed=1, w=416, h=240, n=9,
                          qps=(22, 27, 32, 37), deadline=None):
    """BD-rate of OUR medium IPPP / GOP-8 point vs the reference's
    medium at the same structure (the scoreboard for merge-RD and
    B-pyramid layer-QP work — VERDICT r3 #6), on structured content."""
    from kvazaar_jax.api import Encoder
    from kvazaar_jax.config import config_from_preset
    clip = synth_clip_natural(n, w, h, seed=seed)
    yuv = os.path.join(tempfile.gettempdir(), f"bdi_{w}x{h}_{n}.yuv")
    if not os.path.exists(yuv):
        _write_yuv(yuv, clip)
    if mode == "ippp":
        ours_over = dict(intra_period=0, gop_len=1, ref_frames=1)
        ref_args = ["--gop", "0", "-p", "0"]
    else:                                   # gop8 B pyramid
        ours_over = dict(intra_period=0)
        ref_args = ["--gop", "8", "-p", "0"]
    ours_r, ours_p, ref_r, ref_p = [], [], [], []
    enc = None
    for qp in qps:
        if deadline is not None and time.time() > deadline:
            return None
        if enc is None:
            cfg = config_from_preset("medium", width=w, height=h,
                                     qp=qp, **ours_over)
            enc = Encoder(cfg)
        else:
            # QP is traced data on the var path: the same compiled
            # programs serve the whole ladder (a fresh Encoder per QP
            # re-traces and re-loads every program).
            enc.set_base_qp(qp)
            enc.reset_stream()
        bits = 0
        psnr = 0.0
        nout = 0
        for f in clip:
            for chunks, info, _rec in enc.encode(*f):
                bits += len(chunks) * 8
                psnr += info.psnr_y
                nout += 1
        for chunks, info, _rec in enc.flush():
            bits += len(chunks) * 8
            psnr += info.psnr_y
            nout += 1
        ours_r.append(bits / nout)
        ours_p.append(psnr / nout)
        rr = run_reference(exe, yuv, w, h,
                           ["--preset", "medium", "-q", str(qp)]
                           + ref_args)
        if rr is None or rr[1] is None or rr[2] is None:
            return None
        ref_r.append(rr[1] / n)
        ref_p.append(rr[2])
    return round(bd_rate(ref_r, ref_p, ours_r, ours_p), 2)


def measure_preset_fps_ref(exe, preset, w, h, qp, n=10, seed=4,
                           timeout=1800):
    yuv = os.path.join(tempfile.gettempdir(), f"vs_{w}x{h}.yuv")
    if not os.path.exists(yuv):
        _write_yuv(yuv, synth_clip_natural(n, w, h, seed=seed))
    r = run_reference(exe, yuv, w, h,
                      ["--preset", preset, "-q", str(qp)],
                      timeout=timeout)
    return r[0] if r else None


def install_cache_counters():
    """Count persistent-compile-cache hits/misses + load seconds (the
    artifact must show whether a fresh process measured steady state
    or paid compiles)."""
    stats = {"hits": 0, "misses": 0, "load_s": 0.0}
    try:
        from jax._src import compilation_cache as cc
        orig = cc.get_executable_and_time

        def patched(*a, **kw):
            t0 = time.time()
            ex, t = orig(*a, **kw)
            if ex is None:
                stats["misses"] += 1
            else:
                stats["hits"] += 1
                stats["load_s"] += time.time() - t0
            return ex, t

        cc.get_executable_and_time = patched
    except Exception:
        pass
    return stats


class _BudgetUp(Exception):
    pass


def main():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py: needs a GPU; JAX found {dev.platform}")
    t_start = time.time()
    cache_stats = install_cache_counters()
    out = {"metric": "all_intra_832x480_qp22_fps", "unit": "frames/s",
           "platform": dev.platform, "device_kind": dev.device_kind,
           "device_count": len(jax.devices()), "skipped": []}

    def emit():
        out["bench_seconds"] = round(time.time() - t_start, 1)
        out["compile_cache"] = {
            "hits": cache_stats["hits"],
            "misses": cache_stats["misses"],
            "load_s": round(cache_stats["load_s"], 1)}
        print(json.dumps(out), flush=True)

    def remaining():
        return BUDGET_S - (time.time() - t_start)

    # SIGALRM backstop: if a section wedges (e.g. a long device
    # compile), force-emit whatever is measured and exit 0 rather than
    # let the driver's timeout zero the artifact.
    def _alarm(_sig, _frm):
        raise _BudgetUp()
    signal.signal(signal.SIGALRM, _alarm)
    signal.alarm(int(BUDGET_S) + 90)

    def section(name, min_s, fn):
        """Run one bench section if its minimum budget still fits;
        every section ends with a fresh emission of the full record."""
        if remaining() < min_s:
            out["skipped"].append(name)
            emit()
            return
        try:
            fn()
        except _BudgetUp:
            out["skipped"].append(name + ":budget")
            emit()
            raise
        except Exception as e:
            out[name + "_error"] = f"{type(e).__name__}: {e}"[:160]
        emit()

    frames = synth_clip_natural(FRAMES, W, H)
    state = {"ife": None, "exe": None}

    # ---- 1. Headline: config #1 (vs_baseline only when the reference
    # section measures the reference encoder) ----
    def sec_headline():
        trials = []
        for _ in range(3):
            fps, bits, psnr_y, state["ife"] = measure_intra_fps(
                frames, W, H, QP, ife=state["ife"])
            trials.append(fps)
            out["value"] = round(max(trials), 3)
            out["psnr_y_db"] = round(psnr_y, 3)
            out["bits_per_frame"] = int(bits)
            if remaining() < BUDGET_S * 0.6:
                break
        trials.sort()
        out["value"] = round(trials[len(trials) // 2], 3)
        out["fps_trials"] = [round(t, 2) for t in trials]
    section("headline", 0, sec_headline)

    def sec_conformance():
        out["conformance"] = verify_conformance(state["ife"], frames)
    section("conformance", 20, sec_conformance)

    # ---- 2. Reference CLI measured on this box (refines vs_baseline).
    # Reference runs are CPU-only and ours GPU+host CABAC: sequential,
    # never overlapped on this 4-core box. ----
    def sec_reference():
        state["exe"] = build_reference()
        yuv = os.path.join(tempfile.gettempdir(), "bench_nat.yuv")
        if not os.path.exists(yuv):
            _write_yuv(yuv, synth_clip_natural(20, W, H))
        if state["exe"]:
            ref = measure_reference_fps(state["exe"], yuv, W, H, QP,
                                        reps=3)
            if ref:
                out["ref_fps"] = round(ref, 3)
                out["ref_fps_source"] = "measured"
                out["vs_baseline"] = round(out["value"] / ref, 4)
    section("reference", 60, sec_reference)
    exe = state["exe"]

    # ---- 3. BD-rates vs reference medium (the quality scoreboard;
    # runs BEFORE veryslow so a slow veryslow warm-up can never starve
    # it out of the artifact again — VERDICT r4 weak #2) ----
    if os.environ.get("KVZ_BENCH_BD", "1") != "0" and exe:
        def sec_bd_ippp():
            bd = measure_bd_rate_inter(
                exe, "ippp", deadline=t_start + BUDGET_S - 20)
            if bd is not None:
                out["bd_rate_ippp_vs_ref_medium_pct"] = bd
        section("bd_ippp", 120, sec_bd_ippp)

        def sec_bd_gop8():
            bd = measure_bd_rate_inter(
                exe, "gop8", deadline=t_start + BUDGET_S - 20)
            if bd is not None:
                out["bd_rate_gop8_vs_ref_medium_pct"] = bd
        section("bd_gop8", 120, sec_bd_gop8)

    # ---- 4. North star: veryslow 1080p, ours vs reference ----
    if os.environ.get("KVZ_BENCH_VERYSLOW", "1") != "0":
        def sec_veryslow():
            vw, vh = 1920, 1080
            if exe:
                rv = measure_preset_fps_ref(
                    exe, "veryslow", vw, vh, 27, n=4,
                    timeout=max(min(remaining() * 0.35, 600), 60))
                if rv:
                    out["ref_veryslow_1080p_fps"] = round(rv, 3)
                    emit()
            from kvazaar_jax.profiler import phases
            phases.reset()
            ov = measure_preset_fps_ours(
                "veryslow", vw, vh, 27, timed=8,
                deadline=t_start + BUDGET_S - 15)
            out["veryslow_1080p_fps"] = round(ov, 3)
            # Per-stage wall budget over the timed window (seconds
            # total + per call): gop.submit_* is the serial main-thread
            # device dispatch; gop.wait is finalize time NOT hidden by
            # the overlap worker; varb.* nest inside those.
            out["veryslow_stages"] = {
                k: [round(s, 2), c, round(1000 * s / max(c, 1))]
                for k, (s, c) in sorted(
                    phases.as_dict().items(),
                    key=lambda kv: -kv[1][0])}
            if out.get("ref_veryslow_1080p_fps"):
                out["vs_ref_veryslow_1080p"] = round(
                    ov / out["ref_veryslow_1080p_fps"], 2)
        section("veryslow_1080p", 150, sec_veryslow)

    if os.environ.get("KVZ_BENCH_BD", "1") != "0" and exe:
        def sec_bd_intra():
            bd = measure_bd_rate_intra(exe)
            if bd is not None:
                out["bd_rate_intra_vs_ref_medium_pct"] = bd
        section("bd_intra", 100, sec_bd_intra)

    # ---- 5. Throughput extras at the headline point ----
    def sec_ippp():
        out["ippp_fps"] = round(measure_ippp_fps(frames, W, H, QP), 3)
    section("ippp", 60, sec_ippp)

    # ---- 6. 1080p all-intra + IPPP ----
    def sec_1080p():
        w2, h2 = 1920, 1080
        frames2 = synth_clip_natural(4, w2, h2, seed=2)
        fps2, _b2, _p2, _ife2 = measure_intra_fps(frames2, w2, h2, QP,
                                                  reps=4)
        out["intra_1080p_fps"] = round(fps2, 3)
        emit()
        if exe and remaining() > 60:
            yuv2 = os.path.join(tempfile.gettempdir(),
                                "bench_nat1080.yuv")
            if not os.path.exists(yuv2):
                _write_yuv(yuv2, synth_clip_natural(12, w2, h2, seed=2))
            r2 = measure_reference_fps(exe, yuv2, w2, h2, QP, reps=3)
            if r2:
                out["ref_1080p_fps"] = round(r2, 3)
                out["vs_baseline_1080p"] = round(fps2 / r2, 4)
        if remaining() > 60:
            out["ippp_1080p_fps"] = round(
                measure_ippp_fps(frames2, w2, h2, QP, warm=4,
                                 timed=16), 3)
    section("intra_1080p", 120, sec_1080p)

    signal.alarm(0)
    emit()
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except _BudgetUp:
        sys.exit(0)
