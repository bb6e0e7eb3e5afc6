"""On-chip smoke test: the encoder's main path on an NVIDIA GPU.

    python chip_smoke.py              # phases a-e on one GPU
    python chip_smoke.py --four-gpus  # phase f alone, on four GPUs

a. Device: refuse anything but a GPU; print the card's name and power
   limit, the JAX version and the compile-cache directory.
b. Exact device ops against host integer references at deployment
   widths, tolerance 0 (kvazaar_jax.devcheck).
c. Wavefront reconstruction at 832x480, CU16, batch 8 on the GPU and on
   the host CPU backend: bit-identical; device time per batch and per
   wavefront step, and its share of the all-intra device step.
d. Main path through kvazaar_jax.api.Encoder with --hash md5:
   (i) all-intra 832x480 QP22 CU16, 8 frames (BASELINE.json config #1);
   (ii) 1920x1080 --preset medium GOP-8 QP27, 17 frames (IDR + two
   GOPs).
   Each stream decodes through bitstream/decoder.py bit-exactly to the
   encoder's recon with every MD5 SEI verified, and every picture went
   through the native CABAC library.
e. The CLI at 416x240, 3 frames, all-intra and IPPP, on the GPU and in
   a CPU-only child process: both decode; byte identity is reported.

The oracle decodes of d and the CPU encodes of e run in child processes
held to the CPU backend (they never open the card), beside the GPU
phases; the GPU phases run in the order d, b, c, e.
f. (--four-gpus) mesh_tiles=4 encode against the single-device tiled
   encode, sharded deblock and band-sharded P search against one device.

Every phase raises on failure.  The last stdout line, printed only when
every phase passed, is {"ok": true, "device": {...}}.
"""

import argparse
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
T0 = time.time()


def log(phase, msg, **kv):
    extra = " ".join(f"{k}={v}" for k, v in kv.items())
    print(f"[{phase} +{time.time() - T0:.0f}s] {msg} {extra}".rstrip(),
          flush=True)


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def nal_types(stream: bytes):
    """NAL unit types of an Annex-B stream in order."""
    out = []
    i = stream.find(b"\x00\x00\x01")
    while i >= 0:
        out.append((stream[i + 3] >> 1) & 0x3F)
        i = stream.find(b"\x00\x00\x01", i + 3)
    return out


def check_hashes_decode(stream: bytes, params, n_pics: int, tag: str):
    """Decode with the in-repo oracle (which raises on a picture-hash
    mismatch) and require one verified hash SEI per picture."""
    from kvazaar_jax.bitstream.decoder import decode_stream
    n_sei = nal_types(stream).count(40)
    if n_sei != n_pics:
        raise AssertionError(f"{tag}: {n_sei} hash SEIs for {n_pics} "
                             "pictures")
    dec = decode_stream(stream, params)
    if len(dec) != n_pics:
        raise AssertionError(f"{tag}: decoded {len(dec)} of {n_pics}")
    return dec


class CompileClock:
    """Sums JAX's own compile-duration events (tracing, lowering,
    backend compile) so compile time is reported apart from run time."""

    EVENTS = ("/jax/core/compile/backend_compile_duration",
              "/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration")

    def __init__(self):
        import jax
        self.seconds = 0.0
        self.compiles = 0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, secs, **_):
        if event in self.EVENTS:
            self.seconds += secs
            self.compiles += event == self.EVENTS[0]

    def snapshot(self):
        return self.seconds, self.compiles


class NativeCounter:
    """Counts pictures serialized by the native CABAC library."""

    NAMES = ("encode_slice_data_native", "encode_slice_data_native_wpp",
             "encode_slice_data_native_p")

    def __init__(self):
        from kvazaar_jax.bitstream import native
        native.get_lib()
        self.calls = 0
        for name in self.NAMES:
            fn = getattr(native, name)
            setattr(native, name, self._wrap(fn))

    def _wrap(self, fn):
        def counted(*a, **kw):
            self.calls += 1
            return fn(*a, **kw)
        return counted


# ---- a. device ----

def phase_device(n_needed: int):
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU; JAX found "
                         f"{devs[0].platform}")
    if len(devs) < n_needed:
        raise SystemExit(f"chip_smoke: needs {n_needed} GPUs, found "
                         f"{len(devs)}")
    import kvazaar_jax
    kvazaar_jax.enable_compile_cache()
    card = card_line()
    log("a", "device", card=repr(card), kind=repr(devs[0].device_kind),
        count=len(devs), jax=jax.__version__,
        cache=kvazaar_jax.compile_cache_dir())
    return devs, card


# ---- b. exact ops ----

def phase_exact(dev, w=1920, h=1088):
    from kvazaar_jax import devcheck as dc
    t0 = time.time()
    res = {}
    res.update(dc.einsum_mismatches(dev, batch=w * h // 1024))
    res.update(dc.transform_mismatches(dev, pixels=w * h))
    res.update(dc.intra_mismatches(dev, pixels=w * h))
    res.update(dc.sad_mismatches(dev, w, h, radius=16, size=16))
    res.update(dc.mc_mismatches(dev, w, h, cu=16, sample=32))
    bad = {k: v for k, v in res.items() if v}
    for k, v in res.items():
        log("b", k, mismatches=v)
    if bad:
        raise AssertionError(f"exact ops mismatch: {bad}")
    log("b", "all exact", cases=len(res), seconds=round(time.time() - t0, 1))


# ---- c. wavefront recon ----

def phase_recon(dev, w=832, h=480, cu=16, batch=8):
    import jax

    from kvazaar_jax import devcheck as dc
    from kvazaar_jax.config import Config
    from kvazaar_jax.encoder.frame_encoder import IntraFrameEncoder
    try:
        cpu = jax.devices("cpu")[0]
    except RuntimeError as e:
        raise SystemExit(f"chip_smoke: phase c needs the CPU backend "
                         f"beside the GPU ({e})")
    same, ms, steps = dc.recon_parity([dev, cpu], w, h, cu, batch)
    log("c", "reconstruct_frames", size=f"{w}x{h}", cu=cu, batch=batch,
        steps=steps, gpu_ms_per_batch=round(ms, 3),
        gpu_ms_per_step=round(ms / steps, 4), bit_identical_to_cpu=same)
    if not same:
        raise AssertionError("wavefront recon differs between GPU and CPU")
    # The whole all-intra device step at the same shape (search +
    # recon + deblock + packing), for the scan's share of it.
    import bench
    ife = IntraFrameEncoder(Config(width=w, height=h, qp=22,
                                   intra_max_cu=cu, intra_min_cu=cu,
                                   intra_period=1))
    buf, _ = ife.host_pack_sources(bench.synth_clip_natural(batch, w, h))
    dbuf = jax.device_put(buf, dev)
    jax.block_until_ready(ife._device_encode_batch(dbuf))
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(ife._device_encode_batch(dbuf))
        ts.append(time.perf_counter() - t0)
    step_ms = 1000.0 * float(np.median(ts))
    log("c", "all-intra device step", ms_per_batch=round(step_ms, 3),
        recon_share=round(ms / step_ms, 3))


# ---- CPU-only children ----

class CpuChild:
    """A child process held to the CPU backend.  It never opens the
    card, so it runs beside this process's GPU work."""

    live = []

    def __init__(self, tag, argv, tmp):
        self.tag = tag
        self.out = open(os.path.join(tmp, tag.replace(" ", "_") + ".log"),
                        "w+")
        env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
        self.proc = subprocess.Popen([sys.executable] + argv, env=env,
                                     cwd=ROOT, stdout=self.out,
                                     stderr=subprocess.STDOUT, text=True)
        CpuChild.live.append(self)

    def join(self) -> str:
        rc = self.proc.wait()
        self.out.seek(0)
        text = self.out.read()
        if rc:
            raise RuntimeError(f"{self.tag}: CPU child failed (rc {rc}):"
                               f"\n{text[-3000:]}")
        return text

    @classmethod
    def stop_all(cls):
        for c in cls.live:
            if c.proc.poll() is None:
                c.proc.kill()
                c.proc.wait()


def decode_check(path):
    """Child side of phase d: decode the pickled stream with the oracle
    and compare every picture with the encoder's recon."""
    with open(path, "rb") as f:
        job = pickle.load(f)
    dec = check_hashes_decode(job["stream"], job["params"],
                              len(job["recons"]), job["tag"])
    for k, (planes, _fd) in enumerate(dec):
        for d, r in zip(planes, job["recons"][k]):
            # Decoded planes carry the coded size; recon the source's.
            if not np.array_equal(d[:r.shape[0], :r.shape[1]], r):
                raise AssertionError(f"{job['tag']}: decode != recon, "
                                     f"picture {k}")


# ---- d. main path ----

def encode_verify(cfg, frames, tag, card, clock, counter, tmp):
    """Encode twice through Encoder.encode_stream (as the CLI drives it):
    a cold pass that compiles, then a warm pass on the same encoder.
    The cold pass's stream is decoded in a CPU child; returns a
    function that joins it and reports."""
    import jax

    from kvazaar_jax.api import Encoder
    enc = Encoder(cfg)
    c0, k0 = clock.snapshot()
    n0 = counter.calls
    t0 = time.perf_counter()
    out = list(enc.encode_stream(iter(frames), need_recon=True))
    cold = time.perf_counter() - t0
    c1, k1 = clock.snapshot()
    if len(out) != len(frames):
        raise AssertionError(f"{tag}: {len(out)} of {len(frames)} out")
    if counter.calls - n0 != len(frames):
        raise AssertionError(f"{tag}: native CABAC serialized "
                             f"{counter.calls - n0} of {len(frames)}")
    job = os.path.join(tmp, tag.replace(" ", "_") + ".pkl")
    with open(job, "wb") as f:
        pickle.dump(dict(tag=tag, stream=b"".join(c for c, _, _ in out),
                         params=enc._intra.params,
                         recons=[r for _, _, r in out]), f)
    child = CpuChild(f"decode {tag}", ["-c", "import chip_smoke; "
                                       f"chip_smoke.decode_check({job!r})"],
                     tmp)
    bits = np.mean([i.bits for _, i, _ in out])
    psnr = np.mean([i.psnr_y for _, i, _ in out])
    enc.reset_stream()
    t0 = time.perf_counter()
    for _ in enc.encode_stream(iter(frames)):
        pass
    warm = time.perf_counter() - t0
    _, k2 = clock.snapshot()
    peak = (jax.devices()[0].memory_stats() or {}).get(
        "peak_bytes_in_use")
    log("d", tag, frames=len(frames), bits_per_frame=round(float(bits)),
        psnr_y=round(float(psnr), 3), native_cabac="all pictures",
        compile_s=round(c1 - c0, 1), compiles=k1 - k0,
        cold_pass_s=round(cold, 1), warm_pass_s=round(warm, 2),
        warm_compiles=k2 - k1, peak_bytes_in_use=peak)
    log("d", f"{tag} unclaimed first reading",
        fps=round(len(frames) / warm, 2), card=repr(card))

    def finish():
        t = time.perf_counter()
        child.join()
        log("d", f"{tag} decode", result="bit-exact to recon",
            md5_sei="verified", waited_s=round(time.perf_counter() - t, 1))
    return finish


def phase_main(card, clock, counter, tmp):
    import bench
    from kvazaar_jax.config import Config, config_from_preset
    w, h = 832, 480
    cfg = Config(width=w, height=h, qp=22, intra_max_cu=16,
                 intra_min_cu=16, intra_period=1, hash="md5")
    pending = [encode_verify(cfg, bench.synth_clip_natural(8, w, h),
                             "all-intra 832x480 QP22 CU16", card, clock,
                             counter, tmp)]
    w, h = 1920, 1080
    cfg = config_from_preset("medium", width=w, height=h, qp=27,
                             hash="md5")
    pending.append(encode_verify(
        cfg, bench.synth_clip_natural(17, w, h, seed=4),
        "medium GOP-8 1920x1080 QP27", card, clock, counter, tmp))
    return pending


# ---- e. CLI on the GPU and on the CPU ----

E_W, E_H, E_N = 416, 240, 3
E_RUNS = (("all-intra", ["-p", "1"]), ("IPPP", ["-p", "0", "--gop", "0"]))


def _cli_argv(tmp, extra):
    return ["-i", os.path.join(tmp, "e.yuv"), "--input-res",
            f"{E_W}x{E_H}", "--qp", "27", "--hash", "md5",
            "--no-psnr"] + extra


def start_cli_cpu(tmp):
    """Write the clip and start the CPU-side CLI encodes."""
    import bench
    bench._write_yuv(os.path.join(tmp, "e.yuv"),
                     bench.synth_clip_natural(E_N, E_W, E_H, seed=7))
    return [CpuChild(f"CLI {tag} cpu",
                     ["-m", "kvazaar_jax"] + _cli_argv(tmp, extra)
                     + ["-o", os.path.join(tmp, f"{tag}.cpu.hevc")], tmp)
            for tag, extra in E_RUNS]


def finish_cli(tmp, children):
    """Run the same CLI encodes on the GPU, then decode all streams."""
    from kvazaar_jax import cli
    from kvazaar_jax.api import Encoder
    for (tag, extra), child in zip(E_RUNS, children):
        argv = _cli_argv(tmp, extra)
        gpu_out = os.path.join(tmp, f"{tag}.gpu.hevc")
        cli.main(argv + ["-o", gpu_out])
        child.join()
        streams = [open(os.path.join(tmp, f"{tag}.{w}.hevc"), "rb").read()
                   for w in ("gpu", "cpu")]
        cfg = cli.config_from_args(cli.build_argparser().parse_args(
            argv + ["-o", gpu_out]))
        params = Encoder(cfg)._intra.params
        for s, where in zip(streams, ("gpu", "cpu")):
            check_hashes_decode(s, params, E_N, f"{tag} {where}")
        log("e", f"CLI {tag} {E_W}x{E_H} x{E_N}",
            decode="md5 verified (both)", gpu_bytes=len(streams[0]),
            cpu_bytes=len(streams[1]),
            byte_identical=streams[0] == streams[1])


# ---- f. four GPUs ----

def phase_four(devs, w=1920, h=1024):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import bench
    from kvazaar_jax.api import Encoder
    from kvazaar_jax.config import Config
    from kvazaar_jax.ops.deblock import deblock_frame
    from kvazaar_jax.parallel.sharding import (deblock_frame_sharded,
                                               p_search_mc_bands_sharded)
    # mesh_tiles bands need h % (4 * 64) == 0: 1920x1024 is the
    # 1080p-class frame the band constraint admits.
    n = 4
    y, cb, cr = bench.synth_clip_natural(1, w, h, seed=8)[0]
    nals = []
    for tiles in (dict(mesh_tiles=n), dict(tiles_y=n)):
        enc = Encoder(Config(width=w, height=h, qp=27, intra_max_cu=16,
                             intra_min_cu=16, intra_period=1, **tiles))
        nals.append(b"".join(c for c, _, _ in enc.encode(y, cb, cr)))
    if nals[0] != nals[1]:
        raise AssertionError("mesh_tiles=4 stream differs from the "
                             "single-device tiled stream")
    log("f", f"mesh_tiles=4 intra {w}x{h}", bytes=len(nals[0]),
        byte_identical=True)
    mesh4 = Mesh(np.array(devs[:n]), ("rows",))
    mesh1 = Mesh(np.array(devs[:1]), ("rows",))
    fy, fcb, fcr = (jnp.asarray(p.astype(np.int32)) for p in (y, cb, cr))
    ref = [np.asarray(p) for p in deblock_frame(fy, fcb, fcr, 27, 16)]
    for m, tag in ((mesh4, "4-way"), (mesh1, "1-way")):
        got = jax.jit(lambda a, b, c: deblock_frame_sharded(
            a, b, c, 27, 16, m))(fy, fcb, fcr)
        if not all(np.array_equal(np.asarray(g), r)
                   for g, r in zip(got, ref)):
            raise AssertionError(f"{tag} sharded deblock differs")
    log("f", f"deblock_frame_sharded {w}x{h}", equal_to="deblock_frame")
    y2 = bench.synth_clip_natural(2, w, h, seed=9)
    cur = jnp.asarray(y2[1][0].astype(np.int32))
    prev = jnp.asarray(y2[0][0].astype(np.int32))
    res = [jax.tree.map(np.asarray, jax.jit(
        lambda a, b, m=m: p_search_mc_bands_sharded(
            a, b, m, cu=16, me_range=16, lambda_satd=20.0))(cur, prev))
        for m in (mesh4, mesh1)]
    if not (np.array_equal(res[0][0], res[1][0])
            and np.array_equal(res[0][1], res[1][1])):
        raise AssertionError("4-way band-sharded P search differs")
    log("f", f"p_search_mc_bands_sharded {w}x{h}",
        equal_to="1-device mesh")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run phase f (four GPUs) and nothing else")
    args = ap.parse_args(argv)
    t0 = time.time()
    devs, card = phase_device(4 if args.four_gpus else 1)
    if args.four_gpus:
        phase_four(devs)
    else:
        # CPU-side work (the CPU CLI encodes, the oracle decodes) runs
        # in children beside the GPU phases.
        clock = CompileClock()
        counter = NativeCounter()
        with tempfile.TemporaryDirectory() as tmp:
            try:
                e_children = start_cli_cpu(tmp)
                pending = phase_main(card, clock, counter, tmp)
                phase_exact(devs[0])
                phase_recon(devs[0])
                finish_cli(tmp, e_children)
                for finish in pending:
                    finish()
            finally:
                CpuChild.stop_all()
    log("done", "all phases passed", seconds=round(time.time() - t0, 1))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
