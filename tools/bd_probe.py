"""BD-rate decomposition probe (not part of the bench): per-QP
(bits, PSNR) tables for the reference medium all-intra vs several of
our operating points, to locate where the BD gap lives.

Usage: python tools/bd_probe.py [variant ...]
Variants: medium (rd1), rd2, rd2tb (rd2 + percu sweep), fixed16.
"""
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from bench import (synth_clip_natural, _write_yuv, build_reference,
                   run_reference, bd_rate)

W, H, N = 416, 240, 6
QPS = (22, 27, 32, 37)


def run_ours(clip, qps, **cfg_over):
    from kvazaar_jax.api import Encoder
    from kvazaar_jax.config import config_from_preset
    rs, ps = [], []
    for qp in qps:
        cfg = config_from_preset("medium", width=W, height=H, qp=qp,
                                 intra_period=1, **cfg_over)
        enc = Encoder(cfg)
        bits = 0
        psnr = 0.0
        for f in clip:
            (chunks, info, _rec), = enc.encode(*f)
            bits += len(chunks) * 8
            psnr += info.psnr_y
        rs.append(bits / N)
        ps.append(psnr / N)
    return rs, ps


def main():
    variants = sys.argv[1:] or ["medium", "rd2"]
    clip = synth_clip_natural(N, W, H, seed=1)
    yuv = os.path.join(tempfile.gettempdir(), f"bdn_{W}x{H}.yuv")
    if not os.path.exists(yuv):
        _write_yuv(yuv, clip)
    exe = build_reference()
    ref_r, ref_p = [], []
    for qp in QPS:
        rr = run_reference(exe, yuv, W, H,
                           ["--preset", "medium", "-p", "1", "-q", str(qp)])
        ref_r.append(rr[1] / N)
        ref_p.append(rr[2])
    print("ref medium  :", [f"{r/1000:.1f}kb/{p:.2f}dB"
                            for r, p in zip(ref_r, ref_p)])
    over = {
        "medium": {},
        "rd2": dict(rd=2),
        "rd3": dict(rd=3),
        "fixed16": dict(intra_min_cu=16, intra_max_cu=16),
    }
    for v in variants:
        rs, ps = run_ours(clip, QPS, **over[v])
        bd = bd_rate(ref_r, ref_p, rs, ps)
        print(f"ours {v:8s}:", [f"{r/1000:.1f}kb/{p:.2f}dB"
                                for r, p in zip(rs, ps)],
              f" BD={bd:+.2f}%")


if __name__ == "__main__":
    main()
