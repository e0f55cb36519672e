#!/usr/bin/env python
"""Headline benchmark: class-B (1920x1088) all-intra encode frames/s on the
production quadtree+SAO+RDOQ+SBH path (the same encoder the BD-rate claims
use), plus lenslet-ISS encode fps and decode fps. Needs an NVIDIA GPU.

Prints the device (JAX platform, device kind, device count, nvidia-smi's
card name and power limit) on one line, then ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "lenslet_iss_fps": N, "lenslet_iss_vs_baseline": N,
   "decode_fps": N, "decode_vs_baseline": N}

vs_baseline values divide by the reference HM binaries timed on another
host (tests/golden/measured_baseline.json), so they are cross-host ratios.
Set BENCH_SMALL=1 for a quick smoke run (720x512, no extra metrics).
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def card_identity() -> str:
    """nvidia-smi's name and power limit of every card, ';'-joined."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout
    return "; ".join(l.strip() for l in out.splitlines() if l.strip())


def require_gpu() -> str:
    """The device line every result is printed under; exits without a
    GPU (a CPU number is never reported as a device number)."""
    import jax
    d = jax.devices()
    if d[0].platform != "gpu":
        raise SystemExit(f"needs an NVIDIA GPU, JAX found "
                         f"{d[0].platform!r}")
    return (f"device: platform={d[0].platform} kind={d[0].device_kind} "
            f"count={len(d)} card={card_identity()}")


def synth_class_b(w, h, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = (120 + 60 * np.sin(xx / 23.0) * np.cos(yy / 31.0)
         + 25 * np.sin((xx + yy) / 7.0)
         + rng.normal(0, 5, (h, w))).clip(0, 255).astype(np.int32)
    cb = (128 + 30 * np.sin(xx[::2, ::2] / 41.0)).clip(0, 255).astype(np.int32)
    cr = (128 - 28 * np.cos(yy[::2, ::2] / 37.0)).clip(0, 255).astype(np.int32)
    return y, cb, cr


def best_of(fn, reps=3):
    """Best wall time of fn(); fn returns the device arrays its work ends
    in, and the clock stops only after they are ready."""
    import jax
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def main() -> None:
    from hevc_hop_tpu.models.encoder import EncoderConfig, IntraEncoder

    device = require_gpu()
    small = os.environ.get("BENCH_SMALL") == "1"
    w, h = (720, 512) if small else (1920, 1088)
    nfr = 4   # DISTINCT frames, encoded via the pipelined throughput path
    frames = [synth_class_b(w, h, seed=s) for s in range(nfr)]
    enc = IntraEncoder(EncoderConfig(width=w, height=h, qp=32, sao=True))
    enc.encode_frames(frames)  # warm-up/compile every shape bucket
    t_enc = best_of(lambda: (enc.encode_frames(frames),
                             enc._recon_dev)[1]) / nfr
    fps = 1.0 / t_enc
    y, cb, cr = frames[0]

    base_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tests", "golden", "measured_baseline.json")
    with open(base_path) as f:
        base = json.load(f)
    hm_fps = base["hm_intra_1080p_fps"]
    if small:
        hm_fps *= (1920 * 1088) / (w * h)  # HM is ~linear in pixels

    out = {
        "metric": "intra_encode_fps_classB",
        "value": round(fps, 4),
        "unit": "frames/s",
        "vs_baseline": round(fps / hm_fps, 3),
    }

    if not small:
        # lenslet ISS (quadtree + SAO + GT, the flagship holoscopic path)
        from tools.bdrate import lenslet_frame
        from hevc_hop_tpu.models.ss_encoder import HoloConfig, HoloEncoder
        ly, lcb, lcr = lenslet_frame()
        lh, lw = ly.shape
        henc = HoloEncoder(HoloConfig(width=lw, height=lh, qp=32,
                                      mi_size=16, gt=True, search_range=32,
                                      quadtree=True, sao=True))
        henc.encode_frame(ly, lcb, lcr)
        t_ll = best_of(lambda: (henc.encode_frame(ly, lcb, lcr),
                                henc._recon_dev)[1])
        out["lenslet_iss_fps"] = round(1.0 / t_ll, 4)
        out["lenslet_iss_vs_baseline"] = round(
            (1.0 / t_ll) / base["hm_iss_lenslet_fps"], 3)

        # decode fps on the class-B stream
        from hevc_hop_tpu.models.decoder import Decoder
        stream = enc.encode_frame(y, cb, cr)

        def dec_once():
            d = Decoder()
            d.decode_stream(stream)     # returns host pictures
            return d._pics_dev

        dec_once()
        t_dec = best_of(dec_once)
        out["decode_fps"] = round(1.0 / t_dec, 4)
        out["decode_vs_baseline"] = round(
            (1.0 / t_dec) / base["hm_intra_1080p_decode_fps"], 3)

    print(device)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
