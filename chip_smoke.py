#!/usr/bin/env python
"""Bring-up smoke test of the codec's main path on one NVIDIA GPU.

    python chip_smoke.py [--seed N]      # phases 0-5 on one card
    python chip_smoke.py --four-cards    # only the 4-card mesh encode

Phases (each prints one line: wall time, compile time, peak device bytes,
card name and power limit; any failure raises and the exit code is non-0):

  0  set-up: refuse anything but a GPU; build the native CABAC library
     from the tracked sources
  1  class-B 1920x1088 all-intra encode + decode of 2 frames through the
     CLI (cfg/encoder_intra_main.cfg): hashes verify, decoded == recon
  2  determinism: the same encode again, byte-identical streams
  3  lenslet ISS + PSS through the CLI (cfg/3DHencoder_intra_main.cfg):
     hashes verify, decoded == recon
  4  exactness at real widths: HM transform / GT-warp goldens; batched
     transforms and SATD over every TU of a class-B frame against NumPy
     int64; the SS/temporal search SSE map against exact NumPy SSE
  5  cross-backend: streams encoded on the process's CPU backend decode
     bit-exactly on the GPU; whether the GPU's own encode of the same
     frame matches is reported, not required

The last line of stdout is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

# XLA:CPU (phase 5) splits codegen over pool threads with small stacks; the
# wavefront scan programs overflow them, so codegen runs on the calling
# thread, which gets a large stack below (main()).
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_cpu_parallel_codegen_split_count=1"
                           ).strip()

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
CLASS_B = (1920, 1088)
LENSLET = (512, 384)
SMALL = (256, 128)

_compile_s = [0.0]


def _on_event(event: str, duration: float, **_) -> None:
    if event == "/jax/core/compile/backend_compile_duration":
        _compile_s[0] += duration


class Phase:
    """Times one phase and prints its line; never swallows a failure."""

    card = "unknown"

    def __init__(self, name: str) -> None:
        self.name = name
        self.info: dict = {}

    def __enter__(self):
        self._t0 = time.perf_counter()
        self._c0 = _compile_s[0]
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            print(f"phase {self.name}: FAILED ({exc_type.__name__}: {exc})",
                  flush=True)
            return False
        stats = jax.devices()[0].memory_stats() or {}
        rec = {"wall_s": round(time.perf_counter() - self._t0, 3),
               "compile_s": round(_compile_s[0] - self._c0, 3),
               "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
               "card": Phase.card, **self.info}
        print(f"phase {self.name}: ok {json.dumps(rec)}", flush=True)
        return False


def _write_yuv(path, frames):
    from hevc_hop_tpu.io import yuv as yuvio
    yuvio.write_yuv420(path, frames)


def _cli(argv):
    """cli.main in-process; its chatter goes to a buffer, rc must be 0."""
    from hevc_hop_tpu.utils import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise RuntimeError(f"cli {argv[0]} rc={rc}: {buf.getvalue()[-400:]}")
    return buf.getvalue()


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _decode_check(stream: bytes, nframes: int):
    """Library decode: every picture hash must verify."""
    from hevc_hop_tpu.models.decoder import Decoder
    d = Decoder()
    pics = d.decode_stream(stream)
    if len(pics) != nframes or d.hash_ok != [True] * nframes:
        raise AssertionError(f"decoded {len(pics)} pictures, "
                             f"hash_ok={d.hash_ok}")
    return d


# ---------------------------------------------------------------- phases
def phase_setup() -> None:
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: needs an NVIDIA GPU, JAX found "
                         f"{dev.platform!r} ({dev.device_kind}); no CPU "
                         f"fallback")
    # a library copied from another machine is never used
    subprocess.run(["make", "-B", "-s", "-C",
                    os.path.join(ROOT, "hevc_hop_tpu", "native")],
                   check=True)
    from bench import card_identity
    Phase.card = card_identity()
    print(f"card: {Phase.card}", flush=True)


def phase_cli_roundtrip(tmp, tag, cfg_name, frames, w, h):
    """CLI encode -> CLI decode: returns (stream, recon bytes)."""
    src = os.path.join(tmp, f"{tag}.yuv")
    bs = os.path.join(tmp, f"{tag}.bin")
    rec = os.path.join(tmp, f"{tag}_rec.yuv")
    dec = os.path.join(tmp, f"{tag}_dec.yuv")
    _write_yuv(src, frames)
    _cli(["encode", "-c", os.path.join(ROOT, "cfg", cfg_name), "-i", src,
          "-b", bs, "-o", rec, "-wdt", str(w), "-hgt", str(h),
          "-f", str(len(frames))])
    _cli(["decode", "-b", bs, "-o", dec])
    stream, rec_b, dec_b = _read(bs), _read(rec), _read(dec)
    if dec_b != rec_b:
        raise AssertionError(f"{tag}: decoded YUV != encoder recon")
    fsz = len(rec_b) // len(frames)
    if len(frames) > 1 and rec_b[:fsz] == rec_b[fsz:2 * fsz]:
        raise AssertionError(f"{tag}: recon frames 0 and 1 are identical")
    _decode_check(stream, len(frames))
    return stream, rec_b


def class_b_frames(seed, w, h, n=2):
    from bench import synth_class_b
    return [synth_class_b(w, h, seed=seed + i) for i in range(n)]


def lenslet_frames(seed, w, h, n=2):
    from tools.bdrate import lenslet_frame
    return [lenslet_frame(w, h, mi=16, seed=seed + i) for i in range(n)]


# ------------------------------------------------- phase 4: exactness
def _np_fwd(resi, t, bd):
    n = resi.shape[-1]
    s1, s2 = n.bit_length() - 1 + bd - 9, n.bit_length() - 1 + 6
    tmp = (resi @ t.T + (1 << (s1 - 1))) >> s1
    return (t @ tmp + (1 << (s2 - 1))) >> s2


def _np_inv(coef, t, bd):
    s2 = 20 - bd
    e = np.clip((t.T @ coef + 64) >> 7, -32768, 32767)
    return np.clip((e @ t + (1 << (s2 - 1))) >> s2, -32768, 32767)


def _np_satd(a, b):
    n = a.shape[-1]
    k = 8 if n >= 8 else 4
    hm = np.array([[1]], np.int64)
    while hm.shape[0] < k:
        hm = np.block([[hm, hm], [hm, -hm]])
    d = (a - b).reshape(-1, n // k, k, n // k, k).swapaxes(-3, -2)
    s = np.abs(hm @ d @ hm).sum(axis=(-1, -2))
    s = (s + 2) >> 2 if k == 8 else (s + 1) >> 1
    return s.sum(axis=(-1, -2))


def _tiles(plane, n):
    h, w = plane.shape
    return (plane.reshape(h // n, n, w // n, n).swapaxes(1, 2)
            .reshape(-1, n, n))


def lowering(fn, *args) -> str:
    """How XLA lowered a jitted op: library calls and fusion kinds in the
    optimised HLO."""
    import re
    txt = jax.jit(fn).lower(*args).compile().as_text()
    calls = re.findall(r'custom_call_target="([^"]+)"', txt)
    kinds = re.findall(r"kind=(k\w+)", txt)
    parts = [f"{c}x{calls.count(c)}" for c in sorted(set(calls))]
    parts += [f"{k}x{kinds.count(k)}" for k in sorted(set(kinds))]
    return ",".join(parts) or "none"


def check_goldens(info):
    from hevc_hop_tpu.ops import transform, warp
    with open(os.path.join(ROOT, "tests", "golden", "hm_golden.json")) as f:
        g = json.load(f)
    for case in g["transforms"]:
        n, bd, dst = case["n"], case["bd"], bool(case["dst"])
        resi = jnp.asarray(np.array(case["resi"], np.int32).reshape(1, n, n))
        cin = jnp.asarray(np.array(case["coeff_in"], np.int32)
                          .reshape(1, n, n))
        fw = np.asarray(transform.fwd_transform(resi, bd, dst)).ravel()
        iv = np.asarray(transform.inv_transform(cin, bd, dst)).ravel()
        if (fw != case["coeff"]).any() or (iv != case["resi_out"]).any():
            raise AssertionError(f"HM transform golden n={n} bd={bd} "
                                 f"dst={dst} differs")
    cpu = jax.devices("cpu")[0]
    knife = 0
    for case in g["gt_warp"]:
        n = case["n"]
        gtv = np.array(case["gt"], np.int32).reshape(1, 4, 2)
        win = np.array(case["win"], np.int32).reshape(1, 2 * n, 2 * n)
        out, safe = warp.warp_blocks(jnp.asarray(win), jnp.asarray(gtv), n)
        with jax.default_device(cpu):
            ref_out, _ = warp.warp_blocks(jnp.asarray(win),
                                          jnp.asarray(gtv), n)
        out = np.asarray(out)[0]
        if (out != np.asarray(ref_out)[0]).any():
            raise AssertionError(f"GT warp n={n}: GPU != CPU")
        gold = np.array(case["dst"]).reshape(n, n)
        if bool(safe[0]):
            if (out != gold).any():
                raise AssertionError(f"GT warp golden n={n} differs")
        else:
            # knife-edge block: HM's float64 may round either way
            knife += 1
            if np.abs(out - gold).max() > 1:
                raise AssertionError(f"GT warp knife-edge n={n} off by >1")
    info["hm_transform_cases"] = len(g["transforms"])
    info["gt_warp_cases"] = len(g["gt_warp"])
    info["gt_warp_knife_edge"] = knife


def check_batched_transforms(info, y, y2):
    """Every 4/8/16/32 TU of a frame through fwd/inv transform and SATD,
    against NumPy int64: exactly equal (normative or decision-exact
    integers)."""
    from hevc_hop_tpu.common import rom
    from hevc_hop_tpu.ops import intra, transform
    rng = np.random.default_rng(0)
    for n in (4, 8, 16, 32):
        org = _tiles(y.astype(np.int64), n)
        ref = _tiles(y2.astype(np.int64), n)
        resi = org - ref
        for dst in ((False, True) if n == 4 else (False,)):
            t = (rom.DST4 if dst else rom.dct_matrix(n)).astype(np.int64)
            fwd = jax.jit(lambda r, d=dst: transform.fwd_transform(r, 8, d))
            inv = jax.jit(lambda c, d=dst: transform.inv_transform(c, 8, d))
            coef = np.asarray(fwd(jnp.asarray(resi, jnp.int32)))
            if (coef != _np_fwd(resi, t, 8)).any():
                raise AssertionError(f"fwd_transform n={n} dst={dst}")
            # the frame's own coefficients, then full-range 16-bit input
            # (second-stage partial sums beyond 2^24)
            for c in (coef.astype(np.int64),
                      rng.integers(-32768, 32768, coef.shape)):
                got = np.asarray(inv(jnp.asarray(c, jnp.int32)))
                if (got != _np_inv(c, t, 8)).any():
                    raise AssertionError(f"inv_transform n={n} dst={dst}")
        got = np.asarray(jax.jit(intra.satd)(jnp.asarray(org, jnp.int32),
                                             jnp.asarray(ref, jnp.int32)))
        if (got != _np_satd(org, ref)).any():
            raise AssertionError(f"satd n={n}")
        info[f"tus_{n}"] = int(org.shape[0])
        if n == 32:
            r32 = jnp.asarray(resi, jnp.int32)
            info["lowering_fwd32"] = lowering(
                lambda r: transform.fwd_transform(r, 8), r32)
            info["lowering_inv32"] = lowering(
                lambda c: transform.inv_transform(c, 8), r32)
            info["lowering_satd32"] = lowering(intra.satd, r32, r32)


def np_sse(win, org):
    """Exact int64 SSE of every displacement (the reference for
    ss_scan.sse_map)."""
    from numpy.lib.stride_tricks import sliding_window_view
    n = org.shape[-1]
    out = []
    for wv, ov in zip(win.astype(np.int64), org.astype(np.int64)):
        d = sliding_window_view(wv, (n, n)) - ov
        out.append(np.einsum("ijkl,ijkl->ij", d, d))
    return np.stack(out)


def check_sse(info, ref_plane, org_plane, nblk=64, radius=32):
    """SS/temporal search SSE map at n = 8, 16, 32 against exact SSE."""
    from numpy.lib.stride_tricks import sliding_window_view
    from hevc_hop_tpu.models import ss_scan
    h, w = ref_plane.shape
    rng = np.random.default_rng(1)
    fn = jax.jit(ss_scan.sse_map)
    for n in (8, 16, 32):
        ys = rng.integers(radius, h - n - radius, nblk)
        xs = rng.integers(radius, w - n - radius, nblk)
        wsz = n + 2 * radius
        win = np.stack([ref_plane[y - radius:y - radius + wsz,
                                  x - radius:x - radius + wsz]
                        for y, x in zip(ys, xs)]).astype(np.int32)
        org = np.stack([org_plane[y:y + n, x:x + n]
                        for y, x in zip(ys, xs)]).astype(np.int32)
        got = np.asarray(fn(jnp.asarray(win), jnp.asarray(org)), np.float64)
        exact = np_sse(win, org)
        energy = ((org.astype(np.int64) ** 2).sum((1, 2))[:, None, None]
                  + np.stack([(sliding_window_view(wv.astype(np.int64) ** 2,
                                                   (n, n))).sum((-1, -2))
                              for wv in win]))
        rel = float((np.abs(got - exact) / np.maximum(energy, 1)).max())
        # f32 sums above 2^24 round: each of the n^2 accumulated terms can
        # lose half an ulp (2^-24 relative) of the running magnitude
        tol = n * n * 2.0 ** -23
        amin_diff = float((got.reshape(nblk, -1).argmin(1)
                           != exact.reshape(nblk, -1).argmin(1)).mean())
        info[f"sse{n}_max_rel_err"] = rel
        info[f"sse{n}_argmin_differs"] = amin_diff
        if not rel <= tol:
            raise AssertionError(f"sse_map n={n}: rel err {rel} > {tol}")
        if n == 16:
            info["lowering_sse16"] = lowering(ss_scan.sse_map,
                                              jnp.asarray(win),
                                              jnp.asarray(org))


# --------------------------------------------- phase 5: cross-backend
def _maps_diff(a, b) -> str:
    """Names of the parsed syntax fields in which two slices differ."""
    diffs = []
    for k, v in vars(a).items():
        if isinstance(v, np.ndarray):
            nd = int((v != getattr(b, k)).sum())
            if nd:
                diffs.append(f"{k}:{nd}")
    return ",".join(diffs) or "none"


def cross_backend(info, seed, w, h):
    from hevc_hop_tpu.models.decoder import Decoder
    from hevc_hop_tpu.models.encoder import EncoderConfig, IntraEncoder
    from hevc_hop_tpu.models.ss_encoder import HoloConfig, HoloEncoder
    cases = {
        "intra": (lambda: IntraEncoder(EncoderConfig(
            width=w, height=h, qp=32, sao=True)),
                  class_b_frames(seed, w, h, 1)[0]),
        "iss": (lambda: HoloEncoder(HoloConfig(
            width=w, height=h, qp=32, mi_size=16, gt=True, search_range=32,
            quadtree=True, sao=True)),
                lenslet_frames(seed, w, h, 1)[0]),
    }
    cpu = jax.devices("cpu")[0]
    for tag, (make, frame) in cases.items():
        with jax.default_device(cpu):
            enc = make()
            s_cpu = enc.encode_frame(*frame)
            rec_cpu = enc.recon_yuv
        d_cpu = _decode_check(s_cpu, 1)
        got = d_cpu.pictures[0]
        if not all((np.asarray(a) == np.asarray(b)).all()
                   for a, b in zip(got, rec_cpu)):
            raise AssertionError(f"{tag}: GPU decode of the CPU stream != "
                                 f"CPU recon")
        s_gpu = make().encode_frame(*frame)
        info[f"{tag}_gpu_stream_equals_cpu"] = s_gpu == s_cpu
        if s_gpu != s_cpu:
            d_gpu = Decoder()
            d_gpu.decode_stream(s_gpu)
            info[f"{tag}_decisions_differ"] = _maps_diff(d_cpu.last_maps,
                                                         d_gpu.last_maps)


# ------------------------------------------------- phase 6: four cards
def four_cards(seed, w=CLASS_B[0], h=CLASS_B[1]) -> None:
    from hevc_hop_tpu.models.encoder import EncoderConfig, IntraEncoder
    from hevc_hop_tpu.parallel import shard_encode
    if len(jax.devices()) < 4:
        raise SystemExit(f"--four-cards needs 4 GPUs, found "
                         f"{len(jax.devices())}")
    with Phase("6 four_cards_mesh_encode") as ph:
        mesh = shard_encode.make_mesh(4, band_par=2)   # (frame=2, band=2)
        cfg = EncoderConfig(width=w, height=h, qp=32, cu_log2=4,
                            deblocking=True, sao=False)
        frames = class_b_frames(seed, w, h, 2)
        menc = shard_encode.MeshIntraEncoder(cfg, mesh)
        streams = menc.encode_frames(frames)
        ref = IntraEncoder(cfg)        # single device: card 0
        for f, frame in enumerate(frames):
            sref = ref.encode_frame(*frame)
            if streams[f] != sref:
                raise AssertionError(f"frame {f}: mesh stream != "
                                     f"single-device stream")
            got = [np.asarray(p, np.int32) for p in menc.last_recons[f]]
            if not all((a == b).all() for a, b in zip(got, ref.recon_yuv)):
                raise AssertionError(f"frame {f}: mesh recon != "
                                     f"single-device recon")
            _decode_check(streams[f], 1)
        ph.info["mesh"] = list(mesh.devices.shape)
        ph.info["stream_bytes"] = [len(s) for s in streams]


def run(args) -> None:
    jax.monitoring.register_event_duration_secs_listener(_on_event)
    with Phase("0 setup"):
        phase_setup()
    if args.four_cards:
        four_cards(args.seed)
        return
    w, h = CLASS_B
    with tempfile.TemporaryDirectory() as tmp:
        frames = class_b_frames(args.seed, w, h)
        with Phase("1 classB_intra_cli") as ph:
            s1, r1 = phase_cli_roundtrip(tmp, "cb1", "encoder_intra_main.cfg",
                                         frames, w, h)
            ph.info["stream_bytes"] = len(s1)
        with Phase("2 determinism"):
            s2, r2 = phase_cli_roundtrip(tmp, "cb2", "encoder_intra_main.cfg",
                                         frames, w, h)
            if s2 != s1 or r2 != r1:
                raise AssertionError("repeated encode differs")
        with Phase("3 lenslet_iss_pss_cli") as ph:
            lw, lh = LENSLET
            s3, _ = phase_cli_roundtrip(tmp, "ll", "3DHencoder_intra_main.cfg",
                                        lenslet_frames(args.seed, lw, lh),
                                        lw, lh)
            ph.info["stream_bytes"] = len(s3)
    with Phase("4 exactness") as ph:
        check_goldens(ph.info)
        check_batched_transforms(ph.info, frames[0][0], frames[1][0])
        check_sse(ph.info, frames[0][0], frames[1][0])
    with Phase("5 cross_backend") as ph:
        cross_backend(ph.info, args.seed, *SMALL)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card mesh encode phase")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    err = []

    def body():
        try:
            run(args)
        except BaseException as e:     # re-raised on the main thread
            err.append(e)

    # the XLA compilers recurse deeply on the scan programs
    threading.stack_size(512 << 20)
    t = threading.Thread(target=body)
    t.start()
    t.join()
    if err:
        raise err[0]
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
