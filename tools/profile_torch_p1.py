"""Host and device profile of the PyTorch port on one CUDA card.

    python3 tools/profile_torch_p1.py               # Profile 1
    python3 tools/profile_torch_p1.py --lossless    # profiles 0 and 4
    python3 tools/profile_torch_p1.py --long        # Profile 1 at 8192 / 16384
    python3 tools/profile_torch_p1.py --ksplit      # the DCT GEMM's K cut
    python3 tools/profile_torch_p1.py --p2          # Profile 2, and float64

Profile 1: `chip_smoke.py`'s configuration (44.1 kHz stereo, 16-bit,
2048-sample frames, overlap ratio 16, i16 upload and transfer) on
`make_audio` content: clean encode and decode, ECC encode at (96, 24),
`batch_repair` of the damaged armored stream and its `fix_error` decode,
and the streaming engines on the track as s16le bytes (`Encoder` and
`Decoder` in 32 KiB pushes, `Decoder` in `exact` mode).

`--lossless`: `chip_smoke.py`'s lossless configurations: `p0_stereo_44k1`
(24-bit, float32 fast path, and its int24 transfer variant),
`p0_stereo_48b` / `p0_stereo_64b` (float64 FFT form), `p4_mono_44k1`,
`hires_96k_8ch` (cut to 10 s), and `p0_stereo_44k1` as s32le bytes
through `Encoder` and `Decoder` in 32 KiB pushes.

`--long`: Profile 1 on the same 30 s at 8192-sample frames (the DCT GEMM
cut along K) and at 16384 (the float32 FFT form), encode and decode.

`--p2`: Profile 2 on the same 30 s and geometry: batch encode and
decode, `Decoder` in 32 KiB pushes and in `exact` mode, and an `Encoder`
whose loaded state names profile 2 in 32 KiB pushes; then profiles 1 and
2 at `compute_dtype="float64"` on 5 s.

After a warm-up of each call, whose output's digest it prints (sha256 of
the stream's bytes or the decoded PCM; two trees compare output by output):

* walls: five host-clock calls of each, ending in
  `torch.cuda.synchronize()`; median, min and max, and frames/s at the
  median;
* host: one cProfile'd call of each traced call, top functions by self
  time (full listings under `_profile/`, with the device tables);
* device: one `torch.profiler` call of each traced call: device busy
  (self device time of all kernels and copies), the wall of the traced
  call, the device idle share 1 - busy / wall, and the device launches
  (kernels and copies) of the traced call beside its calls of
  `pipeline.batch_encode` and `pipeline._decode_run`, which gives the
  streaming engines' launches per call;
* stages: one call of each traced call with `pipeline.STAGES` set to a
  `StageTimer`: host wall and count per stage, bytes copied each way.

`--ksplit` replaces the three with the probe behind `ops/dct.py`'s
K_SPLIT_ABOVE / K_CHUNK: the float32 DCT GEMM at the `hires_96k_8ch` and
Profile 1 8192-sample shapes as one GEMM and cut into 512- to 4096-long
GEMMs, each one's largest error against the float64 FFT form (relative
to the coefficients' peak) on the card and on the CPU, and its CUDA-event
time; then `hires_96k_8ch` and Profile 1 at 8192 encoded on the card with
the one GEMM and with the cut, each stream's SNR decoded on the card and
on the CPU.

Prints the card's name and power limit first. Needs a CUDA device;
imports neither jax nor the JAX package. With FRAD_PROFILE_TREE set to
another checkout (a parent's `git archive`), it profiles that checkout's
port and chip_smoke.py: `tools/profile_ab.sh` runs one copy of this tool
on both trees.
"""

from __future__ import annotations

import cProfile
import hashlib
import io
import os
import pstats
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(os.environ.get("FRAD_PROFILE_TREE") or Path(__file__).resolve().parent.parent)
OUT = REPO / "_profile"
SECONDS, REPS = 30.0, 5


def p1_calls(ft, torch, dev):
    """{name: (call, frames)} of the Profile 1 path, and the traced names."""
    from chip_smoke import (BITS, CHANNELS, ECC_RATIO, FSIZE, PUSH, SRATE, make_audio,
                            stream_decode, stream_encode, to_s16le)
    from frad_python_tpu_torch.parallel.pipeline import plan_frames
    from frad_python_tpu_torch.utils.damage import damage_stream

    pcm = make_audio(SECONDS, SRATE, CHANNELS)
    n = len(plan_frames(len(pcm), FSIZE, 16, True)[0])
    stream = ft.batch_encode(pcm, 1, SRATE, BITS, FSIZE, i16_upload=True, device=dev)
    armored = ft.batch_encode(pcm, 1, SRATE, BITS, FSIZE, i16_upload=True, enable_ecc=True,
                              ecc_ratio=ECC_RATIO, device=dev)
    damaged = damage_stream(armored)
    raw = to_s16le(pcm)
    pushed = stream_encode(ft, torch, raw, PUSH, dev)
    calls = {
        "enc": (lambda: ft.batch_encode(pcm, 1, SRATE, BITS, FSIZE, i16_upload=True,
                                        device=dev), n),
        "dec": (lambda: ft.batch_decode(stream, i16_transfer=True, device=dev), n),
        "enc_ecc": (lambda: ft.batch_encode(pcm, 1, SRATE, BITS, FSIZE, i16_upload=True,
                                            enable_ecc=True, ecc_ratio=ECC_RATIO,
                                            device=dev), n),
        "repair": (lambda: ft.batch_repair(damaged, ECC_RATIO), n),
        "dec_fix": (lambda: ft.batch_decode(damaged, fix_error=True, i16_transfer=True,
                                            device=dev), n),
        "stream_enc": (lambda: stream_encode(ft, torch, raw, PUSH, dev), n),
        "stream_dec": (lambda: stream_decode(ft, torch, pushed, PUSH, dev), n),
        "stream_dec_exact": (lambda: stream_decode(ft, torch, pushed, PUSH, dev, exact=True),
                             n),
    }
    return calls, ("enc", "dec", "dec_fix", "stream_enc", "stream_dec")


def lossless_calls(ft, torch, dev):
    """{name: (call, frames)} of the lossless configurations, and the traced names."""
    from chip_smoke import (CHANNELS, FSIZE, HIRES, P0_BITS, PUSH, SRATE, make_audio,
                            stream_decode, stream_encode_p0, to_s32le)

    pcm = make_audio(SECONDS, SRATE, CHANNELS)
    mono = make_audio(SECONDS, SRATE, 1)
    hi = make_audio(HIRES["seconds"], HIRES["srate"], HIRES["channels"])
    n = -(-len(pcm) // FSIZE)
    n_hi = -(-len(hi) // HIRES["fsize"])
    configs = {                    # name: (pcm, profile, srate, bits, fsize, frames, options)
        "p0": (pcm, 0, SRATE, P0_BITS, FSIZE, n, {}),
        "p0_i24": (pcm, 0, SRATE, P0_BITS, FSIZE, n, {"i24_upload": True}),
        "p0_48b": (pcm, 0, SRATE, 48, FSIZE, n, {}),
        "p0_64b": (pcm, 0, SRATE, 64, FSIZE, n, {}),
        "p4": (mono, 4, SRATE, 16, FSIZE, n, {}),
        "hires": (hi, 0, HIRES["srate"], HIRES["bits"], HIRES["fsize"], n_hi, {}),
    }
    calls = {}
    for name, (x, profile, srate, bits, fsize, frames, opts) in configs.items():
        def enc(x=x, profile=profile, srate=srate, bits=bits, fsize=fsize, opts=opts):
            return ft.batch_encode(x, profile, srate, bits, fsize, device=dev, **opts)
        stream = enc()
        dec_opts = {"i24_transfer": True} if opts else {}
        calls[f"{name}_enc"] = (enc, frames)
        calls[f"{name}_dec"] = (lambda s=stream, o=dec_opts: ft.batch_decode(s, device=dev, **o),
                                frames)
    raw = to_s32le(pcm)
    pushed = stream_encode_p0(ft, torch, raw, PUSH, dev)
    calls["stream_enc"] = (lambda: stream_encode_p0(ft, torch, raw, PUSH, dev), n)
    calls["stream_dec"] = (lambda: stream_decode(ft, torch, pushed, PUSH, dev), n)
    return calls, ("p0_enc", "p0_dec", "p0_64b_enc", "p0_64b_dec", "hires_enc", "hires_dec",
                   "stream_enc", "stream_dec")


def long_calls(ft, torch, dev):
    """{name: (call, frames)} of Profile 1 at 8192 and 16384 samples, and
    the traced names."""
    from chip_smoke import BITS, CHANNELS, SRATE, make_audio
    from frad_python_tpu_torch.parallel.pipeline import plan_frames

    pcm = make_audio(SECONDS, SRATE, CHANNELS)
    calls = {}
    for fsize in (8192, 16384):
        n = len(plan_frames(len(pcm), fsize, 16, True)[0])
        stream = ft.batch_encode(pcm, 1, SRATE, BITS, fsize, i16_upload=True, device=dev)
        calls[f"enc_{fsize}"] = (lambda f=fsize: ft.batch_encode(
            pcm, 1, SRATE, BITS, f, i16_upload=True, device=dev), n)
        calls[f"dec_{fsize}"] = (lambda s=stream: ft.batch_decode(
            s, i16_transfer=True, device=dev), n)
    return calls, tuple(calls)


def p2_calls(ft, torch, dev):
    """{name: (call, frames)} of the Profile 2 path and of the lossy
    profiles at float64, and the traced names."""
    from chip_smoke import (BITS, CHANNELS, F64_SECONDS, FSIZE, PUSH, SRATE, make_audio,
                            stream_decode, to_s16le)
    from frad_python_tpu_torch.parallel.pipeline import plan_frames

    pcm = make_audio(SECONDS, SRATE, CHANNELS)
    short = make_audio(F64_SECONDS, SRATE, CHANNELS)
    n = len(plan_frames(len(pcm), FSIZE, 16, True)[0])
    n64 = len(plan_frames(len(short), FSIZE, 16, True)[0])
    stream = ft.batch_encode(pcm, 2, SRATE, BITS, FSIZE, device=dev)
    raw = to_s16le(pcm)

    def stream_encode_p2() -> bytes:
        enc = ft.Encoder(1, SRATE, CHANNELS, BITS, FSIZE, "s16le", device=dev)
        enc.set_overlap_ratio(16)
        enc.load_state_dict(dict(enc.state_dict(), profile=2))
        out = [enc.process(raw[i:i + PUSH]).buf for i in range(0, len(raw), PUSH)]
        return b"".join(out) + enc.flush().buf

    calls = {
        "p2_enc": (lambda: ft.batch_encode(pcm, 2, SRATE, BITS, FSIZE, device=dev), n),
        "p2_dec": (lambda: ft.batch_decode(stream, device=dev), n),
        "p2_stream_enc": (stream_encode_p2, n),
        "p2_stream_dec": (lambda: stream_decode(ft, torch, stream, PUSH, dev), n),
        "p2_stream_dec_exact": (lambda: stream_decode(ft, torch, stream, PUSH, dev, exact=True),
                                n),
    }
    for profile in (1, 2):
        s64 = ft.batch_encode(short, profile, SRATE, BITS, FSIZE, compute_dtype="float64",
                              device=dev)
        calls[f"p{profile}_f64_enc"] = (lambda p=profile: ft.batch_encode(
            short, p, SRATE, BITS, FSIZE, compute_dtype="float64", device=dev), n64)
        calls[f"p{profile}_f64_dec"] = (lambda s=s64: ft.batch_decode(
            s, compute_dtype="float64", device=dev), n64)
    return calls, ("p2_enc", "p2_dec", "p2_stream_enc", "p2_stream_dec", "p2_f64_enc",
                   "p2_f64_dec")


def ksplit_probe(ft, torch, dev) -> None:
    """See the module docstring (`--ksplit`)."""
    import numpy as np

    from chip_smoke import BITS, CHANNELS, HIRES, SRATE, cuda_ms, make_audio, snr_db
    from frad_python_tpu_torch.ops import dct
    from frad_python_tpu_torch.parallel.pipeline import plan_frames

    n = 8192
    pcm = make_audio(SECONDS, SRATE, CHANNELS)
    hi = make_audio(HIRES["seconds"], HIRES["srate"], HIRES["channels"])
    p1_rows = CHANNELS * (len(plan_frames(len(pcm), n, 16, True)[0]) - 1)
    for what, rows in (("hires_96k_8ch", -(-len(hi) // n) * HIRES["channels"]),
                       ("p1 at 8192", p1_rows)):
        x = torch.from_numpy(np.random.default_rng(5).standard_normal((rows, n))
                             .astype(np.float32) * 0.3)
        for where in ("card", "cpu"):
            xd = x.to(dev) if where == "card" else x
            ref = dct.dct2(xd.double())
            peak = float(ref.abs().max())
            fwd, _ = dct.device_matrices(n, xd.device)
            for chunk in (None, 512, 1024, 2048, 4096):
                def form(chunk=chunk):
                    return (dct.matmul_rows(xd, fwd) if chunk is None
                            else dct.matmul_rows_chunked(xd, fwd, chunk))
                err = float((form().double() - ref).abs().max()) / peak
                ms = cuda_ms(torch, form, 5, 5) if where == "card" else float("nan")
                print(f"ksplit {what} [{rows}, {n}] {where}: "
                      f"{'one GEMM' if chunk is None else f'K cut {chunk}'}: max err "
                      f"{err:.4e} of the peak" + (f", {ms:.4f} ms" if where == "card" else ""))
    saved = dct.K_SPLIT_ABOVE
    try:
        for name, split in (("one GEMM", dct.MATMUL_MAX_N), (f"K cut {dct.K_CHUNK}", saved)):
            dct.K_SPLIT_ABOVE = split
            for what, x, args, enc_kw, dec_kw in (
                    ("hires_96k_8ch", hi, (0, HIRES["srate"], HIRES["bits"], n), {}, {}),
                    ("p1 at 8192", pcm, (1, SRATE, BITS, n), {"i16_upload": True},
                     {"i16_transfer": True})):
                stream = ft.batch_encode(x, *args, device=dev, **enc_kw)
                out_d, _ = ft.batch_decode(stream, device=dev, **dec_kw)
                out_c, _ = ft.batch_decode(stream, device="cpu", **dec_kw)
                print(f"ksplit {what}, {name} on both sides: SNR decoded on the card "
                      f"{snr_db(x, out_d):.4f} dB, on the cpu {snr_db(x, out_c):.4f} dB")
    finally:
        dct.K_SPLIT_ABOVE = saved


def digest(out) -> str:
    """sha256 (16 hex digits) of a call's output: stream bytes, PCM arrays,
    sample rates, and tuples of them (a float in them is a time: left out)."""
    import numpy as np

    h = hashlib.sha256()

    def feed(x):
        if isinstance(x, (bytes, bytearray)):
            h.update(x)
        elif isinstance(x, np.ndarray):
            h.update(str(x.dtype).encode() + np.ascontiguousarray(x).tobytes())
        elif isinstance(x, (tuple, list)):
            for y in x:
                feed(y)
        elif isinstance(x, float):      # stream_decode's time to first audio
            pass
        else:
            h.update(repr(x).encode())

    feed(out)
    return h.hexdigest()[:16]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_p1: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import frad_python_tpu_torch as ft
    from frad_python_tpu_torch import native
    from frad_python_tpu_torch.kernels import build
    from frad_python_tpu_torch.native import build as native_build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    for name, fn in (("kernels", build.build), ("native", native_build.build)):
        t0 = time.perf_counter()
        path, compiled = fn()
        print(f"build {name}: {'compiled' if compiled else 'cached'} in "
              f"{time.perf_counter() - t0:.3f} s")
    native.library()
    OUT.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda")

    if "--ksplit" in sys.argv[1:]:
        ksplit_probe(ft, torch, dev)
        return 0
    mode = {"--lossless": lossless_calls, "--long": long_calls, "--p2": p2_calls}
    calls, traced = next((fn for flag, fn in mode.items() if flag in sys.argv[1:]),
                         p1_calls)(ft, torch, dev)
    for name, (fn, _) in calls.items():      # first-use set-up outside the timing
        print(f"digest {name}: {digest(fn())}")

    def timed(fn) -> float:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for name, (fn, frames) in calls.items():
        walls = [timed(fn) for _ in range(REPS)]
        med = statistics.median(walls)
        print(f"wall {name}: median {med:.4f} s (min {min(walls):.4f}, max {max(walls):.4f}), "
              f"{frames / med:.1f} frames/s, {REPS} calls")

    for name in traced:
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.runcall(calls[name][0])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        buf = io.StringIO()
        stats = pstats.Stats(prof, stream=buf).sort_stats("tottime")
        stats.print_stats(40)
        (OUT / f"cprofile_{name}.txt").write_text(buf.getvalue())
        print(f"cprofile {name}: wall {wall:.4f} s; top self time:")
        rows = sorted(stats.stats.items(), key=lambda kv: kv[1][2], reverse=True)[:8]
        for (file, line, func), (_cc, ncalls, tottime, cumtime, _) in rows:
            print(f"  {tottime:.4f} s self, {cumtime:.4f} s cum, {ncalls} calls: "
                  f"{Path(file).name}:{line}({func})")

    from torch.profiler import ProfilerActivity, profile

    from frad_python_tpu_torch.parallel import pipeline

    device_types = {torch.autograd.DeviceType.CUDA}
    for name in traced:
        n_calls = {"batch_encode": 0, "_decode_run": 0}
        saved = {fn: getattr(pipeline, fn) for fn in n_calls}

        def counting(fn_name):
            def call(*args, **kwargs):
                n_calls[fn_name] += 1
                return saved[fn_name](*args, **kwargs)
            return call

        for fn_name in saved:
            setattr(pipeline, fn_name, counting(fn_name))
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                calls[name][0]()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            for fn_name, fn in saved.items():
                setattr(pipeline, fn_name, fn)
        events = prof.key_averages()
        busy_us = sum(e.self_device_time_total for e in events
                      if e.device_type in device_types and not e.is_user_annotation)
        (OUT / f"torch_profile_{name}.txt").write_text(
            events.table(sort_by="self_device_time_total", row_limit=40))
        top = sorted((e for e in events if e.device_type in device_types),
                     key=lambda e: e.self_device_time_total, reverse=True)[:5]
        launches = sum(e.count for e in events
                       if e.device_type in device_types and not e.is_user_annotation)
        print(f"launches {name}: {launches} device kernels and copies over "
              f"{n_calls['batch_encode']} batch_encode and {n_calls['_decode_run']} "
              f"_decode_run calls")
        print(f"device {name}: busy {busy_us / 1e3:.4f} ms of a {wall:.4f} s traced wall, "
              f"idle share {1 - busy_us / 1e6 / wall:.5f}; top: "
              + "; ".join(f"{e.key[:60]} {e.self_device_time_total:.1f} us x{e.count}"
                          for e in top))
    from frad_python_tpu_torch.utils.tracing import StageTimer

    for name in traced:
        pipeline.STAGES = timer = StageTimer()
        try:
            calls[name][0]()
            torch.cuda.synchronize()
        finally:
            pipeline.STAGES = None
        print(f"stages {name}: " + "; ".join(
            f"{stage} {timer.totals[stage]:.4f} s x{timer.counts[stage]}"
            for stage in sorted(timer.totals, key=timer.totals.get, reverse=True))
            + f"; h2d {timer.bytes['h2d']} bytes, d2h {timer.bytes['d2h']} bytes")
    print(f"native calls since load: {({w.__name__: w.calls for w in native.WRAPPERS})}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
