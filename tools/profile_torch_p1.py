"""Host and device profile of the PyTorch port's Profile 1 path on one CUDA card.

    python3 tools/profile_torch_p1.py

Runs `chip_smoke.py`'s configuration (44.1 kHz stereo, 16-bit, 2048-sample
frames, overlap ratio 16, i16 upload and transfer) on `make_audio`
content, after a 1 s warm-up:

* walls: five host-clock calls of each of clean encode, clean decode,
  ECC encode at (96, 24), `batch_repair` of the damaged armored stream
  and its `fix_error` decode, and of the streaming engines on the track
  as s16le bytes (`Encoder` and `Decoder` in 32 KiB pushes, `Decoder` in
  `exact` mode), each ending in `torch.cuda.synchronize()`; median, min
  and max, and frames/s at the median;
* host: one cProfile'd call each of clean encode, clean decode, ECC
  decode and the streaming encode and decode, top functions by self
  time (full listings under `_profile/`, with the device tables);
* device: one `torch.profiler` call of each of the same: device busy
  (self device time of all kernels and copies), the wall of the traced
  call, and the device idle share 1 - busy / wall.

Prints the card's name and power limit first. Needs a CUDA device;
imports neither jax nor the JAX package.
"""

from __future__ import annotations

import cProfile
import io
import pstats
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "_profile"
SECONDS, REPS = 30.0, 5


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_p1: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import frad_python_tpu_torch as ft
    from chip_smoke import (BITS, CHANNELS, ECC_RATIO, FSIZE, PUSH, SRATE, make_audio,
                            stream_decode, stream_encode, to_s16le)
    from frad_python_tpu_torch import native
    from frad_python_tpu_torch.kernels import build
    from frad_python_tpu_torch.native import build as native_build
    from frad_python_tpu_torch.parallel.pipeline import plan_frames
    from frad_python_tpu_torch.utils.damage import damage_stream

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

    pcm = make_audio(SECONDS, SRATE, CHANNELS)
    nframes = len(plan_frames(len(pcm), FSIZE, 16, True)[0])
    warm = make_audio(1.0, SRATE, CHANNELS)
    ft.batch_decode(ft.batch_encode(warm, 1, SRATE, BITS, FSIZE, i16_upload=True,
                                    enable_ecc=True, device=dev),
                    fix_error=True, i16_transfer=True, device=dev)
    stream = ft.batch_encode(pcm, 1, SRATE, BITS, FSIZE, i16_upload=True, device=dev)
    armored = ft.batch_encode(pcm, 1, SRATE, BITS, FSIZE, i16_upload=True, enable_ecc=True,
                              ecc_ratio=ECC_RATIO, device=dev)
    damaged = damage_stream(armored)
    raw = to_s16le(pcm)
    pushed = stream_encode(ft, torch, raw, PUSH, dev)
    stream_decode(ft, torch, pushed, PUSH, dev)
    stream_decode(ft, torch, pushed, PUSH, dev, exact=True)

    calls = {
        "enc": lambda: ft.batch_encode(pcm, 1, SRATE, BITS, FSIZE, i16_upload=True,
                                       device=dev),
        "dec": lambda: ft.batch_decode(stream, i16_transfer=True, device=dev),
        "enc_ecc": lambda: ft.batch_encode(pcm, 1, SRATE, BITS, FSIZE, i16_upload=True,
                                           enable_ecc=True, ecc_ratio=ECC_RATIO, device=dev),
        "repair": lambda: ft.batch_repair(damaged, ECC_RATIO),
        "dec_fix": lambda: ft.batch_decode(damaged, fix_error=True, i16_transfer=True,
                                           device=dev),
        "stream_enc": lambda: stream_encode(ft, torch, raw, PUSH, dev),
        "stream_dec": lambda: stream_decode(ft, torch, pushed, PUSH, dev),
        "stream_dec_exact": lambda: stream_decode(ft, torch, pushed, PUSH, dev, exact=True),
    }

    def timed(fn) -> float:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for name, fn in calls.items():
        walls = [timed(fn) for _ in range(REPS)]
        med = statistics.median(walls)
        print(f"wall {name}: median {med:.4f} s (min {min(walls):.4f}, max {max(walls):.4f}), "
              f"{nframes / med:.1f} frames/s, {REPS} calls")

    traced = ("enc", "dec", "dec_fix", "stream_enc", "stream_dec")
    for name in traced:
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.runcall(calls[name])
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

    device_types = {torch.autograd.DeviceType.CUDA}
    for name in traced:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            calls[name]()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.key_averages()
        busy_us = sum(e.self_device_time_total for e in events
                      if e.device_type in device_types and not e.is_user_annotation)
        (OUT / f"torch_profile_{name}.txt").write_text(
            events.table(sort_by="self_device_time_total", row_limit=40))
        top = sorted((e for e in events if e.device_type in device_types),
                     key=lambda e: e.self_device_time_total, reverse=True)[:5]
        print(f"device {name}: busy {busy_us / 1e3:.4f} ms of a {wall:.4f} s traced wall, "
              f"idle share {1 - busy_us / 1e6 / wall:.5f}; top: "
              + "; ".join(f"{e.key[:60]} {e.self_device_time_total:.1f} us x{e.count}"
                          for e in top))
    print(f"native calls since load: {({w.__name__: w.calls for w in native.WRAPPERS})}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
