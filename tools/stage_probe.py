"""Time the lossy encode's staging of its upload frames, and print the
digests of the streams that depend on it.

    python3 tools/stage_probe.py [--seconds 300] [--repeat 7] [--digests-only]

On one CUDA card. Prints the card's name and power limit and the host's
usable CPUs first. Timing (on a `--seconds` 44.1 kHz stereo track, frame
2048, overlap 16: 6,890 frames at 300 s): for each upload dtype (float32,
the benchmark's; int16, `i16_upload`; float64), in turns `--repeat` times,

* `gather+cast`: `pipeline._gather`, then the cast (`astype`, or the
  numpy route's `pipeline._to_i16`), the host staging of the route before
  the native pass (whose int16 cast ran natively on 2 threads);
* `stage`: `native.stage_frames` into a pinned buffer, the route's
  `enc:stage`;
* `old upload` / `new upload`: each of the two followed by its upload
  (`policy.to_device`'s pinned staging copy and copy of the cast array;
  the pinned buffer copied as it is) and a synchronise.

Median and best ms a track, and ms a 1,000 frames. Then the digests
(sha256) of `batch_encode` streams on 20 s of `chip_smoke.make_audio`:
Profile 1 at float32, with `i16_upload`, at float64, with (96, 24) ECC,
Profile 2, `final=False` spans of 3 frames, and an `Encoder` fed in
32 KiB pushes: two trees compare output by output. `--digests-only`
prints the digests alone, through the public entry points, so that it
runs on a tree without the native staging pass. Imports neither jax nor
the JAX package.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import statistics
import subprocess
import sys
import time

ROOT = os.environ.get("FRAD_PROFILE_TREE") or os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
import frad_python_tpu_torch as ft  # noqa: E402
from frad_python_tpu_torch import native  # noqa: E402
from frad_python_tpu_torch.ops import policy  # noqa: E402
from frad_python_tpu_torch.parallel import pipeline  # noqa: E402


def digests() -> None:
    pcm = chip_smoke.make_audio(20, 44100, 2)
    f32 = {"compute_dtype": "float32"}
    cases = {
        "p1_f32": (1, f32), "p1_i16": (1, dict(f32, i16_upload=True)),
        "p1_f64": (1, {"compute_dtype": "float64"}),
        "p1_ecc": (1, dict(f32, enable_ecc=True, ecc_ratio=(96, 24))),
        "p2_f32": (2, f32),
    }
    for name, (profile, kw) in cases.items():
        stream = ft.batch_encode(pcm, profile, 44100, 16, 2048, **kw)
        print(f"digest {name} {hashlib.sha256(stream).hexdigest()} {len(stream)}")
    span = 2048 + 2 * 1920
    spans = b"".join(ft.batch_encode(pcm[i:i + span], 1, 44100, 16, 2048, final=False, **f32)
                     for i in range(0, 40 * 1920, 3 * 1920))
    print(f"digest p1_spans {hashlib.sha256(spans).hexdigest()} {len(spans)}")
    raw = chip_smoke.to_s16le(pcm)
    enc = ft.Encoder(1, 44100, 2, 16, 2048, "s16le")
    enc.set_overlap_ratio(16)
    stream = b"".join(enc.process(raw[i:i + 32768]).buf
                      for i in range(0, len(raw), 32768)) + enc.flush().buf
    print(f"digest p1_encoder {hashlib.sha256(stream).hexdigest()} {len(stream)}")


def timing(seconds: float, repeat: int) -> None:
    dev = torch.device("cuda")
    track = np.random.default_rng(1).standard_normal((int(seconds * 44100), 2)) * 0.3
    frs, _ = pipeline.plan_frames(len(track), 2048, 16, True)
    frs = [f for f in frs if f[1] == 2048]
    starts = [s for s, _ in frs]
    b = len(frs)
    print(f"track {seconds} s, {b} frames, pass_workers {native.pass_workers(b)}")
    kinds = {"float32": torch.float32, "int16": torch.int16, "float64": torch.float64}

    def old(dtype, upload):
        arr = pipeline._gather(track, frs, 2048)
        arr = pipeline._to_i16(arr) if dtype == "int16" else arr.astype(dtype)
        if upload:
            policy.to_device(arr, dev)
            torch.cuda.synchronize()
        return arr

    def new(dtype, upload):
        buf = torch.empty((b, 2048, 2), dtype=kinds[dtype], pin_memory=True)
        native.stage_frames(track, starts, 2048, buf.numpy())
        if upload:
            policy.to_device(buf, dev)
            torch.cuda.synchronize()
        return buf.numpy()

    for dtype in kinds:
        assert np.array_equal(old(dtype, False), new(dtype, False)), dtype
        times = {k: [] for k in ("gather+cast", "stage", "old upload", "new upload")}
        for _ in range(repeat):
            for name, fn, up in (("gather+cast", old, False), ("stage", new, False),
                                 ("old upload", old, True), ("new upload", new, True)):
                t0 = time.perf_counter()
                fn(dtype, up)
                times[name].append(time.perf_counter() - t0)
        for name, ts in times.items():
            med = statistics.median(ts)
            print(f"time {dtype} {name}: median {1e3 * med:.2f} ms, best {1e3 * min(ts):.2f} ms, "
                  f"{1e6 * med / b:.2f} ms a 1,000 frames")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=300.0)
    ap.add_argument("--repeat", type=int, default=7)
    ap.add_argument("--digests-only", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("stage_probe: no CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(f"cpus {len(os.sched_getaffinity(0))}, tree {ROOT}")
    if not args.digests_only:
        timing(args.seconds, args.repeat)
    digests()


if __name__ == "__main__":
    main()
