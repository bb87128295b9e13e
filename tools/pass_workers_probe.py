"""Time the two Profile 1 payload passes at several worker counts.

    python3 tools/pass_workers_probe.py [--device cuda] [--seconds 180]
        [--workers 1,2,3,4,6,8] [--repeat 3] [--seed 1]

Encodes and decodes one music-like stereo track (`portbench/audio.py`,
44.1 kHz, 16-bit, Profile 1, frame 2048, overlap 16, float32) through
`batch_encode` / `batch_decode` on `--device`, capturing the arguments of
every `native.p1_pack_batch` / `native.p1_unpack_batch` call; then runs the
largest captured call of each pass again at each worker count, `--repeat`
times in turns (every count once, then again), with `stats=True`.

Prints the host first: CPUs, affinity, cgroup quota, `LOCAL_WORLD_SIZE`,
`lscpu`'s threads per core and the physical cores among the affinity's CPUs
(`thread_siblings_list`), and `native.pass_workers` of the call where this
tree has it. Then, per pass and count: wall µs a frame (best and median,
`perf_counter` around the C call), the workers' CPU µs a frame and CPU over
lifetime (`native.Pass`), parallelism (CPU over wall). Every count's bytes
must equal the first count's: the probe fails otherwise. The last line is
the whole result as JSON. Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import frad_python_tpu_torch as ft  # noqa: E402
from frad_python_tpu_torch import native  # noqa: E402
from portbench import audio  # noqa: E402

SRATE, CHANNELS, BITS, FRAME = 44100, 2, 16, 2048
#: the command line's loss level 0, as `portbench/configs/p1_stereo_44k1.json` runs it
LOSS = 1.25 ** 0 / 19 + 0.5


def host() -> dict:
    """What the process may run on, and how its CPUs share cores."""
    cpus = sorted(os.sched_getaffinity(0))
    cores = set()
    for c in cpus:
        try:
            with open(f"/sys/devices/system/cpu/cpu{c}/topology/thread_siblings_list") as f:
                cores.add(f.read().strip())
        except OSError:
            pass
    lscpu = {}
    if shutil.which("lscpu"):
        out = subprocess.run(["lscpu"], capture_output=True, text=True).stdout
        for line in out.splitlines():
            key, _, val = line.partition(":")
            if key.strip() in ("Model name", "Thread(s) per core", "Core(s) per socket",
                               "Socket(s)", "CPU(s)", "On-line CPU(s) list"):
                lscpu[key.strip()] = val.strip()
    return {"cpu_count": os.cpu_count(), "affinity": len(cpus),
            "cpu_quota": native.cpu_quota(),
            "local_world_size": os.environ.get("LOCAL_WORLD_SIZE"),
            "physical_cores_in_affinity": len(cores) or None,
            "siblings": sorted(cores), "lscpu": lscpu,
            "device": torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"}


def capture(seconds: float, seed: int, device: str) -> tuple[tuple, tuple]:
    """The largest call's (args, kwargs) of p1_pack_batch and of p1_unpack_batch
    in one batch_encode / batch_decode of a `seconds` track."""
    calls = {"p1_pack_batch": [], "p1_unpack_batch": []}
    real = {name: getattr(native, name) for name in calls}

    def recorder(name):
        def call(*args, **kwargs):
            calls[name].append((args, kwargs))
            return real[name](*args, **kwargs)
        return call

    (pcm,) = audio.album([seconds], SRATE, CHANNELS, BITS, seed, device)
    for name in calls:
        setattr(native, name, recorder(name))
    try:
        stream = ft.batch_encode(pcm, 1, SRATE, BITS, FRAME, loss_level=LOSS,
                                 overlap_ratio=16, compute_dtype="float32", device=device)
        ft.batch_decode(stream, compute_dtype="float32", device=device)
    finally:
        for name, fn in real.items():
            setattr(native, name, fn)
    pack = max(calls["p1_pack_batch"], key=lambda c: len(c[0][0]))
    unpack = max(calls["p1_unpack_batch"], key=lambda c: len(c[0][0]))
    return pack, unpack


def time_pass(name: str, call: tuple, workers: list[int], repeat: int) -> list[dict]:
    fn = getattr(native, name)
    args, kwargs = call
    kwargs = {k: v for k, v in kwargs.items() if k not in ("nthreads", "stats")}
    frames = len(args[0])
    runs = {w: [] for w in workers}
    first = None
    for _ in range(repeat):
        for w in workers:
            fn.passes.clear()
            out = fn(*args, nthreads=w, stats=True, **kwargs)
            (p,) = fn.passes
            runs[w].append(p)
            digest = [x if isinstance(x, (bytes, type(None))) else np.asarray(x).tobytes()
                      for x in (out if name == "p1_pack_batch" else out[:2])]
            if first is None:
                first = digest
            elif digest != first:
                raise AssertionError(f"{name} at {w} workers differs from {workers[0]}")
    rows = []
    for w, ps in runs.items():
        walls = [(p.t1 - p.t0) / frames * 1e6 for p in ps]
        rows.append({
            "pass": name, "frames": frames, "workers": w, "threads": ps[0].threads,
            "wall_us_best": round(min(walls), 2),
            "wall_us_median": round(statistics.median(walls), 2),
            "cpu_us": round(statistics.median(p.busy_s / frames * 1e6 for p in ps), 2),
            "parallelism": round(statistics.median(p.busy_s / (p.t1 - p.t0) for p in ps), 3),
            "cpu_over_life": round(statistics.median(p.busy_s / p.live_s for p in ps), 3)})
    return rows


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seconds", type=float, default=180.0)
    ap.add_argument("--workers", default="1,2,3,4,6,8")
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--seed", type=int, default=1)
    a = ap.parse_args(argv)
    if a.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to probe on the CPU")
    info = host()
    print("host", json.dumps(info), flush=True)
    pack, unpack = capture(a.seconds, a.seed, a.device)
    workers = [int(w) for w in a.workers.split(",")]
    rule = getattr(native, "pass_workers", None)
    result = {"host": info, "seconds": a.seconds, "repeat": a.repeat, "rows": []}
    for name, call in (("p1_pack_batch", pack), ("p1_unpack_batch", unpack)):
        frames = len(call[0][0])
        result[f"{name}.pass_workers"] = rule(frames) if rule else None
        print(f"{name}: {frames} frames, pass_workers {result[f'{name}.pass_workers']}",
              flush=True)
        for row in time_pass(name, call, workers, a.repeat):
            result["rows"].append(row)
            print("  {workers:>2} workers: wall {wall_us_best:8.2f} best {wall_us_median:8.2f} "
                  "median us/frame, CPU {cpu_us:8.2f} us/frame, x{parallelism:.3f}, "
                  "CPU/life {cpu_over_life:.3f}".format(**row), flush=True)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
