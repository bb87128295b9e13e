"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up loads the cell's files by name (`spec.py`), makes its album from
the seed, warms the cell's own call shapes, collects the garbage and
freezes what is left; then the window runs the cell's traffic through
`frad_python_tpu_torch` for `--seconds`. After the window the sampled
outputs are compared with the plain reference (`reference/`), and the last
line of standard output is one JSON object: `correct`, `attempted`,
`failed`, `metrics`, `device` (and with `--trace 1` the device's busy
and window seconds and `breakdown`), and last `compared`, each number of
the comparison beside its limit. `--trace 0` reports the cell's
end-to-end metrics, `--trace 1` its per-layer metrics, read from a
profiler recording of the whole window and the pipeline's stage spans.

A run needs as many CUDA cards as its cell asks for and fails without
them; it never falls back to the CPU.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if __package__ in (None, ""):
    sys.path.insert(0, str(ROOT))

from portbench import record, spec  # noqa: E402

#: top-level module names that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "frad_python_tpu")
#: the number a comparison reports for a stream the reference refused
REFUSED = 1e30
#: recordings of a window that lost kernels, at most
RECORDINGS = 3


def program_env(cfg: dict) -> None:
    """Run the program as its command line does by default, at the
    configuration's compute dtype: no switch of the program's own
    (`FRAD_TORCH_*`) is left from the caller's environment."""
    for var in [v for v in os.environ if v.startswith("FRAD_TORCH_")]:
        del os.environ[var]
    os.environ["FRAD_TORCH_COMPUTE_DTYPE"] = cfg["compute_dtype"]


def forbidden_loaded() -> list[str]:
    return sorted({name.partition(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 and res.stdout else \
        "not measured"


def traced_window(torch, ft_kernels, pipeline, drv, seconds: float, cards: int):
    """(calls, pushes, Record) of a recorded window; a recording that kept
    fewer launches of a hand kernel than the kernel counted is made again."""
    devices = list(range(cards))
    for n in range(RECORDINGS):
        spans = record.Spans()
        ft_kernels.reset_launches()
        pipeline.STAGES = spans
        try:
            (calls, pushes), device = record.trace(torch, lambda: drv.window(seconds), devices)
        finally:
            pipeline.STAGES = None
        names = [e[0] for evs in device.values() for e in evs]
        lost = [k.__name__ for k in ft_kernels.KERNELS
                if k.launches and sum(k.__name__ in x for x in names) < k.launches]
        if device and not lost:
            rec = record.Record((calls[0].t0, calls[-1].t1), calls, pushes, spans.items,
                                device, cards)
            return calls, pushes, rec
        print(f"portbench: recording {n + 1} kept {len(names)} device events and lost "
              f"launches of {lost or 'every kernel'}; recording again", file=sys.stderr)
    raise RuntimeError(f"every one of {RECORDINGS} recordings lost kernels")


def breakdown(rec: record.Record) -> dict:
    ops = sorted(record.device_ops(rec).items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(record.idle_by_label(rec).items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in idle]}


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             seconds_override: list[float] | None = None, t0: float | None = None):
    """(result dict, compared {name: (value, limit)}) of one run; `device`
    "cpu" and `seconds_override` (track lengths) serve the CPU tests."""
    import torch

    import frad_python_tpu_torch as ft
    from frad_python_tpu_torch import kernels as ft_kernels
    from frad_python_tpu_torch.parallel import pipeline

    program_env(cell.config)
    cuda = device != "cpu"
    cards = cell.chips if cuda else 0
    for d in range(cards):
        torch.empty(1, device=f"cuda:{d}")
        torch.cuda.reset_peak_memory_stats(d)
    drv = spec.driver(cell.traffic["driver"])(ft, torch, cell.config, cell.traffic, seed,
                                              device, seconds_override)
    drv.setup()
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - (T0 if t0 is None else t0)
    if trace:
        calls, pushes, rec = traced_window(torch, ft_kernels, pipeline, drv, seconds, cards)
    else:
        calls, pushes = drv.window(seconds)
    peak = max((torch.cuda.max_memory_allocated(d) for d in range(cards)), default=0)
    limit_w = power_limit() if cuda else "not measured"
    gc.unfreeze()
    if cuda:
        torch.cuda.empty_cache()
    numbers = drv.compare(device if not cuda else "cuda:0")
    limits = cell.config["limits"]
    compared = {k: (numbers[k], limits[k]) for k in limits}
    correct = bool(calls) and all(v <= lim for v, lim in compared.values())

    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {**drv.rates(calls), "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cards, "memory_peak_bytes": int(peak), "power_limit": limit_w}
    result = {"correct": correct, "attempted": len(calls), "failed": 0, "metrics": metrics,
              "device": dev}
    if trace:
        busy = [record.covered(rec.busy(c), *rec.window) for c in range(cards)]
        dev["busy_s"] = sum(busy) / len(busy) if busy else 0.0
        dev["window_s"] = rec.window[1] - rec.window[0]
        result["breakdown"] = breakdown(rec)
    result["compared"] = {k: {"value": v if math.isfinite(v) else REFUSED, "limit": lim}
                          for k, (v, lim) in compared.items()}
    return result, compared


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = spec.cell(spec.load(), args.workload)
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", ",".join(map(str, range(cell.chips))))
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s), found {found}",
              file=sys.stderr)
        return 2
    result, compared = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    loaded = forbidden_loaded()
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    for name, (value, limit) in compared.items():
        print(f"compared {name} {value!r} limit {limit!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
