"""Readings that the limits of the comparison are set from, and the
control that each limit must fail (not part of a benchmark run).

    python3 portbench/control.py --config <name> --traffic <name> --seeds 1,2,... [--control-seeds 1,2,3]

For each seed: the album through the program once (one round of the
traffic, no window), and the comparison's numbers of every output:
the program's readings. For each control seed: the plain reference put in
the program's place at the next precision below the configuration's
(`reference.codec.CONTROL`: float32 with its transforms in TF32), judged
by the same comparison. One JSON line a reading on standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if __package__ in (None, ""):
    sys.path.insert(0, str(ROOT))

from portbench import run, spec  # noqa: E402
from portbench.reference import codec, judge  # noqa: E402


def control_numbers(drv, ref_device) -> dict[str, float]:
    """The control's numbers on the streams of one round that `drv` kept."""
    excess = gap = 0.0
    for i, data, pcm in drv.sampled():
        if pcm is not None:
            continue
        p = judge.read(data, drv.jcfg, len(drv.tracks[i]))
        ctl = judge.control_symbols(p, drv.tracks[i], drv.jcfg, ref_device)
        excess = max(excess, judge.encode_excess(ctl, drv.tracks[i], drv.jcfg, ref_device))
        gap = max(gap, judge.pcm_gap(p, judge.decode_pcm(p, drv.jcfg, ref_device, codec.CONTROL),
                                     drv.jcfg, ref_device))
    return {drv.jcfg.rules.EXCESS: excess, "pcm_gap": gap}


def readings(cell: spec.Cell, seed: int, control: bool, device: str = "cuda",
             seconds_override=None) -> dict:
    import torch

    import frad_python_tpu_torch as ft

    run.program_env(cell.config)
    drv = spec.driver(cell.traffic["driver"])(ft, torch, cell.config, cell.traffic, seed,
                                              device, seconds_override)
    drv.setup()
    drv.window(0.0)
    ref = "cuda:0" if device != "cpu" else "cpu"
    out = {"config": cell.config["name"], "traffic": cell.name, "seed": seed,
           "program": drv.compare(ref)}
    if control:
        out["control"] = control_numbers(drv, ref)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    cell = spec.Cell(args.traffic, spec.config(args.config), spec.traffic(args.traffic), 1, [], [])
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        out = readings(cell, seed, seed in ctl)
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
