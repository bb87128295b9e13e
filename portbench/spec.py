"""The benchmark's data, found by name: `BENCHMARK.json` at the root of the
checkout lists the cells and metrics; a cell's configuration is
`portbench/configs/<config>.json`, which names its judge module
`portbench/reference/<judge>.py`; its traffic is
`portbench/traffic/<traffic>.json`, which names its driver
`portbench/drivers/<driver>.py`; each per-layer metric's reader is
`portbench/metrics/<name>.py`. Adding a cell, a configuration, a traffic
mix or a kind of traffic, a profile's judge or a metric is adding files
and entries."""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list[dict]
    per_layer: list[dict]


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def config(name: str) -> dict:
    with open(HERE / "configs" / f"{name}.json") as f:
        return json.load(f)


def traffic(name: str) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as f:
        return json.load(f)


def driver(name: str):
    """The driver class of the traffic kind `name` (`drivers/<name>.py`)."""
    return importlib.import_module(f"{__package__}.drivers.{name}").DRIVER


def reader(name: str):
    """The `read(record) -> float | None` of the per-layer metric `name`."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reports(metric: dict, cell: str, e2e_of_cell: set[str] | None = None) -> bool:
    """Whether `cell` reports `metric`: listed in its `workloads`, or, with
    none listed, an end-to-end metric every cell reports, or a per-layer
    metric whose end-to-end metric the cell reports."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if e2e_of_cell is None:
        return True
    return metric["moves"] in e2e_of_cell


def cell(bench: dict, name: str) -> Cell:
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    return Cell(name, config(entry["config"]), traffic(entry["traffic"]), entry["chips"],
                e2e, layer)
