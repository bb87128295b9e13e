"""BENCHMARK.json and the files it names: found by name, complete, and
within the limits the BENCHMARK.json format sets on names, units and cells."""

import json
import re

import pytest

from portbench import spec
from portbench.drivers import Driver
from portbench.reference import judge

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.load()
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
CELLS = {w["name"]: w for w in BENCH["workloads"]}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + list(CELLS) + list(E2E) \
        + [m["name"] for m in BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in CELLS.values():
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_complete(cfg):
    assert cfg["file"] == f"portbench/configs/{cfg['name']}.json"
    body = spec.config(cfg["name"])
    assert body["source"] == cfg["source"] and body["reduced"] == cfg["reduced"]
    for key in ("profile", "srate", "channels", "bit_depth", "frame_size", "compute_dtype",
                "limits"):
        assert key in body, key
    assert "plan_faults" in body["limits"]
    rules = judge.Config.of(body).rules
    assert rules.__file__ == str(spec.HERE / "reference" / f"{body['judge']}.py")
    assert rules.EXCESS in body["limits"]
    assert all(k in body for k in body["encode_args"])
    assert 1 <= len(cfg["source"]) <= 200


@pytest.mark.parametrize("cell", list(CELLS))
def test_cell_files_found_by_name(cell):
    c = spec.cell(BENCH, cell)
    assert issubclass(spec.driver(c.traffic["driver"]), Driver)
    assert c.chips in (1, 4)
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.per_layer:
        assert callable(spec.reader(m["name"]))


def test_per_layer_metric_moves_a_reported_metric():
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in E2E, m["name"]
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
        for cell in m.get("workloads", CELLS):
            assert spec.reports(E2E[m["moves"]], cell), (m["name"], cell)
    assert all(len(v) == 1 for v in layers.values())


def test_every_metric_has_a_source():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_four_chip_cells_at_most_a_quarter():
    four = sum(w["chips"] == 4 for w in CELLS.values())
    assert four <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("path", sorted((spec.HERE / "metrics").glob("*.py")), ids=lambda p: p.stem)
def test_every_reader_file_loads(path):
    assert callable(spec.reader(path.stem))


@pytest.mark.parametrize("path", sorted((spec.HERE / "traffic").glob("*.json")), ids=lambda p: p.stem)
def test_every_traffic_file_names_a_driver_file(path):
    name = spec.traffic(path.stem)["driver"]
    assert (spec.HERE / "drivers" / f"{name}.py").is_file()
    drv = spec.driver(name)
    assert issubclass(drv, Driver)
    for method in ("setup", "window", "sampled", "rates"):
        assert callable(getattr(drv, method)), method


@pytest.mark.parametrize("path", sorted((spec.HERE / "configs").glob("*.json")), ids=lambda p: p.stem)
def test_every_config_file_names_a_judge_file(path):
    body = spec.config(path.stem)
    assert body["name"] == path.stem
    assert (spec.HERE / "reference" / f"{body['judge']}.py").is_file()
    rules = judge.Config.of(body).rules
    for attr in ("COMPACT", "EXCESS", "parse", "symbols", "excess", "synthesis", "control"):
        assert hasattr(rules, attr), attr
    assert {"plan_faults", rules.EXCESS} <= set(body["limits"])
