"""The command refuses to run without the cards its cell asks for, prints
no result then, and keeps its caches and top-level imports within bounds."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import record, run

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("cell", ["p1_track_batch", "p1_track_batch_x4"])
def test_exits_nonzero_without_cuda(cell):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                          str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "frad_python_tpu_torch_like", sys)
    assert "frad_python_tpu" not in run.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_loaded() == ["jax"]


def test_cache_directories_inside_the_checkout():
    """The program's two build caches (the nvcc kernels and the native
    module) lie at fixed paths inside the checkout."""
    from frad_python_tpu_torch.kernels import build as kernels_build
    from frad_python_tpu_torch.native import build as native_build

    for build in (kernels_build, native_build):
        assert Path(build.BUILD_DIR).resolve().is_relative_to(ROOT)


def test_interval_arithmetic():
    merged = record.merge(__import__("numpy").array([[0, 1], [0.5, 2], [3, 4]], dtype=float))
    assert merged.tolist() == [[0, 2], [3, 4]]
    assert record.covered(merged, 1, 3.5) == 1.5
    assert record.gaps(merged, -1, 5).tolist() == [[-1, 0], [2, 3], [4, 5]]


def test_idle_gaps_labelled_by_innermost_span():
    calls = [record.Call("encode", "batch_encode", 1.0, 3.0, 10, 1e-6)]
    rec = record.Record((0.5, 3.5), calls, spans=[("enc:pack", 1.5, 2.0)],
                        device={0: [("k", 2.5, 2.8)]})
    idle = record.idle_by_label(rec)
    assert idle == pytest.approx({"portbench:window": 1.0, "batch_encode": 1.2,
                                  "enc:pack": 0.5})
    assert record.idle_share(rec, ("encode",)) == pytest.approx(85.0)
    assert json.dumps(run.breakdown(rec))
