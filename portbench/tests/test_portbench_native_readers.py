"""The readers of the native passes' counters and of the emit span, on
synthetic records and pass logs: a pass counts where it starts inside a
call of the reader's kind, and a reader finds nothing (None) where no pass
or span falls inside, or where the program keeps no pass log."""

import pytest

from frad_python_tpu_torch import native
from portbench import record, spec

ENC = "native.pack_parallelism.enc", "native.pack_us_per_frame.enc"
DEC = "native.unpack_parallelism.dec", "native.unpack_us_per_frame.dec"


def _rec(spans=()):
    calls = [record.Call("encode", "batch_encode", 1.0, 3.0, 100, 1e-6),
             record.Call("decode", "batch_decode", 3.0, 5.0, 100, 1e-6),
             record.Call("encode", "batch_encode", 5.0, 6.0, 50, 1e-6)]
    return record.Record((0.5, 6.5), calls, spans=list(spans))


def _pass(t0, t1, busy_s, frames):
    return native.Pass(t0=t0, t1=t1, frames=frames, threads=3, cpus=8, cpu_quota=None,
                       busy_s=busy_s, live_s=3 * (t1 - t0), phase_s={}, bytes_in=0, bytes_out=0,
                       first=t0, last=t1)


#: two passes in the encode calls, one in the decode call, one in none
PASSES = [_pass(1.5, 2.0, 1.25, 500), _pass(5.2, 5.7, 1.0, 1500), _pass(3.5, 3.9, 9.0, 7),
          _pass(6.1, 6.3, 9.0, 7)]


@pytest.fixture
def logs(monkeypatch):
    def set_logs(pack, unpack):
        monkeypatch.setattr(native.p1_pack_batch, "passes", list(pack))
        monkeypatch.setattr(native.p1_unpack_batch, "passes", list(unpack))
    return set_logs


def test_pack_readers_worked_example(logs):
    logs(PASSES, [])
    # busy (1.25 + 1.0) s over the passes' wall (0.5 + 0.5) s, and per frame
    assert spec.reader(ENC[0])(_rec()) == pytest.approx(2.25)
    assert spec.reader(ENC[1])(_rec()) == pytest.approx(1e6 * 2.25 / 2000)
    assert spec.reader(DEC[0])(_rec()) is None and spec.reader(DEC[1])(_rec()) is None


def test_unpack_readers_worked_example(logs):
    logs([], PASSES)
    # only the pass that starts inside the decode call: 9.0 s over 0.4 s, 7 frames
    assert spec.reader(DEC[0])(_rec()) == pytest.approx(9.0 / 0.4)
    assert spec.reader(DEC[1])(_rec()) == pytest.approx(1e6 * 9.0 / 7)


@pytest.mark.parametrize("name", ENC + DEC)
def test_passes_outside_the_calls_give_none(logs, name):
    logs([], [])
    assert spec.reader(name)(_rec()) is None
    outside = [_pass(0.6, 0.9, 1.0, 10), _pass(6.1, 6.3, 1.0, 10), _pass(0.9, 1.2, 1.0, 10)]
    logs(outside, outside)
    assert spec.reader(name)(_rec()) is None


@pytest.mark.parametrize("name", ENC + DEC)
def test_a_program_without_pass_logs_gives_none(monkeypatch, name):
    monkeypatch.delattr(native.p1_pack_batch, "passes")
    monkeypatch.delattr(native.p1_unpack_batch, "passes")
    assert spec.reader(name)(_rec()) is None


def test_emit_share_worked_example():
    read = spec.reader("pipeline.host_emit_share.dec")
    assert read(_rec()) is None
    assert read(_rec([("dec:unpack", 3.0, 3.5)])) is None     # a program without the span
    spans = [("dec:emit", 3.5, 4.0), ("dec:emit", 4.8, 5.2), ("dec:emit", 1.5, 2.5),
             ("dec:unpack", 3.0, 3.5)]
    # 0.5 s and the 0.2 s of the second span inside the decode call's 2 s
    assert read(_rec(spans)) == pytest.approx(35.0)
