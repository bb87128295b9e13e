"""The reader of the lossy encode's host staging spans, on synthetic
records: it reads the encode calls' wall under the native staging pass and
under the gather and cast of the route before it, so that a program with
either route reports it, and finds nothing (None) where no span was kept."""

import pytest

from portbench import record, spec


def _rec(spans=()):
    calls = [record.Call("encode", "batch_encode", 1.0, 3.0, 100, 1e-6),
             record.Call("decode", "batch_decode", 3.0, 5.0, 100, 1e-6),
             record.Call("encode", "batch_encode", 5.0, 6.0, 50, 1e-6)]
    return record.Record((0.5, 6.5), calls, spans=list(spans))


def test_stage_share_worked_example():
    read = spec.reader("pipeline.host_stage_share.enc")
    assert read(_rec()) is None                                  # no spans
    assert read(_rec([("enc:pack", 1.0, 1.5)])) == 0.0           # spans, none of the three
    spans = [("enc:gather", 1.0, 1.4), ("enc:host-conv", 1.4, 1.6), ("enc:stage", 5.0, 5.3),
             ("enc:stage", 3.2, 3.6), ("enc:pack", 1.6, 2.0)]
    # (0.4 + 0.2) s of the first encode call and 0.3 s of the second, over 3 s
    assert read(_rec(spans)) == pytest.approx(30.0)


@pytest.mark.parametrize("stage", ["enc:gather", "enc:host-conv", "enc:stage"])
def test_stage_share_reads_each_span(stage):
    """Each of the three spans counts alone: the parent's route has the
    first two, the native route the third."""
    read = spec.reader("pipeline.host_stage_share.enc")
    assert read(_rec([(stage, 1.5, 2.1)])) == pytest.approx(20.0)
