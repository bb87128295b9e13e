"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a chip (`run.run_cell` on the CPU,
short tracks, a window of one round) and plants one fault in the
program's cores, where the window's calls reach them: half of a batch left
out, an answer altered where it is produced, a carried state left
unchanged, and in the four-card cell the halo exchange between cards left
out."""

import pytest
import torch

from portbench import run
from portbench.tests import cells
from frad_python_tpu_torch.models import batch

TRACKS = [1.0, 1.3]


def outcome(cell: str) -> dict:
    result, compared = run.run_cell(cells.cell(cell), 2 ** 31 + 5, 0.0, False, device="cpu",
                                    seconds_override=TRACKS)
    return result


def half_rows(fn, *, on_output: bool):
    def broken(x, *args, **kw):
        if not on_output:
            x = x.clone()
            x[x.shape[0] // 2:] = 0
            return fn(x, *args, **kw)
        out = fn(x, *args, **kw)
        first = out[0] if isinstance(out, tuple) else out
        first[first.shape[0] // 2:] = 0
        return out
    return broken


def altered(fn, *, on_output: bool, by: float):
    def broken(x, *args, **kw):
        if not on_output:
            x = x.clone()
            x.view(-1)[5] += by
            return fn(x, *args, **kw)
        out = fn(x, *args, **kw)
        first = out[0] if isinstance(out, tuple) else out
        first[tuple(min(n - 1, i) for n, i in zip(first.shape, (0, 700, 1)))] += by
        return out
    return broken


def frag_unchanged(fn):
    def broken(*args, **kw):
        out, frag = fn(*args, **kw)
        return out, torch.zeros_like(frag)
    return broken


def no_halo(fn):
    def broken(pcm, olap, cut, i16, halo=None):
        return fn(pcm, olap, cut, i16, None)
    return broken


def sound_first(cell):
    assert outcome(cell)["correct"], cell


P1_FAULTS = {
    "encode_half_left_out": ("p1_encode_core", lambda f: half_rows(f, on_output=True)),
    "encode_symbol_altered": ("p1_encode_core", lambda f: altered(f, on_output=True, by=1)),
    "decode_half_left_out": ("p1_decode_core", lambda f: half_rows(f, on_output=True)),
    "decode_sample_altered": ("_overlap_add_emit",
                              lambda f: altered(f, on_output=True, by=1 / 32768)),
    "decode_state_unchanged": ("_overlap_add_emit", frag_unchanged),
}
P0_FAULTS = {
    "encode_half_left_out": ("p0_encode_pack_core", lambda f: half_rows(f, on_output=False)),
    "encode_sample_altered": ("p0_encode_pack_core",
                              lambda f: altered(f, on_output=False, by=1e-3)),
    "decode_half_left_out": ("p0_unpack_decode_core", lambda f: half_rows(f, on_output=True)),
    "decode_sample_altered": ("p0_unpack_decode_core",
                              lambda f: altered(f, on_output=True, by=2.0 ** -15)),
}


@pytest.mark.parametrize("cell", ["p1_track_batch", "p1_track_stream"])
@pytest.mark.parametrize("fault", list(P1_FAULTS))
def test_p1_fault_is_not_correct(monkeypatch, cell, fault):
    name, plant = P1_FAULTS[fault]
    monkeypatch.setattr(batch, name, plant(getattr(batch, name)))
    result = outcome(cell)
    assert result["correct"] is False, result["compared"]


@pytest.mark.parametrize("fault", list(P0_FAULTS))
def test_p0_fault_is_not_correct(monkeypatch, fault):
    name, plant = P0_FAULTS[fault]
    monkeypatch.setattr(batch, name, plant(getattr(batch, name)))
    result = outcome("p0_track_batch")
    assert result["correct"] is False, result["compared"]


@pytest.fixture
def four_blocks(monkeypatch):
    """The frame-batch split over four blocks, as on four cards (the port's
    own CPU tests stand the CPU in for each card)."""
    cpu = torch.device("cpu")
    monkeypatch.setattr(batch, "_data_devices", lambda d: [cpu] * 4)


def test_four_card_cell_sound_with_its_split(four_blocks):
    sound_first("p1_track_batch_x4")


def test_four_card_cell_halo_left_out(four_blocks, monkeypatch):
    monkeypatch.setattr(batch, "_overlap_add_emit", no_halo(batch._overlap_add_emit))
    result = outcome("p1_track_batch_x4")
    assert result["correct"] is False, result["compared"]


@pytest.mark.parametrize("cell", ["p1_track_batch", "p0_track_batch", "p1_track_stream"])
def test_sound_run_is_correct(cell):
    sound_first(cell)
