"""The armored cell `p1_ecc_damaged_batch` on the CPU: its damage is fixed
by the seed, capped at the code's capacity a codeword and never touches a
header; the whole cell (`run.run_cell`, short tracks, a window of one
round) comes out correct; and planted faults come out not correct: the
decode without repair, one parity byte altered where `frame_pack_batch`
writes it, one repaired byte left wrong in `unarmor_batch`'s output. The
control fails a limit of the configuration."""

import numpy as np
import pytest

from frad_python_tpu_torch import native
from portbench import control, run, spec
from portbench.drivers.damaged_batch import codewords, damage
from portbench.reference import ecc, profile1_ecc
from portbench.tests import cells

CELL = "p1_ecc_damaged_batch"
TRACKS = [1.0, 1.3]
SEED = 2 ** 31 + 2102


def outcome() -> dict:
    result, _ = run.run_cell(cells.cell(CELL), SEED, 0.0, False, device="cpu",
                             seconds_override=TRACKS)
    return result


@pytest.fixture(scope="module")
def stream():
    import torch

    import frad_python_tpu_torch as ft

    c = cells.cell(CELL)
    run.program_env(c.config)
    drv = spec.driver(c.traffic["driver"])(ft, torch, c.config, c.traffic, SEED, "cpu",
                                           TRACKS)
    return ft.batch_encode(drv.tracks[1], device="cpu", **drv.enc_kw)


def test_damage_fixed_by_the_seed_capped_and_off_the_headers(stream):
    a = damage(stream, SEED, 1, 256, 12)
    assert a == damage(stream, SEED, 1, 256, 12)
    assert a != damage(stream, SEED + 1, 1, 256, 12) != damage(stream, SEED, 2, 256, 12)
    begin, end = codewords(stream)
    inside = np.zeros(len(stream), dtype=bool)
    for b, e in zip(begin, end):
        inside[b:e] = True
    for one_in, cap in ((256, 12), (8, 12), (16, 6)):
        d = damage(stream, SEED, 1, one_in, cap)
        diff = np.frombuffer(stream, np.uint8) != np.frombuffer(d, np.uint8)
        assert len(d) == len(stream) and diff.any() and not (diff & ~inside).any()
        per = np.array([diff[b:e].sum() for b, e in zip(begin, end)])
        assert per.max() <= cap
    heads = profile1_ecc.headers(stream)
    assert [(h.pos, h.length) for h in heads] == \
        [(h.pos, h.length) for h in profile1_ecc.headers(d)]
    payload = [h for h in heads if not h.terminator]
    for d in (a, damage(stream, SEED, 1, 16, 6)):
        crcs = ecc.crc16([d[h.start:h.start + h.length] for h in payload])
        assert all(c != h.crc for c, h in zip(crcs.tolist(), payload))


def test_a_damaged_frame_whose_crc_matches_is_drawn_again(stream, monkeypatch):
    """A first CRC check that finds every damaged frame still matching (made
    so here) draws every frame again: the copy differs from the one drawn
    without, and fails every CRC."""
    heads = [h for h in profile1_ecc.headers(stream) if not h.terminator]
    plain = damage(stream, SEED, 1, 8, 24)
    crc16, calls = ecc.crc16, []

    def first_matches(payloads):
        calls.append(len(payloads))
        if len(calls) == 1:
            return np.array([h.crc for h in heads])
        return crc16(payloads)
    monkeypatch.setattr(ecc, "crc16", first_matches)
    again = damage(stream, SEED, 1, 8, 24)
    monkeypatch.undo()
    assert calls[:2] == [len(heads), len(heads)] and again != plain
    crcs = ecc.crc16([again[h.start:h.start + h.length] for h in heads])
    assert all(c != h.crc for c, h in zip(crcs.tolist(), heads))


def test_the_cell_is_correct():
    result = outcome()
    assert result["correct"] is True, result["compared"]
    assert set(result["metrics"]) == {"encode_frames_per_s", "decode_frames_per_s", "setup_s"}


def _no_repair(monkeypatch):
    """Every decode of the window without repair."""
    import frad_python_tpu_torch as ft

    decode = ft.batch_decode
    monkeypatch.setattr(ft, "batch_decode",
                        lambda data, **kw: decode(data, **dict(kw, fix_error=False)))


def _parity_altered(monkeypatch):
    """One parity byte of the first frame of each pass altered, and its
    CRC-16 made to agree, so that only the parity departs."""
    pack = native.frame_pack_batch

    def broken(*args, **kw):
        out = bytearray(pack(*args, **kw))
        h = profile1_ecc.headers(bytes(out))[0]
        out[h.start + min(h.length - 1, kw["ecc_dsize"])] ^= 0x21
        crc = int(ecc.crc16([bytes(out[h.start:h.start + h.length])])[0])
        out[h.pos + 14:h.pos + 16] = crc.to_bytes(2, "big")
        return bytes(out)
    monkeypatch.setattr(native, "frame_pack_batch", broken)


def _repaired_byte_wrong(monkeypatch):
    """One byte in the middle of the first repaired payload of each pass
    left wrong."""
    unarmor = native.unarmor_batch

    def broken(payloads, dsize, csize, crcs, crc_is16, fix_error, **kw):
        raws, ok = unarmor(payloads, dsize, csize, crcs, crc_is16, fix_error, **kw)
        fixed = [i for i, p in enumerate(payloads)
                 if native.crc16_ansi(p) != int(crcs[i])]
        if fixed:
            i = fixed[0]
            raw = bytearray(raws[i])
            raw[len(raw) // 2] ^= 0x10
            raws[i] = bytes(raw)
        return raws, ok
    monkeypatch.setattr(native, "unarmor_batch", broken)


FAULTS = {"no_repair": _no_repair, "parity_byte_altered": _parity_altered,
          "repaired_byte_wrong": _repaired_byte_wrong}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_is_not_correct(monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    result = outcome()
    assert result["correct"] is False, result["compared"]


def test_control_fails_a_limit_and_program_passes():
    c = cells.cell(CELL)
    out = control.readings(c, 2 ** 31 + 11, True, device="cpu", seconds_override=[1.5, 2.0])
    limits = c.config["limits"]
    assert all(v <= limits[k] for k, v in out["program"].items()), out
    assert any(v > limits[k] for k, v in out["control"].items()), out


def test_the_ratio_is_the_configuration_s():
    assert tuple(spec.config("p1_ecc_stereo_44k1")["ecc_ratio"]) == profile1_ecc.ECC_RATIO


def _pass(t0, t1, busy_s, frames):
    return native.Pass(t0=t0, t1=t1, frames=frames, threads=3, cpus=8, cpu_quota=None,
                       busy_s=busy_s, live_s=3 * (t1 - t0), phase_s={}, bytes_in=0, bytes_out=0,
                       first=t0, last=t1)


def test_armor_readers_worked_example(monkeypatch):
    from portbench import record

    calls = [record.Call("encode", "batch_encode", 1.0, 3.0, 100, 1e-6),
             record.Call("decode", "batch_decode", 3.0, 5.0, 100, 1e-6)]
    rec = record.Record((0.5, 5.5), calls, spans=[("dec:ecc", 3.5, 4.0), ("dec:ecc", 4.8, 5.4),
                                                   ("enc:frame", 2.0, 2.5)])
    passes = [_pass(1.5, 2.0, 1.0, 500), _pass(3.5, 3.9, 2.0, 400), _pass(5.2, 5.3, 9.0, 7)]
    monkeypatch.setattr(native.frame_pack_batch, "passes", passes)
    monkeypatch.setattr(native.unarmor_batch, "passes", passes)
    assert spec.reader("native.armor_us_per_frame.enc")(rec) == pytest.approx(1e6 * 1.0 / 500)
    assert spec.reader("native.unarmor_us_per_frame.dec")(rec) == pytest.approx(1e6 * 2.0 / 400)
    assert spec.reader("native.unarmor_parallelism.dec")(rec) == pytest.approx(2.0 / 0.4)
    # 0.5 s and the 0.2 s of the second span inside the decode call's 2 s
    assert spec.reader("pipeline.host_ecc_share.dec")(rec) == pytest.approx(35.0)
    rec.spans = [("enc:frame", 2.0, 2.5)]
    assert spec.reader("pipeline.host_ecc_share.dec")(rec) is None
    for wrapper in (native.frame_pack_batch, native.unarmor_batch):
        monkeypatch.delattr(wrapper, "passes")
    for name in ("native.armor_us_per_frame.enc", "native.unarmor_us_per_frame.dec",
                 "native.unarmor_parallelism.dec"):
        assert spec.reader(name)(rec) is None
