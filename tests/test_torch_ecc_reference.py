"""The port's Reed-Solomon armor and repair against the benchmark's plain
reference (`portbench/reference/ecc.py`, `profile1_ecc.py`), on the CPU at
a small size on seeded data: `frame_pack_batch`'s armor and CRC-16 byte for
byte, a Profile 1 clip with ECC that the reference judge reads with no
fault, the repaired decode of a copy damaged by the benchmark's own
damage against the decode of the clean stream, and the counters of the
armor and unarmor passes against what the damage put in."""

import numpy as np
import pytest

import frad_python_tpu_torch as ft
from frad_python_tpu_torch import native
from frad_python_tpu_torch.common import crc16_ansi
from frad_python_tpu_torch.container import ecc as port_ecc
from frad_python_tpu_torch.models.profiles import compact
from frad_python_tpu_torch.parallel import pipeline
from frad_python_tpu_torch.utils.tracing import StageTimer
from portbench import audio, spec
from portbench.drivers.damaged_batch import codewords, damage
from portbench.reference import ecc, judge, profile1_ecc

CFG = spec.config("p1_ecc_stereo_44k1")
RATIO = tuple(CFG["ecc_ratio"])
KW = dict(compute_dtype="float32", device="cpu")
ENC = dict(KW, loss_level=CFG["loss_level"], overlap_ratio=CFG["overlap_ratio"],
           enable_ecc=True, ecc_ratio=RATIO)
SEED = 2 ** 31 + 2101


def _payloads(lengths, seed=21):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in lengths]


def _frame_pack(payloads, **kw):
    n = len(payloads)
    return native.frame_pack_batch(
        payloads, np.full(n, 2, np.uint8), np.full(n, 2048, np.uint32),
        np.full(n, compact.get_samples_index(2048), np.uint8), profile=1, is_compact=True,
        channels=2, srate=44100, srate_idx=compact.get_srate_index(44100), overlap_ratio=16,
        ecc=True, ecc_dsize=RATIO[0], ecc_codesize=RATIO[1], **kw)


@pytest.fixture(scope="module")
def clip():
    """A 2 s clip of the benchmark's album, its armored stream, and a copy
    damaged at the cell's rate."""
    (pcm,) = audio.album([2.0], CFG["srate"], CFG["channels"], CFG["bit_depth"], SEED, "cpu")
    stream = ft.batch_encode(pcm, CFG["profile"], CFG["srate"], CFG["bit_depth"],
                             CFG["frame_size"], **ENC)
    return pcm, stream, damage(stream, SEED, 0, 256, 12)


@pytest.mark.parametrize("length", [0, 1, 95, 96, 97, 3000])
def test_frame_pack_batch_armor_and_crc_against_the_reference(length):
    payloads = _payloads([length, 500, length])
    data = _frame_pack(payloads)
    heads = profile1_ecc.headers(data)
    assert [h.length for h in heads] == [len(ecc.armor(p, *RATIO)) for p in payloads]
    for h, p in zip(heads, payloads):
        armored = data[h.start:h.start + h.length]
        assert armored == ecc.armor(p, *RATIO) == port_ecc.encode(p, *RATIO)
        assert (h.dsize, h.csize) == RATIO
        assert h.crc == int(ecc.crc16([armored])[0]) == crc16_ansi(armored)


def test_reference_parity_is_a_codeword():
    """The reference's parity makes each block a multiple of g(x): the
    codeword's value at each root alpha^i is 0."""
    (p,) = _payloads([300])
    armored = np.frombuffer(ecc.armor(p, *RATIO), np.uint8)
    for cw in (armored[:120], armored[240:]):
        for i in range(RATIO[1]):
            acc = 0
            for byte in cw.tolist():
                acc = int(ecc.gf_mul(acc, ecc.EXP[i])) ^ byte
            assert acc == 0


def test_clip_with_ecc_judged_sound(clip):
    pcm, stream, _ = clip
    cfg = judge.Config.of(CFG)
    parsed = judge.read(stream, cfg, len(pcm))
    assert parsed.faults == 0 and parsed.frames
    assert judge.encode_excess(parsed, pcm, cfg, "cpu") <= CFG["limits"][cfg.rules.EXCESS]


def test_judge_refuses_a_departing_armor(clip):
    _, stream, _ = clip
    h = profile1_ecc.headers(stream)[3]
    parity_at = h.start + RATIO[0]
    bad = bytearray(stream)
    bad[parity_at] ^= 0x5A
    with pytest.raises(profile1_ecc.StreamError, match="CRC-16"):
        profile1_ecc.parse(bytes(bad))
    crc = int(ecc.crc16([bytes(bad[h.start:h.start + h.length])])[0])
    bad[h.pos + 14:h.pos + 16] = crc.to_bytes(2, "big")
    with pytest.raises(profile1_ecc.StreamError, match="parity"):
        profile1_ecc.parse(bytes(bad))
    other = bytearray(stream)
    other[h.pos + 13] = 16
    with pytest.raises(profile1_ecc.StreamError, match="ratio"):
        profile1_ecc.parse(bytes(other))


def test_fix_error_decode_of_a_damaged_copy_equals_the_clean_decode(clip):
    _, stream, damaged = clip
    assert len(damaged) == len(stream) and damaged != stream
    clean, _ = ft.batch_decode(stream, **KW)
    fixed, _ = ft.batch_decode(damaged, fix_error=True, **KW)
    np.testing.assert_array_equal(fixed, clean)
    unfixed, _ = ft.batch_decode(damaged, fix_error=False, **KW)
    assert unfixed.shape != clean.shape or not np.array_equal(unfixed, clean)


def test_fix_error_repairs_only_frames_whose_crc_fails(clip):
    """The format's rule, which the damage keeps to: a damaged frame whose
    CRC-16 still matches (here made to match) is decoded unrepaired."""
    _, stream, _ = clip
    h = profile1_ecc.headers(stream)[5]
    bad = bytearray(stream)
    bad[h.start + 7] ^= 0x40
    crc = int(ecc.crc16([bytes(bad[h.start:h.start + h.length])])[0])
    clean, _ = ft.batch_decode(stream, **KW)
    np.testing.assert_array_equal(ft.batch_decode(bytes(bad), fix_error=True, **KW)[0], clean)
    bad[h.pos + 14:h.pos + 16] = crc.to_bytes(2, "big")
    fixed, _ = ft.batch_decode(bytes(bad), fix_error=True, **KW)
    assert not np.array_equal(fixed, clean)


def _damage_tally(stream: bytes, damaged: bytes):
    """(payload frames, frames with a damaged byte, codewords of those
    frames, codewords with a damaged byte) of a damaged copy."""
    diff = np.frombuffer(stream, np.uint8) != np.frombuffer(damaged, np.uint8)
    heads = [h for h in profile1_ecc.headers(stream) if not h.terminator]
    hurt = [bool(diff[h.start:h.start + h.length].any()) for h in heads]
    begin, end = codewords(stream)
    cw_hurt = np.array([diff[a:b].any() for a, b in zip(begin, end)])
    frame_of = np.searchsorted([h.start for h in heads], begin, side="right") - 1
    in_hurt = np.array(hurt)[frame_of]
    return len(heads), sum(hurt), int(in_hurt.sum()), int(cw_hurt.sum())


@pytest.mark.parametrize("nthreads", [1, None])
def test_unarmor_counters_equal_what_the_damage_put_in(clip, nthreads):
    _, stream, damaged = clip
    heads = [h for h in profile1_ecc.headers(damaged) if not h.terminator]
    payloads = [damaged[h.start:h.start + h.length] for h in heads]
    crcs = np.array([h.crc for h in heads], np.uint32)
    native.reset_calls()
    raws, ok = native.unarmor_batch(payloads, *RATIO, crcs, True, True, nthreads=nthreads,
                                    stats=True)
    again, ok_again = native.unarmor_batch(payloads, *RATIO, crcs, True, True,
                                           nthreads=nthreads)
    assert ok.all() and ok_again.all() and again == raws
    (p,) = native.unarmor_batch.passes
    frames, hurt, decoded, corrected = _damage_tally(stream, damaged)
    assert p.frames == frames and hurt > 0 and corrected > 0
    assert p.counts == {"crc_failed": hurt, "decoded": decoded, "corrected": corrected,
                        "beyond_repair": 0}
    assert tuple(p.phase_s) == ("crc", "syndromes", "repair")
    assert sum(p.phase_s.values()) == pytest.approx(p.live_s, rel=0.01)
    assert p.threads == (nthreads or native.pass_workers(frames))
    assert p.bytes_in == sum(map(len, payloads)) and p.bytes_out == sum(map(len, raws))
    assert p.t0 <= p.first <= p.last <= p.t1


def test_frame_pack_counters():
    payloads = _payloads([0, 1, 95, 96, 97, 3000] * 3)
    native.reset_calls()
    data = _frame_pack(payloads, stats=True)
    assert data == _frame_pack(payloads)
    (p,) = native.frame_pack_batch.passes
    assert p.frames == len(payloads) and p.counts == {}
    assert tuple(p.phase_s) == ("rs_encode", "crc_header")
    assert p.bytes_in == sum(map(len, payloads))
    assert p.bytes_out == sum(len(ecc.armor(x, *RATIO)) for x in payloads)
    assert 0 < p.live_s and sum(p.phase_s.values()) == pytest.approx(p.live_s, rel=0.01)


def test_pipeline_logs_armor_passes_only_under_a_stage_timer(clip):
    pcm, stream, damaged = clip
    args = (CFG["profile"], CFG["srate"], CFG["bit_depth"], CFG["frame_size"])
    native.reset_calls()
    ft.batch_encode(pcm, *args, **ENC)
    ft.batch_decode(damaged, fix_error=True, **KW)
    assert not native.frame_pack_batch.passes and not native.unarmor_batch.passes
    try:
        pipeline.STAGES = timer = StageTimer()
        assert ft.batch_encode(pcm, *args, **ENC) == stream
        fixed, _ = ft.batch_decode(damaged, fix_error=True, **KW)
    finally:
        pipeline.STAGES = None
    np.testing.assert_array_equal(fixed, ft.batch_decode(stream, **KW)[0])
    assert timer.counts["enc:frame-native"] == len(native.frame_pack_batch.passes) >= 1
    assert timer.counts["dec:unarmor-native"] == len(native.unarmor_batch.passes) >= 1
    frames = len([h for h in profile1_ecc.headers(stream) if not h.terminator])
    assert sum(p.frames for p in native.unarmor_batch.passes) == frames
    assert sum(p.counts["crc_failed"] for p in native.unarmor_batch.passes) \
        == _damage_tally(stream, damaged)[1]
