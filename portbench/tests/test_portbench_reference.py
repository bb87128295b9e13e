"""The plain reference's plumbing at a tiny size: its Exp-Golomb-Rice
reader against a scalar writer, its reading and decoding of the program's
streams (the program runs on the CPU here), and the numbers it gives for
sound and for altered outputs."""

import math

import numpy as np
import pytest
import torch

from portbench.reference import codec, judge, stream

P1 = judge.Config("profile1", 1, 44100, 2, 16, 2048, 16, 1.25 ** 0 / 19 + 0.5)
P0 = judge.Config("profile0", 0, 44100, 2, 24, 2048, 0, 0.0)


def egr_write(values: list[int]) -> bytes:
    """Scalar Exp-Golomb-Rice writer, from the format's definition."""
    dmax = max((abs(v) for v in values), default=0)
    k = math.ceil(math.log2(dmax)) if dmax else 0
    bits = []
    for x in values:
        v = (2 * x - 1 if x > 0 else -2 * x) + (1 << k)
        digits = bin(v)[2:]
        bits += [0] * (len(digits) - k - 1) + [int(d) for d in digits]
    bits += [0] * (-len(bits) % 8)
    return bytes([k]) + bytes(int("".join(map(str, bits[i:i + 8])), 2)
                              for i in range(0, len(bits), 8))


@pytest.mark.parametrize("scale", [0, 1, 7, 300, 40000])
def test_egr_reader_against_scalar_writer(scale):
    rng = np.random.default_rng(scale)
    rows = [list(rng.integers(-scale, scale + 1, size=37)) for _ in range(5)]
    got = stream.egr_decode([egr_write(r) for r in rows], 37)
    assert np.array_equal(got, np.array(rows))


def test_egr_reader_refuses_short_and_long_streams():
    blob = egr_write([3, -2, 0, 5])
    with pytest.raises(stream.StreamError):
        stream.egr_decode([blob], 5)
    with pytest.raises(stream.StreamError):
        stream.egr_decode([blob + b"\x80"], 4)


def test_frame_plan_matches_the_formats_arithmetic():
    plan, terms = judge.frame_plan(44100, P1)
    assert [p[0] for p in plan[:3]] == [0, 1920, 3840] and terms == 2
    assert plan[-1][1] == 44100 - plan[-1][0] and plan[-1][2] == 2048
    plan0, terms0 = judge.frame_plan(44100, P0)
    assert plan0[-1] == (43008, 1092, 1092) and terms0 == 0


def _tone(seconds: float, bits: int) -> np.ndarray:
    t = np.arange(int(seconds * 44100)) / 44100
    x = 0.3 * np.sin(2 * np.pi * 330 * t)[:, None] * np.array([[1.0, 0.7]])
    x += 0.01 * np.random.default_rng(1).standard_normal(x.shape)
    return np.round(x * 2.0 ** (bits - 1)) / 2.0 ** (bits - 1)


@pytest.fixture(scope="module")
def port():
    import frad_python_tpu_torch as ft
    return ft


def test_p1_program_output_sound_and_altered(port):
    pcm = _tone(1.0, 16)
    s = port.batch_encode(pcm, 1, 44100, 16, 2048, loss_level=P1.loss_level, device="cpu")
    out, _ = port.batch_decode(s, device="cpu")
    p = judge.read(s, P1, len(pcm))
    assert p.faults == 0 and len(p.frames) == len(judge.frame_plan(len(pcm), P1)[0])
    assert judge.encode_excess(p, pcm, P1, "cpu") < 1e-3
    assert judge.pcm_gap(p, out, P1, "cpu") < 2e-6
    (n, (idx, freqs, thres)), = p.symbols.items()
    freqs[3, 10, 0] += 1
    assert judge.encode_excess(p, pcm, P1, "cpu") >= 0.5
    bad = out.copy()
    bad[5000, 1] += 1.0 / 32768
    assert judge.pcm_gap(judge.read(s, P1, len(pcm)), bad, P1, "cpu") >= 1.0 / 32768
    assert judge.read(s[:-40], P1, len(pcm)).faults
    assert judge.read(s, P1, len(pcm) + 5000).faults


def test_p0_program_output_sound_and_altered(port):
    pcm = _tone(1.0, 24)
    s = port.batch_encode(pcm, 0, 44100, 24, 2048, device="cpu")
    out, _ = port.batch_decode(s, device="cpu")
    p = judge.read(s, P0, len(pcm))
    assert p.faults == 0
    assert judge.encode_excess(p, pcm, P0, "cpu") < 1e-6
    assert judge.pcm_gap(p, out, P0, "cpu") < 2e-6
    assert np.abs(judge.decode_pcm(p, P0, "cpu") - pcm).max() < 1e-4
    for entry in p.symbols.values():
        entry[1][0, 7, 1] *= 1.01
    assert judge.encode_excess(p, pcm, P0, "cpu") > 1e-4


def test_transforms_invert():
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 256)))
    assert torch.allclose(codec.idct(codec.dct(x)), x, atol=1e-12)


def test_overlap_add_crossfades():
    a, b = np.ones((8, 1)), 2 * np.ones((8, 1))
    out = codec.overlap_add([a, b], [2, 2])
    w = codec.fade_in(2)
    assert out.shape == (14, 1)
    assert np.allclose(out[6:8, 0], 2 * w + w[::-1])
