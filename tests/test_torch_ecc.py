"""The port's ECC armor, error-correcting decode and `batch_repair`
against the JAX package, on the CPU at small sizes, through both host
paths: the C++ host module and the numpy paths (FRAD_TORCH_NO_NATIVE=1,
which also takes `batch_repair`'s Python frame scan).

Byte-exactness is required throughout: fed the JAX package's symbols,
the port's ECC stream is the JAX stream; `batch_repair` gives the JAX
function's bytes on every stream; a repaired or `fix_error` decode equals
the undamaged one exactly. The port's decode of a stream against the JAX
package's is held to 2/32768, as in test_torch_slice.py (float32 IDCT
GEMMs summing in other orders).
"""

import shutil

import numpy as np
import pytest
import torch

from bench import make_audio
from frad_python_tpu.parallel import pipeline as jpipeline
from frad_python_tpu.utils.damage import damage_stream as jdamage_stream
import frad_python_tpu_torch as ft
from frad_python_tpu_torch.common import FRM_SIGN
from frad_python_tpu_torch.parallel import pipeline as tpipeline
from frad_python_tpu_torch.utils.damage import damage_stream
from test_torch_slice import _jax_symbols

CPU = torch.device("cpu")
LSB = 1.0 / 32768.0


@pytest.fixture(params=["native", "numpy"])
def host_path(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setenv("FRAD_TORCH_NO_NATIVE", "1")
    elif shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the native host module cannot be built")
    return request.param


@pytest.fixture(scope="module")
def audio():
    return make_audio(0.5, 44100, 2)


def _jax_p1(pcm, **kw):
    return jpipeline.batch_encode(pcm, 1, 44100, 16, 2048, compute_dtype="float32",
                                  i16_upload=True, **kw)


@pytest.fixture(scope="module")
def streams(audio):
    """JAX-encoded streams: Profile 1 plain and armored at two ratios, and
    an armored lossless Profile 4 stream (32-byte headers, CRC-32)."""
    pcm4 = np.random.default_rng(3).standard_normal((3000, 2)) * 0.4
    return {
        "p1": _jax_p1(audio),
        "p1e": _jax_p1(audio, enable_ecc=True),
        "p1e48": _jax_p1(audio[:15000], enable_ecc=True, ecc_ratio=(48, 12)),
        "p4e": jpipeline.batch_encode(pcm4, 4, 44100, 16, 512, enable_ecc=True),
    }


@pytest.fixture(scope="module")
def port_ecc_stream(audio):
    """The port's own ECC stream of `audio` (host-path independent: the
    two paths give the same bytes, as test_ecc_stream_matches_jax shows)."""
    return ft.batch_encode(audio, 1, 44100, 16, 2048, i16_upload=True, enable_ecc=True,
                           device=CPU)


@pytest.mark.parametrize("ratio", [(96, 24), (48, 12), (0, 0)])
def test_ecc_stream_matches_jax_on_jax_symbols(host_path, monkeypatch, audio, ratio):
    want = _jax_p1(audio, enable_ecc=True, ecc_ratio=ratio)
    _jax_symbols(monkeypatch)
    got = ft.batch_encode(audio, 1, 44100, 16, 2048, i16_upload=True, enable_ecc=True,
                          ecc_ratio=ratio, device=CPU)
    assert got == want
    headers, payloads, tail = tpipeline._parse_frames(got)
    assert tail == b"" and all(h.ecc for h in headers)
    assert {(h.ecc_dsize, h.ecc_codesize) for h, p in zip(headers, payloads)
            if p is not None} == {ratio}


def test_mixed_ratio_stream_matches_jax(host_path, monkeypatch, audio):
    """A mid-stream re-armor at a new ratio: the encode is the JAX
    stream, and the decode splits the run at the ratio change."""
    a, b = audio[:12000], audio[12000:]
    want = (_jax_p1(a, enable_ecc=True, ecc_ratio=(96, 24))
            + _jax_p1(b, enable_ecc=True, ecc_ratio=(48, 12)))
    want_pcm, _ = jpipeline.batch_decode(want, fix_error=True, compute_dtype="float32",
                                         i16_transfer=True)
    _jax_symbols(monkeypatch)
    got = (ft.batch_encode(a, 1, 44100, 16, 2048, i16_upload=True, enable_ecc=True,
                           ecc_ratio=(96, 24), device=CPU)
           + ft.batch_encode(b, 1, 44100, 16, 2048, i16_upload=True, enable_ecc=True,
                             ecc_ratio=(48, 12), device=CPU))
    assert got == want
    clean, sr = ft.batch_decode(got, i16_transfer=True, device=CPU)
    fixed, _ = ft.batch_decode(damage_stream(got), fix_error=True, i16_transfer=True,
                               device=CPU)
    assert sr == 44100 and clean.shape == want_pcm.shape
    np.testing.assert_array_equal(fixed, clean)
    assert np.abs(clean - want_pcm).max() <= 2 * LSB


def test_fix_error_decode_equals_clean_decode(host_path, port_ecc_stream):
    damaged = damage_stream(port_ecc_stream)
    assert damaged != port_ecc_stream and len(damaged) == len(port_ecc_stream)
    assert damaged == jdamage_stream(port_ecc_stream)
    clean, sr = ft.batch_decode(port_ecc_stream, i16_transfer=True, device=CPU)
    fixed, sr2 = ft.batch_decode(damaged, fix_error=True, i16_transfer=True, device=CPU)
    unfixed, _ = ft.batch_decode(damaged, i16_transfer=True, device=CPU)
    assert sr == sr2 == 44100
    np.testing.assert_array_equal(fixed, clean)
    assert unfixed.shape == clean.shape and not np.array_equal(unfixed, clean)
    want, _ = jpipeline.batch_decode(damaged, fix_error=True, compute_dtype="float32",
                                     i16_transfer=True)
    assert np.abs(fixed - want).max() <= 2 * LSB


def _armor_oversize(stream: bytes) -> bytes:
    """Re-armor every frame under a hand-made header claiming the ratio
    (255, 255), which GF(256) cannot honor, with zero parity and a wrong
    CRC, so `fix_error` asks for a repair the decoder must decline."""
    headers, payloads, _ = tpipeline._parse_frames(stream)
    out = []
    for h, p in zip(headers, payloads):
        if p is None:
            out.append(h.buffer)
            continue
        h.ecc, h.ecc_dsize, h.ecc_codesize = True, 255, 255
        frame = bytearray(h.write(b"".join(p[i:i + 255] + bytes(255)
                                           for i in range(0, len(p), 255))))
        frame[14] ^= 0xFF
        out.append(bytes(frame))
    return b"".join(out)


def test_oversize_wire_ratio_decodes_best_effort(host_path, audio):
    stream = ft.batch_encode(audio, 1, 44100, 16, 2048, device=CPU)
    crafted = _armor_oversize(stream)
    clean, _ = ft.batch_decode(stream, device=CPU)
    for fix in (True, False):
        got, _ = ft.batch_decode(crafted, fix_error=fix, device=CPU)
        np.testing.assert_array_equal(got, clean)
    want, _ = jpipeline.batch_decode(crafted, fix_error=True, compute_dtype="float32")
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def _frame_starts(stream: bytes) -> list[int]:
    """Offsets of the frames of a stream that holds no junk."""
    headers, payloads, _ = tpipeline._parse_frames(stream)
    sizes = [h.header_bytes + len(p or b"") for h, p in zip(headers, payloads)]
    return np.cumsum([0] + sizes[:-1]).tolist()


REPAIR_CASES = ["clean_no_ecc", "armored", "damaged", "damaged_no_fix", "junk",
                "terminators_mid_stream", "truncated_tail", "mixed_ratios", "rearmor_48_12",
                "mixed_profiles", "lossless_damaged", "oversize_request", "no_frames"]


def _repair_case(name, s):
    """(stream, ecc_ratio, fix_error) of a repair case."""
    if name == "clean_no_ecc":
        return s["p1"], (96, 24), True
    if name == "armored":
        return s["p1e"], (96, 24), True
    if name == "damaged":
        return damage_stream(s["p1e"]), (96, 24), True
    if name == "damaged_no_fix":
        return damage_stream(s["p1e"]), (96, 24), False
    if name == "junk":
        st = _frame_starts(s["p1e"])
        a, b = st[3], st[7]
        e = s["p1e"]
        return (b"fRad junk \xff\xd0\xd2" + e[:a] + b"\x00\xff\xd0garbage" + e[a:b]
                + FRM_SIGN[:3] + e[b:]), (96, 24), True
    if name == "terminators_mid_stream":
        return s["p1e"] + s["p1"] + s["p1e48"], (96, 24), True
    if name == "truncated_tail":
        return damage_stream(s["p1e"])[:-300], (96, 24), True
    if name == "mixed_ratios":
        return damage_stream(s["p1e"] + s["p1e48"]), (96, 24), True
    if name == "rearmor_48_12":
        return damage_stream(s["p1e"]), (48, 12), True
    if name == "mixed_profiles":
        return s["p1"] + s["p4e"] + s["p1e"], (64, 16), True
    if name == "lossless_damaged":
        return damage_stream(s["p4e"], nth=1), (96, 24), True
    if name == "oversize_request":             # falls back to (96, 24)
        return damage_stream(s["p1e48"]), (200, 100), True
    return b"no frame here \xff\xd0", (96, 24), True


@pytest.mark.parametrize("case", REPAIR_CASES)
def test_batch_repair_matches_jax(host_path, streams, case):
    stream, ratio, fix = _repair_case(case, streams)
    got = ft.batch_repair(stream, ratio, fix_error=fix)
    assert got == jpipeline.batch_repair(stream, ratio, fix_error=fix)
    if case in ("armored", "damaged"):
        assert got == streams["p1e"]            # the undamaged armored bytes
    if case == "oversize_request":
        assert got == ft.batch_repair(streams["p1e48"], (96, 24))
