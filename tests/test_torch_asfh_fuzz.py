"""A compact frame header whose sample-rate index lies past the table
(12-15) is a failed parse in the port, not an IndexError: `Decoder`,
`Repairer`, `batch_decode` and `batch_repair` resync on the next frame
sign, on both host paths, and the good frames after it still decode. The
JAX package's parser raises on the same bytes (a defect of the reference
that the port does not copy). A compact frame whose depth index lies past
its profile's table (7) decodes to a zero frame, as the lossless decoders
treat theirs, where `profile1.digital` raised IndexError."""

import numpy as np
import pytest
import torch

from bench import make_audio
from frad_python_tpu.container import asfh as jasfh
import frad_python_tpu_torch as ft
from frad_python_tpu_torch.common import FRM_SIGN
from frad_python_tpu_torch.container import asfh as tasfh
from frad_python_tpu_torch.parallel import pipeline as tpipeline

CPU = torch.device("cpu")
BAD_INDEXES = (12, 13, 14, 15)


def bad_header(srate_idx: int, ecc: bool = False, force_flush: bool = False) -> bytes:
    """A Profile 1 stereo header whose CSS names sample-rate index
    `srate_idx`, followed by 40 payload-like bytes."""
    css = (1 << 10) | (srate_idx << 6) | (16 << 1) | int(force_flush)
    pfb = tasfh.encode_pfb(1, ecc, False, 2)
    head = FRM_SIGN + (40).to_bytes(4, "big") + bytes([pfb]) + css.to_bytes(2, "big") + b"\x0f"
    if ecc:
        head += bytes([96, 24, 0x12, 0x34])
    return head + bytes(range(40))


@pytest.fixture(scope="module")
def clean():
    raw = make_audio(0.3, 44100, 2).astype(">f8").tobytes()
    enc = ft.Encoder(1, 44100, 2, 16, 1024, "f64be", device=CPU)
    enc.set_overlap_ratio(16)
    enc.set_ecc(True, (96, 24))
    return enc.process(raw).buf + enc.flush().buf


def decode_all(stream: bytes, chunk: int, **kw) -> np.ndarray:
    d = ft.Decoder(device=CPU, **kw)
    parts = [d.process(stream[i:i + chunk]).pcm for i in range(0, len(stream), chunk)]
    parts.append(d.flush().pcm)
    return np.concatenate([p for p in parts if p.size])


def repair_all(stream: bytes, chunk: int) -> bytes:
    r = ft.Repairer((96, 24))
    return b"".join(r.process(stream[i:i + chunk])
                    for i in range(0, len(stream), chunk)) + r.flush()


@pytest.mark.parametrize("idx", BAD_INDEXES)
def test_read_reports_invalid_where_the_jax_parser_raises(idx):
    frame = bad_header(idx)
    a = tasfh.ASFH()
    status, rest = a.read(frame)
    assert status == tasfh.INVALID and rest == frame[len(FRM_SIGN):]
    assert a.buffer == b"" and not a.all_set
    assert tasfh.decode_css((idx << 6) | 1) is None
    with pytest.raises(IndexError):
        jasfh.ASFH().read(frame)
    # every index of both tables still parses
    for sri in range(12):
        for fsi in range(32):
            css = (3 << 10) | (sri << 6) | (fsi << 1)
            assert tasfh.decode_css(css) == jasfh.decode_css(css)


@pytest.mark.parametrize("host", ["native", "numpy"])
@pytest.mark.parametrize("idx", BAD_INDEXES)
def test_crafted_header_resyncs_everywhere(monkeypatch, clean, host, idx):
    """The bad header in front of, inside and behind a good stream: no
    exception, and the good frames decode and repair as without it."""
    if host == "numpy":
        monkeypatch.setenv("FRAD_TORCH_NO_NATIVE", "1")
    headers, payloads, _ = tpipeline._parse_frames(clean)
    n_frames = len(headers)
    cut = clean.index(FRM_SIGN, len(clean) // 2)
    want_pcm, want_sr = ft.batch_decode(clean, fix_error=True, device=CPU)
    want_rep = ft.batch_repair(clean, (96, 24))
    for ecc in (False, True):
        junk = bad_header(idx, ecc)
        # in front and behind: every good frame survives
        for stream in (junk + clean, clean + junk):
            hs, ps, _ = tpipeline._parse_frames(stream)
            assert len(hs) == n_frames
            got, sr = ft.batch_decode(stream, fix_error=True, device=CPU)
            assert sr == want_sr
            np.testing.assert_array_equal(got, want_pcm)
            for chunk in (len(stream), 997):
                np.testing.assert_allclose(decode_all(stream, chunk, fix_error=True), want_pcm,
                                           rtol=0, atol=2e-6)
                np.testing.assert_array_equal(
                    decode_all(stream, chunk, fix_error=True, exact=True),
                    decode_all(clean, chunk, fix_error=True, exact=True))
            rep = ft.batch_repair(stream, (96, 24))
            assert rep == (junk + want_rep if stream.startswith(junk) else want_rep + junk)
            for chunk in (len(stream), 997):
                assert repair_all(stream, chunk) == rep
        # in the middle: the frames on both sides survive
        stream = clean[:cut] + junk + clean[cut:]
        hs, ps, _ = tpipeline._parse_frames(stream)
        assert len(hs) == n_frames
        got, _ = ft.batch_decode(stream, fix_error=True, device=CPU)
        assert got.shape == want_pcm.shape and np.isfinite(got).all()
        np.testing.assert_array_equal(got, want_pcm)
        assert decode_all(stream, 4096, fix_error=True).shape == want_pcm.shape
        rep = ft.batch_repair(stream, (96, 24))
        assert rep == repair_all(stream, 4096) == repair_all(stream, len(stream))
        assert len(tpipeline._parse_frames(rep)[0]) == n_frames


@pytest.mark.parametrize("idx", BAD_INDEXES)
def test_force_flush_with_a_bad_index_is_no_terminator(clean, idx):
    junk = bad_header(idx, force_flush=True)
    want, _ = ft.batch_decode(clean, device=CPU)
    got, _ = ft.batch_decode(junk + clean, device=CPU)
    np.testing.assert_array_equal(got, want)
    assert repair_all(junk + clean, 4096) == ft.batch_repair(junk + clean, (96, 24))


@pytest.mark.parametrize("seed", [6, 66, 81])
def test_bitflip_storms_that_raised(clean, seed):
    """1% of bytes flipped, beyond RS capacity. These seeds flip a header's
    sample-rate index to 12-15 or its depth index to 7 and raised
    IndexError out of `Decoder.process` before the repair; they end with
    finite output from the engines and the batch path."""
    stream = bytearray(clean)
    r = np.random.default_rng(seed)
    for off in r.integers(0, len(stream), size=len(stream) // 100):
        stream[int(off)] ^= int(r.integers(1, 256))
    stream = bytes(stream)
    bad = 0
    pos = stream.find(FRM_SIGN)
    while pos >= 0:
        if len(stream) - pos >= 12 and (stream[pos + 8] >> 5) in (1, 2):
            css = int.from_bytes(stream[pos + 9: pos + 11], "big")
            bad += ((css >> 6) & 15) >= 12 or (stream[pos + 8] & 7) == 7
        pos = stream.find(FRM_SIGN, pos + 1)
    assert bad >= 1
    for exact in (False, True):
        assert np.isfinite(decode_all(stream, len(stream), fix_error=True, exact=exact)).all()
        assert np.isfinite(decode_all(stream, 1500, fix_error=True, exact=exact)).all()
    out, _ = ft.batch_decode(stream, fix_error=True, device=CPU)
    assert np.isfinite(out).all() and len(out) > 0
    rep = ft.batch_repair(stream, (96, 24))
    assert rep == repair_all(stream, 1500)


@pytest.mark.parametrize("host", ["native", "numpy"])
@pytest.mark.parametrize("profile", [1, 2])
def test_depth_index_past_the_table_decodes_to_a_zero_frame(monkeypatch, host, profile):
    """Frames 2 and 3 of a stream get depth index 7: they decode to zeros
    of their length on every path, the frames around them as before."""
    if host == "numpy":
        monkeypatch.setenv("FRAD_TORCH_NO_NATIVE", "1")
    audio = make_audio(0.25, 44100, 2)
    stream = ft.batch_encode(audio, profile, 44100, 16, 1024, overlap_ratio=0, device=CPU)
    headers, payloads, _ = tpipeline._parse_frames(stream)
    want, _ = ft.batch_decode(stream, device=CPU)
    bad = bytearray(stream)
    pos = 0
    for i, (h, p) in enumerate(zip(headers, payloads)):
        at = stream.index(h.buffer, pos)
        if i in (2, 3):
            bad[at + 8] |= 7
        pos = at + h.header_bytes + (len(p) if p is not None else 0)
    bad = bytes(bad)
    got, sr = ft.batch_decode(bad, device=CPU)
    assert sr == 44100 and got.shape == want.shape
    assert not got[2048:4096].any()
    np.testing.assert_allclose(got[:2048], want[:2048], rtol=0, atol=2e-6)
    np.testing.assert_allclose(got[4096:], want[4096:], rtol=0, atol=2e-6)
    for exact in (False, True):
        for chunk in (len(bad), 1500):
            out = decode_all(bad, chunk, exact=exact)
            assert out.shape == want.shape and not out[2048:4096].any()
            np.testing.assert_allclose(out[4096:], want[4096:], rtol=0, atol=2e-6)
