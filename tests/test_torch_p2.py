"""Profile 2 and the lossy profiles at float64 in the port against the JAX
package, on the CPU at small sizes: `models/profile2.py` (payload bytes,
the per-frame codec), the batch pipeline and the `Decoder` both ways, the
native batch unpack with LPC rows, corrupt payloads, the engines' state
hand-over, and chip_smoke.py's floors. Inputs are made with numpy from a
seed and go through both packages. The TNS ops, kernels and cores below
them are in tests/test_torch_tns.py.

Tolerances: payload bytes are exact given equal symbols; LPC symbols must
be equal (wire bytes; lanes that differ are counted); frequency symbols
may flip by 1 at rint boundaries at float32 (a few per frame) and not at
all at float64 on these seeds; decoded PCM within 2e-6 at float32
(|pcm| < 2: a few ulps of the IDCT sum after the TNS filter) and 1e-9 at
float64; SNR within 0.1 dB of the JAX package's.
"""

import zlib

import numpy as np
import pytest
import torch

import chip_smoke
import frad_python_tpu as jf
from frad_python_tpu import native as jnative
from frad_python_tpu.container.asfh import ASFH as JASFH
from frad_python_tpu.models import profile2 as jprofile2
from frad_python_tpu.ops import policy as jpolicy
from frad_python_tpu.parallel import pipeline as jpipeline
import frad_python_tpu_torch as ft
from frad_python_tpu_torch import kernels as tkernels
from frad_python_tpu_torch import native as tnative
from frad_python_tpu_torch.container.asfh import ASFH as TASFH
from frad_python_tpu_torch.models import batch as tbatch
from frad_python_tpu_torch.models import profile2 as tprofile2
from frad_python_tpu_torch.ops import psycho as tpsycho
from frad_python_tpu_torch.ops import tns as ttns
from frad_python_tpu_torch.parallel import pipeline as tpipeline

CPU = torch.device("cpu")
DTYPES = ["float32", "float64"]
ATOL_PCM = {"float32": 2e-6, "float64": 1e-9}


@pytest.fixture
def compute(monkeypatch):
    """Set both packages' compute dtype (the per-frame codecs and the
    engines read it from the environment)."""
    def use(dtype: str) -> None:
        monkeypatch.setenv("FRAD_TPU_COMPUTE_DTYPE", dtype)
        monkeypatch.setenv("FRAD_TORCH_COMPUTE_DTYPE", dtype)
        jpolicy.compute_dtype.cache_clear()
    yield use
    monkeypatch.undo()
    jpolicy.compute_dtype.cache_clear()


def t_(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def snr_db(ref, out):
    m = min(len(ref), len(out))
    return 10 * np.log10(np.sum(ref[:m] ** 2) / np.sum((out[:m] - ref[:m]) ** 2))


# ----------------------------------------------------------------------
# models/profile2.py: payload bytes, per-frame codec
# ----------------------------------------------------------------------
def _symbols(seed: int, n: int = 512, ch: int = 2):
    rng = np.random.default_rng(seed)
    fq = np.rint(rng.laplace(0, 6, n * ch)).astype(np.int64)
    tq = rng.integers(0, 60, 27 * ch).astype(np.int64)
    lq = rng.integers(-15, 15, 13 * ch).astype(np.int64) * (rng.random(13 * ch) < 0.5)
    return fq, tq, lq


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_streams_bytes_match_jax(seed):
    fq, tq, lq = _symbols(seed)
    payload = tprofile2.pack_streams(fq, tq, lq)
    assert payload == jprofile2.pack_streams(fq, tq, lq)
    for mod in (tprofile2, jprofile2):
        f, t, l = mod.unpack_streams(payload)
        np.testing.assert_array_equal(f[: len(fq)], fq)
        np.testing.assert_array_equal(t[: len(tq)], tq)
        np.testing.assert_array_equal(l[: len(lq)], lq)
    assert tprofile2.DEPTHS == jprofile2.DEPTHS and ft.models.BIT_DEPTHS[2] == jprofile2.DEPTHS


def _corrupt_payloads():
    fq, tq, lq = _symbols(9)
    good = tprofile2.pack_streams(fq, tq, lq)
    raw = zlib.decompress(good, wbits=-15)
    return [good, b"", b"\x99\x88", good[: len(good) // 2], b"\x00garbage",
            zlib.compress(b"\x00\x01\x02", wbits=-15),                   # under 6 bytes
            zlib.compress(b"\x00\x02ab\x00\x00", wbits=-15),             # no room for thres_len
            zlib.compress(b"\xff\xff" + raw[2:], wbits=-15),             # lpc_len past the end
            zlib.compress(raw[:2] + raw[2:40] + b"\xff\xff\xff\xff", wbits=-15),
            good[:-3] + b"\x00\x00\x00"]


def test_unpack_streams_none_on_corrupt_payload_as_jax():
    for p in _corrupt_payloads():
        got, want = tprofile2.unpack_streams(p), jprofile2.unpack_streams(p)
        assert (got is None) == (want is None), p[:8]
        if got is not None:
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        back = tprofile2.digital(p, 2, 2, 44100, 512, CPU)
        assert back.shape == (512, 2) and np.isfinite(back).all()
        if got is None:
            assert not back.any()


@pytest.mark.parametrize("host", ["native", "numpy"])
def test_p1_unpack_batch_lq_rows_match_unpack_streams(monkeypatch, host):
    """The C++ batch unpack of Profile 2 payloads gives the rows of the
    Python unpack; a frame that fails leaves all three of its rows zero."""
    payloads = _corrupt_payloads()
    n, ch = 512, 2
    fq, tq, lq, ok = tnative.p1_unpack_batch(payloads, n * ch, 27 * ch, 13 * ch)
    jfq, jtq, jlq, jok = jnative.p1_unpack_batch(payloads, n * ch, 27 * ch, 13 * ch)
    for got, want in ((fq, jfq), (tq, jtq), (lq, jlq), (ok, jok)):
        np.testing.assert_array_equal(got, want)
    for i, p in enumerate(payloads):
        s = tprofile2.unpack_streams(p)
        assert ok[i] == (s is not None)
        rows = tprofile2.untrim_streams(s, n, ch)
        for got, want in zip((fq[i], tq[i], lq[i]), rows):
            np.testing.assert_array_equal(got, want.astype(np.float32))
    assert ok[0] and not ok[1:7].any() and not lq[~ok].any()
    if host == "numpy":
        monkeypatch.setenv("FRAD_TORCH_NO_NATIVE", "1")
    for dtype in DTYPES:
        rows = tpipeline._unpack_run(payloads, n, ch, 2, dtype)
        assert all(r.dtype == dtype for r in rows)
        for got, want in zip(rows, (fq, tq, lq)):
            np.testing.assert_array_equal(got, want)


def _tones(fsize):
    t = np.arange(fsize) / 48000
    return np.stack([np.sin(2 * np.pi * 440 * t), np.sin(2 * np.pi * 1320 * t)], 1) * 0.6


FRAME_CASES = {
    "tones512": (lambda: _tones(512), 0.125, 18.0),
    "tones2048": (lambda: _tones(2048), 0.125, 18.0),
    "noise1024": (lambda: np.random.default_rng(31).standard_normal((1024, 1)) * 0.3, 0.25, 5.0),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(FRAME_CASES))
def test_analogue_digital_match_jax(compute, case, dtype):
    compute(dtype)
    make, ll, floor = FRAME_CASES[case]
    pcm = make()
    n, ch = pcm.shape
    want_p, *want_meta = jprofile2.analogue(pcm, 16, 48000, ll)
    got_p, *got_meta = tprofile2.analogue(pcm, 16, 48000, ll, CPU)
    assert got_meta == want_meta == [4, ch, 48000]
    gs, ws = tprofile2.unpack_streams(got_p), tprofile2.unpack_streams(want_p)
    np.testing.assert_array_equal(gs[2], ws[2])                  # LPC symbols: wire bytes
    m = min(len(gs[0]), len(ws[0]))
    flips = int((gs[0][:m] != ws[0][:m]).sum()) + abs(len(gs[0]) - len(ws[0]))
    assert flips <= (max(1, n * ch // 2000) if dtype == "float32" else 0)
    if flips == 0:
        assert got_p == want_p
    # each implementation decodes both payloads alike
    for p in (got_p, want_p):
        want = jprofile2.digital(p, 4, ch, 48000, n)
        got = tprofile2.digital(p, 4, ch, 48000, n, CPU)
        assert got.shape == want.shape == (n, ch) and got.dtype == np.float64
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_PCM[dtype])
    assert snr_db(pcm, got) > floor
    assert abs(snr_db(pcm, tprofile2.digital(got_p, 4, ch, 48000, n, CPU))
               - snr_db(pcm, jprofile2.digital(want_p, 4, ch, 48000, n))) < 0.1


def _p2_stream(analogue, make_asfh, sig, bits, srate, ll, fsize) -> bytes:
    """A Profile 2 stream built frame by frame without overlap (the
    Encoder's gauntlet refuses profile 2 in both packages)."""
    out = []
    for off in range(0, len(sig), fsize):
        frame = sig[off:off + fsize]
        frad, bdi, channels, srate_o = analogue(frame, bits, srate, ll)
        a = make_asfh()
        a.profile, a.bit_depth_index, a.channels = 2, bdi, channels
        a.srate, a.fsize, a.overlap_ratio = srate_o, len(frame), 0
        out.append(a.write(frad))
    return b"".join(out)


def _decode_all(dec, stream: bytes, chunk: int = 32768) -> np.ndarray:
    pcm = [dec.process(stream[i:i + chunk]).pcm for i in range(0, len(stream), chunk)]
    pcm.append(dec.flush().pcm)
    return np.concatenate([p for p in pcm if p.size])


@pytest.mark.parametrize("seed", range(6))
def test_random_p2_parameter_draw(compute, seed):
    """Random (bits, srate, fsize, loss): both packages encode frame by
    frame, and each stream decodes alike in both Decoders (per frame with
    `exact`, micro-batched without)."""
    compute("float32")
    r = np.random.default_rng(500 + seed)
    bits = int(r.choice([8, 12, 16, 24]))
    srate = int(r.choice([22050, 44100, 48000]))
    fsize = int(r.choice([512, 1024, 2048]))
    ll = float(r.choice([0.25, 0.5, 1.0]))
    n = int(fsize * int(r.integers(3, 7)))
    t = np.arange(n) / srate
    sig = np.stack([0.4 * np.sin(2 * np.pi * (200 + 70 * c) * t) for c in range(2)], axis=1) \
        + 0.003 * r.standard_normal((n, 2))
    s_port = _p2_stream(lambda *a: tprofile2.analogue(*a, CPU), TASFH, sig, bits, srate, ll, fsize)
    s_jax = _p2_stream(jprofile2.analogue, JASFH, sig, bits, srate, ll, fsize)
    assert len(tpipeline._parse_frames(s_port)[0]) == len(tpipeline._parse_frames(s_jax)[0])
    for stream in (s_port, s_jax):
        want = _decode_all(jf.Decoder(), stream)
        for exact in (False, True):
            got = _decode_all(ft.Decoder(device=CPU, exact=exact), stream)
            assert got.shape == want.shape == sig.shape
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    assert abs(snr_db(sig, _decode_all(ft.Decoder(device=CPU), s_port))
               - snr_db(sig, _decode_all(jf.Decoder(), s_jax))) < 0.1


# ----------------------------------------------------------------------
# the batch pipeline and the Decoder, both ways
# ----------------------------------------------------------------------
def _noise9000():
    return np.random.default_rng(77).standard_normal((9000, 2)) * 0.4, 0.5


def _tones12000():
    t = np.arange(12000) / 48000
    return np.stack([0.5 * np.sin(2 * np.pi * 440 * t), 0.5 * np.sin(2 * np.pi * 660 * t)], 1), 0.125


BATCH_DRAWS = {"noise9000": _noise9000, "tones12000": _tones12000}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("draw", list(BATCH_DRAWS))
def test_batch_cross_decodes_both_ways(compute, draw, dtype):
    compute(dtype)
    pcm, ll = BATCH_DRAWS[draw]()
    kw = dict(overlap_ratio=16, loss_level=ll, compute_dtype=dtype)
    s_port = ft.batch_encode(pcm, 2, 48000, 16, 2048, device=CPU, **kw)
    s_jax = jpipeline.batch_encode(pcm, 2, 48000, 16, 2048, **kw)
    hp, pp, _ = tpipeline._parse_frames(s_port)
    hj, pj, _ = tpipeline._parse_frames(s_jax)
    assert [(h.profile, h.fsize, h.bit_depth_index) for h in hp] == \
        [(h.profile, h.fsize, h.bit_depth_index) for h in hj] and hp[0].profile == 2
    if dtype == "float64":
        assert s_port == s_jax           # no symbol on a rint boundary on these draws
    for stream in (s_port, s_jax):
        want, wsr = jpipeline.batch_decode(stream, compute_dtype=dtype)
        got, gsr = ft.batch_decode(stream, compute_dtype=dtype, device=CPU)
        assert got.shape == want.shape and gsr == wsr == 48000
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_PCM[dtype])
        for exact in (False, True):
            dec = _decode_all(ft.Decoder(device=CPU, exact=exact), stream, 4096)
            assert dec.shape == want.shape
            np.testing.assert_allclose(dec, want, rtol=0, atol=ATOL_PCM[dtype])
    snr_port = snr_db(pcm, ft.batch_decode(s_port, compute_dtype=dtype, device=CPU)[0])
    snr_jax = snr_db(pcm, jpipeline.batch_decode(s_jax, compute_dtype=dtype)[0])
    assert snr_port > snr_jax - 0.1 and (draw != "tones12000" or snr_port > 15)


def test_batch_payloads_equal_per_frame_payloads():
    """batch_encode(profile=2) holds, in order, the payloads of the
    per-frame codec on the planned frames (equal symbols: one core)."""
    pcm, _ = _noise9000()
    frames, terms = tpipeline.plan_frames(len(pcm), 2048, 16, True)
    got = ft.batch_encode(pcm, 2, 48000, 16, 2048, overlap_ratio=16, device=CPU)
    _, payloads, tail = tpipeline._parse_frames(got)
    assert tail == b"" and sum(p is None for p in payloads) == terms
    differ = 0
    for (s, ln), p in zip(frames, payloads):
        fr = np.zeros((ln, 2))
        s0 = max(s, 0)
        fr[s0 - s: ln] = pcm[s0: s + ln]
        differ += tprofile2.analogue(fr, 16, 48000, 0.5, CPU)[0] != p
    # a batch of 5 and a batch of 1 may reach other GEMM kernels
    assert differ <= 1, differ


@pytest.mark.parametrize("host", ["native", "numpy"])
def test_corrupt_profile2_payloads_raise_nothing(monkeypatch, host):
    """Flipped, garbage and zeroed Profile 2 payloads, armored or not,
    repaired or not: every decode path returns the clean decode's shape."""
    if host == "numpy":
        monkeypatch.setenv("FRAD_TORCH_NO_NATIVE", "1")
    pcm, _ = _noise9000()
    r = np.random.default_rng(11)
    for ecc in (False, True):
        stream = ft.batch_encode(pcm[:3000], 2, 44100, 16, 512, enable_ecc=ecc, device=CPU)
        clean, _ = ft.batch_decode(stream, device=CPU)
        headers, payloads, _ = tpipeline._parse_frames(stream)
        spans, pos = [], 0
        for h, p in zip(headers, payloads):
            at = stream.index(h.buffer, pos) + h.header_bytes
            if p is not None:
                spans.append((at, at + len(p)))
            pos = at + (len(p) if p is not None else 0)
        for kind in ("flip", "garbage", "zero"):
            bad = bytearray(stream)
            for lo, hi in spans[1::2]:
                if kind == "flip":
                    for off in r.integers(lo, hi, size=max((hi - lo) // 50, 1)):
                        bad[int(off)] ^= int(r.integers(1, 256))
                else:
                    bad[lo:hi] = (r.integers(0, 256, hi - lo, dtype=np.uint8).tobytes()
                                  if kind == "garbage" else bytes(hi - lo))
            for fix in (False, True):
                got, _ = ft.batch_decode(bytes(bad), fix_error=fix, device=CPU)
                assert got.shape == clean.shape and np.isfinite(got).all(), (ecc, kind, fix)
                for exact in (False, True):
                    dec = _decode_all(ft.Decoder(fix_error=fix, exact=exact, device=CPU),
                                      bytes(bad), 4096)
                    assert dec.shape == clean.shape and np.isfinite(dec).all()


@pytest.mark.parametrize("exact", [False, True])
def test_decoder_jax_state_hand_over_profile2(compute, exact):
    """A JAX Decoder suspended in the middle of a Profile 2 stream
    finishes in the port as it would in the JAX package (within 2e-6)."""
    compute("float32")
    pcm = chip_smoke.make_audio(0.5, 44100, 2)
    stream = jpipeline.batch_encode(pcm, 2, 44100, 16, 2048, compute_dtype="float32")
    jdec = jf.Decoder(exact=exact)
    p1 = jdec.process(stream[:9000]).pcm
    state = jdec.state_dict()
    want_dec, got_dec = jf.Decoder(), ft.Decoder(device=CPU)
    want_dec.load_state_dict(state)
    got_dec.load_state_dict(state)
    want, got = _decode_all(want_dec, stream[9000:]), _decode_all(got_dec, stream[9000:])
    assert p1.size and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


# ----------------------------------------------------------------------
# float64: the JAX package's default off the TPU
# ----------------------------------------------------------------------
@pytest.mark.parametrize("profile", [1, 2])
def test_float64_symbols_and_decodes_match_jax_default(compute, profile):
    """Against the JAX package's default-dtype run (float64 on a CPU
    host): the symbol flip rate is 0 on this content (streams byte-equal),
    decodes within 1e-9, through the batch calls and the engines."""
    assert jpolicy.compute_dtype() == "float64"
    pcm = chip_smoke.make_audio(0.5, 44100, 2)
    s_jax = jpipeline.batch_encode(pcm, profile, 44100, 16, 2048)
    s_port = ft.batch_encode(pcm, profile, 44100, 16, 2048, compute_dtype="float64", device=CPU)
    _, pj, _ = tpipeline._parse_frames(s_jax)
    _, pp, _ = tpipeline._parse_frames(s_port)
    unpack = tprofile2.unpack_streams if profile == 2 else \
        (lambda p: ft.models.profile1.unpack_streams(p))
    flips = total = 0
    for a, b in zip(pj, pp):
        if a is None:
            continue
        fa, fb = unpack(a)[0], unpack(b)[0]
        m = min(len(fa), len(fb))
        flips += int((fa[:m] != fb[:m]).sum()) + abs(len(fa) - len(fb))
        total += m
    assert len(pj) == len(pp) and flips == 0 and total > 40000 and s_port == s_jax
    want, _ = jpipeline.batch_decode(s_jax)
    got, _ = ft.batch_decode(s_jax, compute_dtype="float64", device=CPU)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    compute("float64")
    for exact in (False, True):
        dec = _decode_all(ft.Decoder(device=CPU, exact=exact), s_jax)
        np.testing.assert_allclose(dec, _decode_all(jf.Decoder(exact=exact), s_jax),
                                   rtol=0, atol=1e-9)
    # the float32 decode of the same stream is another, coarser result
    got32, _ = ft.batch_decode(s_jax, compute_dtype="float32", device=CPU)
    assert 1e-9 < np.abs(got32 - want).max() < 1e-4


def test_float64_encoder_with_profile2_state(compute):
    """An Encoder whose loaded state names profile 2 writes, at float64,
    the JAX Encoder's bytes."""
    compute("float64")
    raw = np.clip(np.rint(chip_smoke.make_audio(0.4, 44100, 2) * 32768), -32768,
                  32767).astype("<i2").tobytes()
    outs = []
    for mod, kw in ((jf, {}), (ft, dict(device=CPU))):
        enc = mod.Encoder(1, 44100, 2, 16, 2048, "s16le", **kw)
        enc.set_overlap_ratio(16)
        state = enc.state_dict()
        state["profile"] = 2
        enc.load_state_dict(state)
        outs.append(b"".join(enc.process(raw[i:i + 20000]).buf
                             for i in range(0, len(raw), 20000)) + enc.flush().buf)
    assert outs[0] == outs[1] and {h.profile for h in tpipeline._parse_frames(outs[1])[0]} == {2}
    assert ft.Encoder.verify_profile(2) == jf.Encoder.verify_profile(2) is not None


# ----------------------------------------------------------------------
# chip_smoke.py's floors and inputs
# ----------------------------------------------------------------------
def test_chip_smoke_p2_snr_floors():
    """chip_smoke.py's Profile 2 and float64 floors are the JAX package's
    SNR on its content minus 0.1 dB, and the port reaches them on the CPU
    with TNS deciding as in the JAX package on all but a few lanes."""
    pcm = chip_smoke.make_audio(chip_smoke.SECONDS, chip_smoke.SRATE, chip_smoke.CHANNELS)
    args = (chip_smoke.SRATE, chip_smoke.BITS, chip_smoke.FSIZE)
    s_jax = jpipeline.batch_encode(pcm, 2, *args, compute_dtype="float32")
    out, _ = jpipeline.batch_decode(s_jax, compute_dtype="float32")
    assert abs(snr_db(pcm, out) - chip_smoke.P2_JAX_SNR_DB) < 1e-3
    assert abs((chip_smoke.P2_JAX_SNR_DB - 0.1) - chip_smoke.P2_SNR_FLOOR_DB) < 1e-3
    short = pcm[: int(chip_smoke.F64_SECONDS * chip_smoke.SRATE)]
    for profile in (1, 2):
        s64 = jpipeline.batch_encode(short, profile, *args, compute_dtype="float64")
        o64, _ = jpipeline.batch_decode(s64, compute_dtype="float64")
        assert abs(snr_db(short, o64) - chip_smoke.F64_JAX_SNR_DB[profile]) < 1e-3
        assert abs((chip_smoke.F64_JAX_SNR_DB[profile] - 0.1)
                   - chip_smoke.F64_SNR_FLOOR_DB[profile]) < 1e-3
    # the port on the same 5 s: lanes whose TNS decision differs, counted
    s_port = ft.batch_encode(short, 2, *args, device=CPU)
    s_jax5 = jpipeline.batch_encode(short, 2, *args, compute_dtype="float32")
    lanes = differing = 0
    for a, b in zip(tpipeline._parse_frames(s_port)[1], tpipeline._parse_frames(s_jax5)[1]):
        if a is None:
            continue
        la, lb = (tprofile2.untrim_streams(tprofile2.unpack_streams(p), chip_smoke.FSIZE, 2)[2]
                  for p in (a, b))
        differing += int((la.reshape(13, 2) != lb.reshape(13, 2)).any(axis=0).sum())
        lanes += 2
    active, total = chip_smoke.tns_lane_share(s_port)
    assert total == lanes == 230 and active > 0.3 * lanes
    assert differing <= 2, f"{differing} of {lanes} lanes decide TNS differently"
    got, _ = ft.batch_decode(s_port, device=CPU)
    want, _ = jpipeline.batch_decode(s_jax5, compute_dtype="float32")
    assert snr_db(short, got) > snr_db(short, want) - 0.1


def smoke_form_tables() -> set:
    """The forms chip_smoke.py's Profile 2 phase holds against plain, from
    its tables (on the card `held()` registers them as it checks)."""
    forms = set()
    for dtype, shapes in chip_smoke.TNS_SHAPES.items():
        for lanes, n in shapes:
            forms.add(("tns_iir", (lanes, n), dtype))
    for dtype, with_div, shapes in chip_smoke.P2_POWER_QUANT_FORMS:
        forms |= {("power_quant", shape, dtype, with_div) for shape in shapes}
    for dtype, shape, olap, i16 in chip_smoke.P2_OVERLAP_FORMS:
        forms.add(("overlap_add", shape, dtype, olap, shape[2] - olap, i16))
    forms |= {("dequant", shape, dtype, with_thres, chip_smoke.SRATE if with_thres else 0)
              for dtype, shape, with_thres in chip_smoke.DEQUANT_FORMS}
    # the TNS analysis kernels are held at the TNS shapes, with a divisor
    for dtype, shapes in chip_smoke.TNS_SHAPES.items():
        for lanes, n in shapes:
            forms |= {("tns_autocorr", (lanes, n), dtype, True),
                      ("tns_fir_gate", (lanes, n), dtype)}
    forms |= {("mask_thres", (rows, n), dtype, chip_smoke.SRATE, ch)
              for dtype, rows, n, ch in chip_smoke.MASK_THRES_FORMS}
    forms |= {("thres_expand", (b, tpsycho.SUBBANDS, ch), dtype, n, chip_smoke.SRATE)
              for dtype, b, n, ch in chip_smoke.THRES_EXPAND_FORMS}
    return forms


def test_chip_smoke_forms_cover_the_float64_runs():
    """Every (shape, dtype, option) at which chip_smoke.py's float64 runs
    call a kernel's wrapper is in its tables of checked forms, and a form
    outside them is reported."""
    short = chip_smoke.make_audio(chip_smoke.F64_SECONDS, chip_smoke.SRATE, chip_smoke.CHANNELS)
    tally = chip_smoke.FormTally(device_type="cpu")      # the plain versions' calls
    with tally:
        for profile in (1, 2):
            s64 = ft.batch_encode(short, profile, chip_smoke.SRATE, chip_smoke.BITS,
                                  chip_smoke.FSIZE, compute_dtype="float64", device=CPU)
            ft.batch_decode(s64, compute_dtype="float64", device=CPU)
    # the tally watches every kernel that a module calls by name: all
    # thirteen but the two trunc kernels, which are held at TRUNC_SHAPES
    assert {name for _, name in tally.targets} == \
        {k.__name__ for k in tkernels.KERNELS} - {"trunc_pack", "trunc_unpack"}
    assert len(tkernels.KERNELS) == 13
    assert tally.seen and all(f[2] == "float64" for f in tally.seen)
    assert {f[0] for f in tally.seen} == set(chip_smoke.P2_KERNELS)
    assert set(tally.seen) <= smoke_form_tables()
    assert set(tally.unchecked()) == set(tally.seen)       # nothing was held here
    # the wrappers are back under the modules' names after the block
    assert tbatch.power_quant is tkernels.power_quant and ttns.tns_iir is tkernels.tns_iir
