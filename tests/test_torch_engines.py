"""The port's streaming engines (Encoder, Decoder, Repairer) against the
JAX package's, on the CPU at small sizes with the kernels' plain versions.

The JAX engines are the oracle and run at float32 compute
(FRAD_TPU_COMPUTE_DTYPE=float32), as the port does. Tolerances:

* Encoder bytes: exact when the port's encode core is routed through the
  JAX core (equal symbols): the port groups frames as the JAX engine
  does, so packer, framer and armor must give the JAX stream.
* Independent encodes: symbols may flip by 1 at rint boundaries (float32
  GEMMs summing in other orders): at most 1e-4 of symbols; decoded SNR
  within 0.1 dB of the JAX SNR.
* Decoded PCM: 2e-6 absolute (|pcm| < 2, a few float32 ulps of the IDCT
  sum); `exact` mode bit-identical across push sizes within the port.
"""

import numpy as np
import pytest
import torch

from bench import make_audio
import frad_python_tpu as jf
from frad_python_tpu.container import head as jhead
from frad_python_tpu.models import batch as jbatch
from frad_python_tpu.ops import policy as jpolicy
from frad_python_tpu.parallel import pipeline as jpipeline
import frad_python_tpu_torch as ft
from frad_python_tpu_torch.common import FRM_SIGN
from frad_python_tpu_torch.models import batch as tbatch
from frad_python_tpu_torch.models import profile1 as tprofile1
from frad_python_tpu_torch.parallel import pipeline as tpipeline
from frad_python_tpu_torch.utils.damage import damage_stream

CPU = torch.device("cpu")
ATOL = 2e-6
FSIZE = 2048
FRAME_BYTES_S16 = FSIZE * 2 * 2          # one frame of s16 stereo


@pytest.fixture(autouse=True)
def jax_f32(monkeypatch):
    """The JAX engines compute in float32 for every test of this file."""
    monkeypatch.setenv("FRAD_TPU_COMPUTE_DTYPE", "float32")
    jpolicy.compute_dtype.cache_clear()
    yield
    jpolicy.compute_dtype.cache_clear()


def s16(pcm: np.ndarray) -> bytes:
    return np.clip(np.rint(pcm * 32768.0), -32768, 32767).astype("<i2").tobytes()


@pytest.fixture(scope="module")
def audio():
    return make_audio(0.5, 44100, 2)


@pytest.fixture(scope="module")
def raw(audio):
    return s16(audio)


def encoder(mod, overlap=16, ecc=None, fmt="s16le", fsize=FSIZE, bits=16, channels=2,
            srate=44100):
    kw = dict(device=CPU) if mod is ft else {}
    e = mod.Encoder(1, srate, channels, bits, fsize, fmt, **kw)
    e.set_overlap_ratio(overlap)
    if ecc:
        e.set_ecc(True, ecc)
    return e


def decoder(mod, **kw):
    return mod.Decoder(device=CPU, **kw) if mod is ft else mod.Decoder(**kw)


def encode_all(enc, raw: bytes, chunk: int) -> bytes:
    out = [enc.process(raw[i:i + chunk]).buf for i in range(0, len(raw), chunk)]
    return b"".join(out) + enc.flush().buf


def decode_all(dec, stream: bytes, chunk: int = 32768) -> np.ndarray:
    pcm = [dec.process(stream[i:i + chunk]).pcm for i in range(0, len(stream), chunk)]
    pcm.append(dec.flush().pcm)
    pcm = [p for p in pcm if p.size]
    return np.concatenate(pcm) if pcm else np.empty((0,))


def snr_db(ref, out):
    m = min(len(ref), len(out))
    err = out[:m] - ref[:m]
    return 10 * np.log10(np.sum(ref[:m] ** 2) / np.sum(err ** 2))


def payload_symbols(stream: bytes) -> list[np.ndarray]:
    """Frequency symbols of every Profile 1 payload of an unarmored stream."""
    _, payloads, _ = tpipeline._parse_frames(stream)
    return [tprofile1.unpack_streams(p)[0] for p in payloads if p is not None]


def _jax_core(monkeypatch):
    """Route the port's float32 encode cores through the JAX package's."""
    def f32_core(frames, srate, ll, factor):
        fq, tq = jbatch.p1_encode_core(frames.numpy(), srate, ll, factor)
        return torch.from_numpy(np.array(fq)), torch.from_numpy(np.array(tq))

    def f32_core_p2(frames, srate, ll, factor):
        return tuple(torch.from_numpy(np.array(a))
                     for a in jbatch.p2_encode_core(frames.numpy(), srate, ll, factor))

    monkeypatch.setattr(tbatch, "p1_encode_core", f32_core)
    monkeypatch.setattr(tbatch, "p2_encode_core", f32_core_p2)


@pytest.fixture(scope="module")
def jax_stream(raw):
    """The JAX Encoder's stream of `audio`, overlap 16, 32 KiB pushes."""
    return encode_all(encoder(jf), raw, 32768)


# ----------------------------------------------------------------------
# Encoder
# ----------------------------------------------------------------------
ENC_CFGS = {
    "overlap16": dict(overlap=16),
    "overlap0": dict(overlap=0),
    "ecc96_24": dict(overlap=16, ecc=(96, 24)),
    "set_frame_size": dict(overlap=16),
}
CHUNKS = {"half_frame": FRAME_BYTES_S16 // 2, "17": 17, "32k": 32768, "deep": None}


def _encode_cfg(mod, name, raw, chunk):
    enc = encoder(mod, **ENC_CFGS[name])
    chunk = chunk or len(raw)
    if name != "set_frame_size":
        return encode_all(enc, raw, chunk)
    half = (len(raw) // 8) * 4
    out = [enc.process(raw[i:min(i + chunk, half)]).buf for i in range(0, half, chunk)]
    assert enc.set_frame_size(512) is None        # the carried fragment is now off-grid
    out += [enc.process(raw[i:i + chunk]).buf for i in range(half, len(raw), chunk)]
    return b"".join(out) + enc.flush().buf


@pytest.mark.parametrize("chunk", list(CHUNKS))
@pytest.mark.parametrize("cfg", list(ENC_CFGS))
def test_encoder_bytes_equal_jax_on_jax_symbols(monkeypatch, raw, cfg, chunk):
    """Exact: equal symbols give the JAX Encoder's stream at every push size."""
    want = _encode_cfg(jf, cfg, raw, CHUNKS[chunk])
    _jax_core(monkeypatch)
    got = _encode_cfg(ft, cfg, raw, CHUNKS[chunk])
    assert got == want


@pytest.mark.parametrize("chunk", ["32k", "deep"])
def test_independent_encode_flip_rate_and_snr(audio, raw, jax_stream, chunk):
    """The port's own float32 cores against the JAX stream: flips of at most
    1 on at most 1e-4 of symbols (measured: 0 here, the streams are equal);
    decoded SNR within 0.1 dB of the JAX SNR."""
    got = encode_all(encoder(ft), raw, CHUNKS[chunk] or len(raw))
    want_syms, got_syms = payload_symbols(jax_stream), payload_symbols(got)
    assert [len(s) for s in got_syms] == [len(s) for s in want_syms]
    d = np.concatenate([g.astype(np.int64) - w for g, w in zip(got_syms, want_syms)])
    assert np.abs(d).max() <= 1
    assert np.count_nonzero(d) / d.size <= 1e-4
    snr_port = snr_db(audio, decode_all(decoder(ft), got))
    snr_jax = snr_db(audio, decode_all(decoder(jf), jax_stream))
    assert abs(snr_port - snr_jax) <= 0.1 and snr_jax > 15


def test_push_size_flip_rate_within_port():
    """Per-frame pushes run the DCT GEMM at M = 2 rows, a deep push at
    M = 2k: on the CPU the 16-bit streams are equal at 32 KiB pushes and
    flip 1 symbol by 1 in 94,208 with one deep push (measured). Bound:
    equal bytes at 32 KiB; at most 1e-4 of symbols flipped, by at most 1,
    for the deep push."""
    raw = make_audio(1.0, 44100, 2).astype(">f8").tobytes()
    frame_bytes = FSIZE * 2 * 8

    def run(chunk):
        return encode_all(encoder(ft, fmt="f64be"), raw, chunk)

    per_frame = run(frame_bytes // 2)
    assert run(32768) == per_frame
    a, b = payload_symbols(per_frame), payload_symbols(run(len(raw)))
    assert [len(s) for s in a] == [len(s) for s in b]
    d = np.concatenate([x.astype(np.int64) - y for x, y in zip(a, b)])
    assert np.abs(d).max() <= 1
    assert np.count_nonzero(d) / d.size <= 1e-4


# ----------------------------------------------------------------------
# Decoder
# ----------------------------------------------------------------------
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("chunk", [1, 17, 32768])
def test_decoder_matches_jax(jax_stream, chunk, exact):
    """Within 2e-6 of the JAX Decoder on the same stream and pushes."""
    want = decode_all(decoder(jf, exact=exact), jax_stream, chunk)
    got = decode_all(decoder(ft, exact=exact), jax_stream, chunk)
    assert got.shape == want.shape and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_exact_mode_bit_identical_across_push_sizes(jax_stream):
    ref = decode_all(decoder(ft, exact=True), jax_stream, 32768)
    for chunk in (1, 17, len(jax_stream)):
        np.testing.assert_array_equal(decode_all(decoder(ft, exact=True), jax_stream, chunk), ref)


def test_micro_batched_decode_close_to_exact(jax_stream):
    """One deep push (batch cores + overlap_add) against per-frame: 2e-6."""
    ref = decode_all(decoder(ft, exact=True), jax_stream, 1)
    got = decode_all(decoder(ft), jax_stream, len(jax_stream))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("value,exact", [(None, False), ("1", True), ("0", False),
                                         ("true", False)])
def test_exact_env_variable(monkeypatch, value, exact):
    """Only FRAD_TORCH_EXACT_DECODE=1 turns exact mode on; an explicit
    argument wins over the variable."""
    if value is None:
        monkeypatch.delenv("FRAD_TORCH_EXACT_DECODE", raising=False)
    else:
        monkeypatch.setenv("FRAD_TORCH_EXACT_DECODE", value)
    assert ft.Decoder(device=CPU).exact is exact
    assert ft.Decoder(device=CPU, exact=not exact).exact is (not exact)


def assert_close_scaled(got, ref, block=1920):
    """|got - ref| <= 2e-6 x max(1, peak of ref in the sample's block of
    `block` samples and its neighbours): a payload corrupted into garbage
    symbols decodes to a loud frame whose float32 IDCT error scales with it."""
    assert got.shape == ref.shape
    peak = np.abs(ref).max(axis=1)
    nb = -(-len(peak) // block)
    bp = np.pad(peak, (0, nb * block - len(peak))).reshape(nb, block).max(axis=1)
    bp = np.maximum(bp, np.maximum(np.r_[0.0, bp[:-1]], np.r_[bp[1:], 0.0]))
    scale = np.maximum(1.0, np.repeat(bp, block)[:len(peak)])
    assert (np.abs(got - ref).max(axis=1) <= ATOL * scale).all()


def test_decoder_deep_push_with_corrupt_frame(raw):
    """A payload corrupted beyond repair decodes to the same zero region on
    the per-frame and the micro-batched path (silence is exact); the rest
    agrees to 2e-6 scaled by the local peak (one corrupt frame here
    inflates to garbage with a peak of ~2000)."""
    stream = bytearray(encode_all(encoder(ft), raw, 32768))
    for off in range(len(stream) // 2, len(stream) // 2 + 6):
        stream[off] ^= 0x55
    # frame 3's DEFLATE header names the reserved block type: it cannot inflate
    at = stream.index(FRM_SIGN, stream.index(FRM_SIGN, stream.index(FRM_SIGN, 4) + 4) + 4)
    stream[at + 12] = 0xFF
    stream = bytes(stream)
    ref = decode_all(decoder(ft), stream, 1)
    got = decode_all(decoder(ft), stream, len(stream))
    assert_close_scaled(got, ref)
    z_ref = np.flatnonzero((ref == 0).all(axis=1))
    assert z_ref.size > 0
    np.testing.assert_array_equal(np.flatnonzero((got == 0).all(axis=1)), z_ref)
    assert_close_scaled(got, decode_all(decoder(jf), stream, len(stream)))


# ----------------------------------------------------------------------
# ECC, resync, reconfiguration
# ----------------------------------------------------------------------
@pytest.mark.parametrize("exact", [False, True])
def test_ecc_repairs_corruption(raw, exact):
    stream = encode_all(encoder(ft, ecc=(96, 24)), raw, 32768)
    clean = decode_all(decoder(ft, fix_error=True, exact=exact), stream)
    damaged = bytearray(stream)
    for off in (40, 41, 42):        # payload bytes of the first frame (16-byte header)
        damaged[off] ^= 0xFF
    damaged = bytes(damaged)
    fixed = decode_all(decoder(ft, fix_error=True, exact=exact), damaged)
    np.testing.assert_array_equal(fixed, clean)
    broken = decode_all(decoder(ft, fix_error=False, exact=exact), damaged)
    assert broken.shape == clean.shape and not np.array_equal(broken, clean)
    np.testing.assert_array_equal(
        decode_all(decoder(ft, fix_error=True, exact=exact), damage_stream(stream)), clean)


def test_garbage_prefix_resyncs(jax_stream):
    garbage = b"this is not frad data \x00\x01\x02" * 3
    assert FRM_SIGN not in garbage
    ref = decode_all(decoder(ft), jax_stream)
    np.testing.assert_array_equal(decode_all(decoder(ft), garbage + jax_stream), ref)


def test_truncated_frame_then_resync(jax_stream):
    second = jax_stream.index(FRM_SIGN, 4)
    third = jax_stream.index(FRM_SIGN, second + 4)
    chopped = jax_stream[: third - 100] + jax_stream[third:]
    want = decode_all(decoder(jf), chopped)
    got = decode_all(decoder(ft), chopped)
    assert got.shape == want.shape and len(got) > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("exact", [False, True])
def test_channel_change_flushes_and_crit(exact):
    a1, a2 = make_audio(0.3, 44100, 2), make_audio(0.3, 44100, 1)
    enc = encoder(ft)
    part1 = enc.process(s16(a1)).buf
    res = enc.set_profile(1, 44100, 1, 16, FSIZE)
    assert isinstance(res, ft.EncodeResult) and res.buf
    part1 += res.buf
    part2 = enc.process(s16(a2)).buf + enc.flush().buf
    results = {}
    for mod in (jf, ft):
        dec = decoder(mod, exact=exact)
        # the first push stops at part1's terminators; a later one meets
        # the new layout and returns the old one's tail with crit
        seq = [dec.process(part1 + part2)]
        while not seq[-1].crit and len(seq) < 4:
            seq.append(dec.process(b""))
        head = [r.pcm for r in seq if r.pcm.size]
        assert seq[-1].crit and head and all(p.shape[1] == 2 for p in head)
        rest = [p for p in (dec.process(b"").pcm, dec.flush().pcm) if p.size]
        results[mod] = (np.concatenate(head), np.concatenate(rest))
    # mono frames reach the IDCT as one row, where the two packages' float32
    # sums part further (measured up to 2.15e-6): 4e-6 for this test
    for got, want in zip(results[ft], results[jf]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * ATOL)
    assert results[ft][1].shape[1] == 1


# ----------------------------------------------------------------------
# Repairer
# ----------------------------------------------------------------------
def _repair_streams(raw):
    p1 = encode_all(encoder(ft), raw, 32768)
    p1e = encode_all(encoder(ft, ecc=(96, 24)), raw, 32768)
    p4 = jpipeline.batch_encode(np.random.default_rng(3).standard_normal((3000, 2)) * 0.4,
                                4, 44100, 16, 512)
    hdr = jhead.builder([("k", b"v")], b"")
    return {
        "plain": p1,
        "armored_damaged": damage_stream(p1e),
        "after_terminator": p1 + p4,
        "file_header": hdr + p1,
        "junk": np.random.default_rng(5).integers(0, 256, 5000, dtype=np.uint8).tobytes(),
    }


@pytest.mark.parametrize("chunk", [17, 32768, None])
def test_repairer_equals_batch_repair_and_jax(raw, chunk):
    """Exact: Repairer.process + flush gives batch_repair's bytes and the
    JAX Repairer's, at every push size, on every stream."""
    for name, stream in _repair_streams(raw).items():
        pushes = chunk or len(stream)
        rep = ft.Repairer((96, 24))
        got = b"".join(rep.process(stream[i:i + pushes])
                       for i in range(0, len(stream), pushes)) + rep.flush()
        jrep = jf.Repairer((96, 24))
        assert got == jrep.process(stream) + jrep.flush(), name
        assert got == ft.batch_repair(stream, (96, 24)), name


def test_repairer_rearmors_and_keeps_audio(raw):
    plain, armored_damaged = (_repair_streams(raw)[k] for k in ("plain", "armored_damaged"))
    clean = decode_all(decoder(ft), plain)
    rep = ft.Repairer((96, 24))
    armored = rep.process(plain) + rep.flush()
    assert len(armored) > len(plain)
    headers, payloads, tail = tpipeline._parse_frames(armored)
    assert not tail and all(h.ecc for h, p in zip(headers, payloads) if p is not None)
    np.testing.assert_array_equal(decode_all(decoder(ft, fix_error=True), armored), clean)
    rep = ft.Repairer((96, 24))
    repaired = rep.process(armored_damaged) + rep.flush()
    np.testing.assert_array_equal(decode_all(decoder(ft, fix_error=False), repaired), clean)


def test_repairer_passes_a_truncated_last_frame_through(raw):
    """The port's Repairer passes a truncated last frame through whole, as
    batch_repair does; the JAX Repairer drops that frame's header bytes."""
    stream = encode_all(encoder(ft, ecc=(96, 24)), raw, 32768)[:-300]
    rep = ft.Repairer((96, 24))
    got = rep.process(stream) + rep.flush()
    assert got == ft.batch_repair(stream) == jpipeline.batch_repair(stream)
    jrep = jf.Repairer((96, 24))
    jgot = jrep.process(stream) + jrep.flush()
    assert len(got) - len(jgot) == 16 and got.endswith(stream[-100:])


def test_repairer_ratio_warnings():
    assert ft.Repairer((0, 10)).ecc_ratio == (96, 24)
    for ratio in ((0, 10), (200, 100), (48, 12)):
        assert ft.Repairer(ratio).warnings == jf.Repairer(ratio).warnings


# ----------------------------------------------------------------------
# Validation gauntlet
# ----------------------------------------------------------------------
@pytest.mark.parametrize("profile", range(8))
def test_validation_strings_match_jax(profile):
    for srate in (0, 44100, 44101, 48000, 200000):
        for channels in (0, 2):
            for bits in (0, 13, 16, 24, 64):
                for fsize in (0, 2048, 30000):
                    args = (profile, srate, channels, bits, fsize, "f64be")
                    try:
                        jf.Encoder(*args)
                        want = None
                    except ValueError as e:
                        want = str(e)
                    if want is not None:
                        with pytest.raises(ValueError) as e:
                            ft.Encoder(*args, device=CPU)
                        assert str(e.value) == want, args
                    else:
                        # every profile the gauntlet admits (0, 1, 4) is ported
                        assert profile in (0, 1, 4)
                        ft.Encoder(*args, device=CPU)
    for name in ("verify_profile", "verify_srate", "verify_bit_depth", "verify_frame_size",
                 "verify_channels"):
        if name == "verify_profile":
            assert ft.Encoder.verify_profile(profile) == jf.Encoder.verify_profile(profile)
            continue
        if jf.Encoder.verify_profile(profile) is not None:
            continue
        for v in (0, 1, 13, 16, 44100, 44101, 30000):
            assert getattr(ft.Encoder, name)(profile, v) == getattr(jf.Encoder, name)(profile, v)


def test_setters_and_ecc_messages_match_jax(monkeypatch, raw):
    j, t = jf.Encoder(1, 44100, 2, 16, 2048), ft.Encoder(1, 44100, 2, 16, 2048, device=CPU)
    for ratio in ((0, 10), (200, 100), (48, 12)):
        assert t.set_ecc(True, ratio) == j.set_ecc(True, ratio)
        assert (t.asfh.ecc_dsize, t.asfh.ecc_codesize) == (j.asfh.ecc_dsize, j.asfh.ecc_codesize)
    for v in (0, 30000, 4096):
        assert t.set_frame_size(v) == j.set_frame_size(v)
    for v in (0, 13, 24):
        assert t.set_bit_depth(v) == j.set_bit_depth(v)
    assert t.set_srate(44101) == j.set_srate(44101)
    assert t.set_channels(0) == j.set_channels(0)
    assert t.set_profile(2, 44100, 2, 16, 2048) == j.set_profile(2, 44100, 2, 16, 2048)
    res = t.set_profile(0, 44100, 2, 16, 2048)
    assert isinstance(res, ft.EncodeResult) and t.get_profile() == 0
    # Profile 1 at float64, per frame and micro-batched: the JAX Encoder's
    # float64 bytes (float64 symbols sit far from the rint boundaries: no
    # flip on this content)
    monkeypatch.setenv("FRAD_TORCH_COMPUTE_DTYPE", "float64")
    monkeypatch.setenv("FRAD_TPU_COMPUTE_DTYPE", "float64")
    jpolicy.compute_dtype.cache_clear()
    for chunk in (FRAME_BYTES_S16 // 2, len(raw)):
        assert encode_all(encoder(ft), raw, chunk) == encode_all(encoder(jf), raw, chunk)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            ft.Encoder(1, 44100, 2, 16, 2048)
        with pytest.raises(RuntimeError):
            ft.Decoder()


# ----------------------------------------------------------------------
# state_dict
# ----------------------------------------------------------------------
def _split_encode(enc, raw, at):
    return enc.process(raw[:at]).buf, enc.process(raw[at:]).buf + enc.flush().buf


def test_encoder_state_round_trip(raw):
    """Exact: a resumed Encoder writes the bytes the uninterrupted one does."""
    ref = b"".join(_split_encode(encoder(ft), raw, 5000))
    enc = encoder(ft)
    out = enc.process(raw[:5000]).buf
    enc2 = encoder(ft, overlap=0)
    enc2.load_state_dict(enc.state_dict())
    assert out + enc2.process(raw[5000:]).buf + enc2.flush().buf == ref
    # suspended on a frame boundary with nothing carried: the resumed
    # flush writes only terminators, which repeat the last frame's header
    enc, whole = encoder(ft, overlap=0), encoder(ft, overlap=0)
    n = 3 * FRAME_BYTES_S16
    first = enc.process(raw[:n]).buf
    enc2 = encoder(ft)
    enc2.load_state_dict(enc.state_dict())
    tail = enc2.flush().buf
    assert len(tail) == 12 and first + tail == whole.process(raw[:n]).buf + whole.flush().buf


def test_encoder_jax_state_hand_over(monkeypatch, raw):
    """A JAX Encoder suspended mid-stream finishes in the port: exact bytes
    at equal symbols."""
    ref = b"".join(_split_encode(encoder(jf), raw, 20000))
    jenc = encoder(jf)
    out = jenc.process(raw[:20000]).buf
    state = jenc.state_dict()
    _jax_core(monkeypatch)
    enc = encoder(ft)
    enc.load_state_dict(state)
    assert out + enc.process(raw[20000:]).buf + enc.flush().buf == ref
    # a state dict that names profile 2 loads and encodes, as in the JAX package
    state["profile"] = 2
    jenc2, enc2 = encoder(jf), encoder(ft)
    jenc2.load_state_dict(state)
    enc2.load_state_dict(state)
    want = jenc2.process(raw[20000:]).buf + jenc2.flush().buf
    got = enc2.process(raw[20000:]).buf + enc2.flush().buf
    assert got == want and enc2.get_profile() == 2
    headers, payloads, _ = tpipeline._parse_frames(got)
    assert {h.profile for h in headers} == {2} and sum(p is not None for p in payloads) > 4


@pytest.mark.parametrize("cut", [2500, 4000, 7001])
def test_decoder_state_round_trip(jax_stream, cut):
    """Exact mode, suspended anywhere (mid-header or mid-payload): the
    resumed decode equals the uninterrupted one bit for bit."""
    ref = decode_all(decoder(ft, exact=True), jax_stream)
    dec = decoder(ft, exact=True)
    p1 = dec.process(jax_stream[:cut]).pcm
    dec2 = decoder(ft)
    dec2.load_state_dict(dec.state_dict())
    assert dec2.exact
    got = np.concatenate([p for p in (p1, decode_all(dec2, jax_stream[cut:])) if p.size])
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("exact", [False, True])
def test_decoder_jax_state_hand_over(jax_stream, exact):
    """A JAX Decoder suspended mid-stream finishes in the port as it would
    in the JAX package (within 2e-6)."""
    jdec = decoder(jf, exact=exact)
    p1 = jdec.process(jax_stream[:9000]).pcm
    state = jdec.state_dict()
    want_dec, got_dec = decoder(jf), decoder(ft)
    want_dec.load_state_dict(state)
    got_dec.load_state_dict(state)
    want, got = decode_all(want_dec, jax_stream[9000:]), decode_all(got_dec, jax_stream[9000:])
    assert p1.size and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


# ----------------------------------------------------------------------
# Adversarial input: no exception at all
# ----------------------------------------------------------------------
def test_random_bytes_never_crash():
    r = np.random.default_rng(99)
    for _ in range(8):
        junk = r.integers(0, 256, size=int(r.integers(10, 60000)), dtype=np.uint8).tobytes()
        for exact in (False, True):
            assert decode_all(decoder(ft, fix_error=True, exact=exact), junk).size == 0
        rep = ft.Repairer()
        assert rep.process(junk) + rep.flush() == junk


def test_random_truncations_never_crash():
    raw = make_audio(0.3, 44100, 2).astype(">f8").tobytes()
    enc = encoder(ft, fmt="f64be", fsize=1024, ecc=(96, 24))
    stream = encode_all(enc, raw, 32768)
    cuts = sorted(int(c) for c in np.random.default_rng(7).integers(1, len(stream), size=6))
    for exact in (False, True):
        d = decoder(ft, fix_error=True, exact=exact)
        prev = 0
        for c in cuts + [len(stream)]:
            d.process(stream[prev:c])
            prev = c
        d.flush()


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_bitflip_storm_never_crashes(seed):
    """1% of bytes flipped, beyond RS capacity: the decode ends with finite
    output, whatever profile a flipped header names."""
    raw = make_audio(0.3, 44100, 2).astype(">f8").tobytes()
    stream = bytearray(encode_all(encoder(ft, fmt="f64be", fsize=1024, ecc=(96, 24)),
                                  raw, 32768))
    r = np.random.default_rng(seed)
    for off in r.integers(0, len(stream), size=len(stream) // 100):
        stream[int(off)] ^= int(r.integers(1, 256))
    for exact in (False, True):
        got = decode_all(decoder(ft, fix_error=True, exact=exact), bytes(stream), len(stream))
        assert np.all(np.isfinite(got))


@pytest.mark.parametrize("host", ["native", "numpy"])
def test_corrupt_payloads_raise_nothing(monkeypatch, host):
    """The engines catch no exception on the payload path because the host
    byte layer raises none on a corrupt payload: flipped bytes, garbage of
    the same length and zeroed payloads, armored or not, repaired or not,
    on both host paths, decode to the clean decode's shape."""
    if host == "numpy":
        monkeypatch.setenv("FRAD_TORCH_NO_NATIVE", "1")
    raw = make_audio(0.12, 44100, 2).astype(">f8").tobytes()
    r = np.random.default_rng(11)
    for ecc in (None, (96, 24), (20, 200)):
        stream = encode_all(encoder(ft, fmt="f64be", fsize=1024, ecc=ecc), raw, 32768)
        clean = decode_all(decoder(ft), stream)
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
                for exact in (False, True):
                    got = decode_all(decoder(ft, fix_error=fix, exact=exact), bytes(bad), 4096)
                    assert got.shape == clean.shape, (ecc, kind, fix, exact)


@pytest.mark.parametrize("exact", [False, True])
def test_unported_profile_raises(monkeypatch, exact):
    """The two paths that once raised NotImplementedError: Profile 2
    frames decode as in the JAX package (float32, within 2e-6), and so do
    Profile 1 and 2 frames at float64 (within 1e-9)."""
    audio = make_audio(0.1, 44100, 2)
    p2 = jpipeline.batch_encode(audio, 2, 44100, 16, 1024, compute_dtype="float32")
    want = decode_all(decoder(jf, exact=exact), p2)
    got = decode_all(decoder(ft, exact=exact), p2)
    assert got.shape == want.shape and len(got) >= len(audio)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    monkeypatch.setenv("FRAD_TORCH_COMPUTE_DTYPE", "float64")
    monkeypatch.setenv("FRAD_TPU_COMPUTE_DTYPE", "float64")
    jpolicy.compute_dtype.cache_clear()
    for profile in (1, 2):
        stream = jpipeline.batch_encode(audio, profile, 44100, 16, 1024)
        want = decode_all(decoder(jf, exact=exact), stream)
        got = decode_all(decoder(ft, exact=exact), stream)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


# ----------------------------------------------------------------------
# Errors from the kernels propagate
# ----------------------------------------------------------------------
def _boom(*args, **kwargs):
    raise RuntimeError("kernel failed")


@pytest.mark.parametrize("chunk", ["half_frame", "deep"])
def test_power_quant_error_propagates(monkeypatch, raw, chunk):
    """From the per-frame path and from _micro_batch alike."""
    monkeypatch.setattr(tbatch, "power_quant", _boom)
    enc = encoder(ft)
    with pytest.raises(RuntimeError, match="kernel failed"):
        encode_all(enc, raw, CHUNKS[chunk] or len(raw))


def test_overlap_add_error_propagates(monkeypatch, jax_stream):
    monkeypatch.setattr(tbatch, "overlap_add", _boom)
    with pytest.raises(RuntimeError, match="kernel failed"):
        decoder(ft).process(jax_stream)
    decode_all(decoder(ft, exact=True), jax_stream)     # the per-frame path runs no overlap_add


def test_per_frame_decode_error_propagates(monkeypatch, jax_stream):
    monkeypatch.setattr(tbatch, "idct2", _boom)
    with pytest.raises(RuntimeError, match="kernel failed"):
        decoder(ft, exact=True).process(jax_stream)


# ----------------------------------------------------------------------
# batch_decode's streaming hand-off
# ----------------------------------------------------------------------
def _batch_pair(stream, **kw):
    want = jpipeline.batch_decode(stream, compute_dtype="float32", **kw)
    got = ft.batch_decode(stream, device=CPU, **kw)
    return got, want


@pytest.mark.parametrize("case", ["empty", "terminators_only"])
def test_batch_decode_without_payload_frame(audio, case):
    stream = b"" if case == "empty" else jpipeline.batch_encode(audio[:0], 1, 44100, 16, 2048)
    (got, gsr), (want, wsr) = _batch_pair(stream)
    assert got.shape == want.shape and gsr == wsr


@pytest.mark.parametrize("i16", [False, True])
def test_batch_decode_unparsable_tail(jax_stream, i16):
    """A truncated file: the runs decode batched, the tail streams."""
    stream = jax_stream[:-700]
    (got, gsr), (want, wsr) = _batch_pair(stream, i16_transfer=i16)
    assert got.shape == want.shape and gsr == wsr == 44100
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 / 32768 if i16 else ATOL)


def decode_pushes(dec, stream: bytes, chunk: int = 32768) -> np.ndarray:
    """`app/decode.py`'s loop: pushes of `chunk` bytes until the input is
    spent and the decoder is empty, then `flush()`."""
    pcm, pos = [], 0
    while pos < len(stream) or not dec.is_empty():
        assert pos < len(stream) + 8 * chunk, "the decoder never empties"
        pcm.append(dec.process(stream[pos:pos + chunk]).pcm)
        pos += chunk
    pcm = [p for p in (*pcm, dec.flush().pcm) if p.size]
    return np.concatenate(pcm) if pcm else np.empty((0,))


@pytest.mark.parametrize("host", ["native", "numpy"])
@pytest.mark.parametrize("engine", ["batch_decode", "Decoder"])
def test_batch_decode_long_fragment(monkeypatch, audio, engine, host):
    """A 1024-sample fragment (fsize 2048, overlap 2) runs into frames of
    256 samples (emit window 240): the streaming crossfade takes it, in
    `batch_decode`'s hand-off and in the Decoder's own drains."""
    if host == "numpy":
        monkeypatch.setenv("FRAD_TORCH_NO_NATIVE", "1")
    a = jpipeline.batch_encode(audio[:20000], 1, 44100, 16, 2048, overlap_ratio=2,
                               compute_dtype="float32")
    assert a[-24:] == a[-12:] * 2
    a = a[:-24]                 # without its terminators, so the fragment carries on
    b = jpipeline.batch_encode(audio[20000:], 1, 44100, 16, 256, overlap_ratio=16,
                               compute_dtype="float32")
    if engine == "Decoder":
        got, want = decode_pushes(decoder(ft), a + b), decode_pushes(decoder(jf), a + b)
        assert got.shape == want.shape and len(got) > 20000
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
        return
    (got, _), (want, _) = _batch_pair(a + b)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    (got, _, grem), (want, _, wrem) = _batch_pair(a + b, return_remainder=True)
    assert grem == wrem == b""
