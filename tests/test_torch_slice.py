"""The port's Profile 1 batch encode->decode path against the JAX package,
on the CPU at small sizes.

Tolerances: the port and the JAX package sum their float32 GEMMs in
different orders, so quantised symbols of independent encodes may flip by
1 at rint boundaries and int16 PCM may round one step the other way.
Byte-exactness is required where the math is integer: fed the JAX
package's symbols, the port's packer and framer give the JAX stream.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from bench import make_audio
from frad_python_tpu.models import batch as jbatch
from frad_python_tpu.parallel import pipeline as jpipeline
import frad_python_tpu_torch as ft
from frad_python_tpu_torch.models import batch as tbatch
from frad_python_tpu_torch.parallel import pipeline as tpipeline

CPU = torch.device("cpu")
LSB = 1.0 / 32768.0


def snr_db(ref, out):
    m = len(ref)
    err = out[:m] - ref
    return 10 * np.log10(np.sum(ref ** 2) / np.sum(err ** 2))


@pytest.fixture(scope="module")
def audio():
    return make_audio(2.0, 44100, 2)


@pytest.fixture(scope="module")
def jax_stream(audio):
    return jpipeline.batch_encode(audio, 1, 44100, 16, 2048,
                                  compute_dtype="float32", i16_upload=True)


@pytest.fixture(scope="module")
def port_stream(audio):
    return ft.batch_encode(audio, 1, 44100, 16, 2048, i16_upload=True, device=CPU)


@pytest.fixture(scope="module")
def jax_decoded(jax_stream):
    out, _ = jpipeline.batch_decode(jax_stream, compute_dtype="float32", i16_transfer=True)
    return out


def _jax_symbols(monkeypatch):
    """Route the port's encode cores through the JAX package's cores."""
    def i16_core(frames, srate, ll, factor):
        fq, tq = jbatch.p1_encode_core_i16(frames.numpy(), srate, ll, factor)
        return torch.from_numpy(np.array(fq)), torch.from_numpy(np.array(tq))

    def f32_core(frames, srate, ll, factor):
        fq, tq = jbatch.p1_encode_core(frames.numpy(), srate, ll, factor)
        return torch.from_numpy(np.array(fq)), torch.from_numpy(np.array(tq))

    monkeypatch.setattr(tbatch, "p1_encode_core_i16", i16_core)
    monkeypatch.setattr(tbatch, "p1_encode_core", f32_core)


@pytest.mark.parametrize("srate,ch,bits,i16,seconds,olap", [
    (44100, 2, 16, True, 2.0, 16),      # the main path: device EGR, i16 upload
    (48000, 2, 24, False, 1.0, 4),      # device EGR, f32 upload
    (44100, 1, 32, True, 0.5, 16),      # depth > 24: host EGR of every frame
])
def test_packer_and_framer_give_jax_stream_on_jax_symbols(monkeypatch, srate, ch, bits,
                                                          i16, seconds, olap):
    pcm = make_audio(seconds, srate, ch)
    want = jpipeline.batch_encode(pcm, 1, srate, bits, 2048, compute_dtype="float32",
                                  i16_upload=i16, overlap_ratio=olap)
    _jax_symbols(monkeypatch)
    got = ft.batch_encode(pcm, 1, srate, bits, 2048, i16_upload=i16,
                          overlap_ratio=olap, device=CPU)
    assert got == want


#: name: (profile, samples of the 44.1 kHz stereo track, encode options)
STAGED = {
    "p1_f32": (1, 30000, {"compute_dtype": "float32"}),
    "p1_i16": (1, 30000, {"compute_dtype": "float32", "i16_upload": True}),
    "p1_f64": (1, 30000, {"compute_dtype": "float64"}),
    "p2_f32": (2, 30000, {"compute_dtype": "float32"}),
    "p2_f64": (2, 12000, {"compute_dtype": "float64"}),
    # an `Encoder` micro-batch: three frames, no tail, no terminators
    "p1_micro_f32": (1, 2048 + 2 * 1920 + 300, {"compute_dtype": "float32", "final": False}),
    "p1_micro_i16": (1, 2048 + 1920 + 10, {"compute_dtype": "float32", "i16_upload": True,
                                           "final": False}),
    "p1_short_i16": (1, 1000, {"compute_dtype": "float32", "i16_upload": True}),
}


@pytest.mark.parametrize("case", list(STAGED))
def test_staged_frames_give_jax_stream_on_jax_symbols(monkeypatch, audio, case):
    """The port's staged upload frames (every upload dtype, the uniform run
    and the tail frame, a micro-batch, a track shorter than a frame) fed
    to the JAX package's encode cores give the JAX package's stream byte
    for byte: the frames the cores see are the JAX pipeline's."""
    profile, samples, opts = STAGED[case]
    pcm = audio[:samples]
    want = jpipeline.batch_encode(pcm, profile, 44100, 16, 2048, **opts)
    _jax_symbols(monkeypatch)

    def p2_core(frames, srate, ll, factor):
        return tuple(torch.from_numpy(np.array(a))
                     for a in jbatch.p2_encode_core(frames.numpy(), srate, ll, factor))

    monkeypatch.setattr(tbatch, "p2_encode_core", p2_core)
    got = ft.batch_encode(pcm, profile, 44100, 16, 2048, device=CPU, **opts)
    assert got and got == want


def test_stream_frames_follow_plan(audio, port_stream):
    frames, terms = tpipeline.plan_frames(len(audio), 2048, 16, True)
    headers, payloads, tail = tpipeline._parse_frames(port_stream)
    assert tail == b""
    assert sum(p is not None for p in payloads) == len(frames)
    assert [p is None for p in payloads][-terms:] == [True] * terms
    assert sum(p is None for p in payloads) == terms
    assert [h.fsize for h, p in zip(headers, payloads) if p is not None][-1] == 2048


def test_independent_encodes_flip_rate(audio):
    frs, _ = tpipeline.plan_frames(len(audio), 2048, 16, True)
    frs = [f for f in frs if f[1] == 2048]
    arr = tpipeline._to_i16(tpipeline._gather(audio, frs, 2048))
    jf, jt = (np.asarray(a) for a in jbatch.p1_encode_core_i16(arr, 44100, 0.5, 32768.0))
    tf, tt = (a.numpy() for a in tbatch.p1_encode_core_i16(torch.from_numpy(arr), 44100,
                                                           0.5, 32768.0))
    # GEMM summation order differs (XLA:CPU vs torch/MKL): symbols may flip
    # by 1 at rint boundaries; measured 0 flips over these 45 frames
    assert np.abs(tf.astype(np.int64) - jf).max() <= 1
    assert (tf != jf).mean() <= 1e-4
    assert np.abs(tt.astype(np.int64) - jt).max() <= 1
    assert (tt != jt).mean() <= 1e-3


def test_cross_decode_both_ways(audio, jax_stream, port_stream, jax_decoded):
    snr_jax = snr_db(audio, jax_decoded)
    port_on_jax, sr = ft.batch_decode(jax_stream, i16_transfer=True, device=CPU)
    jax_on_port, _ = jpipeline.batch_decode(port_stream, compute_dtype="float32",
                                            i16_transfer=True)
    port_on_port, _ = ft.batch_decode(port_stream, i16_transfer=True, device=CPU)
    assert sr == 44100
    assert port_on_jax.shape == jax_on_port.shape == port_on_port.shape == jax_decoded.shape
    # same stream, IDCT GEMMs summing in other orders: an int16 step at most
    assert np.abs(port_on_jax - jax_decoded).max() <= 2 * LSB
    for out in (port_on_jax, jax_on_port, port_on_port):
        assert abs(snr_db(audio, out) - snr_jax) <= 0.1
    assert snr_jax > 17.0


def test_decode_run_and_fragment_match_jax(jax_stream):
    jh, jp, _ = jpipeline._parse_frames(jax_stream)
    th, tp, _ = tpipeline._parse_frames(jax_stream)
    run = sum(1 for h in jh if h.fsize == jh[0].fsize and h.frmbytes)
    want_out, want_frag = jpipeline._decode_run(
        jh[:run], jp[:run], fix_error=False, compute_dtype="float32",
        i16_transfer=False, i24_transfer=False)
    got_out, got_frag = tpipeline._decode_run(th[:run], tp[:run], i16_transfer=False,
                                              device=CPU)
    assert got_frag.dtype == want_frag.dtype == np.float64
    assert got_frag.shape == want_frag.shape == (128, 2)
    # float32 IDCT of the same symbols: |pcm| < 2, a few ulps of the sum
    np.testing.assert_allclose(got_frag, want_frag, rtol=0, atol=2e-6)
    np.testing.assert_allclose(got_out, want_out, rtol=0, atol=2e-6)


def test_runs_terminators_and_depth_change(audio):
    a = jpipeline.batch_encode(audio[:30000], 1, 44100, 16, 2048,
                               compute_dtype="float32", i16_upload=True)
    b = jpipeline.batch_encode(audio[30000:50000], 1, 44100, 24, 2048,
                               compute_dtype="float32", i16_upload=True)
    a_open = a[:-24]        # without its two 12-byte terminators: a's
    assert a[-24:] == a[-12:] * 2 and a_open[-12:] != a[-12:]   # fragment carries into b
    for stream in (a + b, a_open + b):
        want, _ = jpipeline.batch_decode(stream, compute_dtype="float32")
        got, _ = ft.batch_decode(stream, device=CPU)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_return_remainder_on_format_change(audio):
    a = jpipeline.batch_encode(audio[:20000], 1, 44100, 16, 2048, compute_dtype="float32")
    c = jpipeline.batch_encode(audio[:9000, :1], 1, 48000, 16, 2048, compute_dtype="float32")
    want, wsr, wrem = jpipeline.batch_decode(a + c, compute_dtype="float32",
                                             return_remainder=True)
    got, gsr, grem = ft.batch_decode(a + c, return_remainder=True, device=CPU)
    assert grem == wrem and len(grem) > 0 and gsr == wsr == 44100
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_unported_paths_raise(audio):
    """The paths that once raised NotImplementedError are ported: Profile
    2, and Profile 1 at float64 (the JAX package's default off the TPU),
    decode a JAX stream within 1e-9 at float64 and 2e-6 at float32, and
    encode the JAX float64 stream byte for byte (float64 symbols sit far
    from the rint boundaries on this content); profile 0 decodes to the
    JAX decode within 1e-12 at float64."""
    small = audio[:6000]
    p2 = jpipeline.batch_encode(small, 2, 44100, 16, 2048)
    assert ft.batch_encode(small, 2, 44100, 16, 2048, compute_dtype="float64",
                           device=CPU) == p2
    p1 = jpipeline.batch_encode(small, 1, 44100, 16, 2048)
    assert ft.batch_encode(small, 1, 44100, 16, 2048, compute_dtype="float64",
                           device=CPU) == p1
    ecc = jpipeline.batch_encode(small, 1, 44100, 16, 2048, enable_ecc=True)
    for stream in (ecc, p2):
        got, _ = ft.batch_decode(stream, compute_dtype="float64", device=CPU)
        want, _ = jpipeline.batch_decode(stream)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    got, _ = ft.batch_decode(p2, device=CPU)
    want, _ = jpipeline.batch_decode(p2, compute_dtype="float32")
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    p0 = jpipeline.batch_encode(small, 0, 44100, 16, 2048)
    got, _ = ft.batch_decode(p0, compute_dtype="float64", device=CPU)
    want, _ = jpipeline.batch_decode(p0)
    assert got.shape == want.shape == small.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            ft.batch_encode(small, 1, 44100, 16, 2048)
        with pytest.raises(RuntimeError):
            ft.batch_decode(ecc)


def test_chip_smoke_snr_floor():
    """chip_smoke.py's floor is the JAX package's float32 SNR on its 30 s
    content minus 0.1 dB."""
    np.testing.assert_array_equal(chip_smoke.make_audio(0.1, 44100, 2), make_audio(0.1, 44100, 2))
    pcm = make_audio(chip_smoke.SECONDS, chip_smoke.SRATE, chip_smoke.CHANNELS)
    stream = jpipeline.batch_encode(pcm, 1, chip_smoke.SRATE, chip_smoke.BITS, chip_smoke.FSIZE,
                                    compute_dtype="float32", i16_upload=True)
    out, _ = jpipeline.batch_decode(stream, compute_dtype="float32", i16_transfer=True)
    assert abs((snr_db(pcm, out) - 0.1) - chip_smoke.SNR_FLOOR_DB) < 1e-3
