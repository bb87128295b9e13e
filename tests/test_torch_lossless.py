"""The port's lossless profiles 0 and 4 against the JAX package, on the CPU
at small sizes (frames of 256 to 2048 samples, under a second of audio,
plus 2 frames at N = 16384), with the kernels' plain versions.

Tolerances, each with its reason:

* Host byte layer (truncated-float packing, framing, armor, repair):
  byte for byte.
* Profile 4: byte for byte (no arithmetic), decoded PCM exactly.
* Profile 0 at float64: the DCT is the FFT form on both sides, in the same
  order of operations; the FFTs (pocketfft in XLA, torch's on the CPU)
  differ in the last bits of f64, which the 12-32-bit containers never
  see: byte for byte. At 48 bits a last-bit difference crosses a 36-bit
  truncation about once in 2^16 values: differing bytes are counted and
  held under 1% of the payload. At 64 bits every bit is stored: the
  decoded PCM agrees within 1e-12 (|pcm| < 2; f64 FFT error ~1e-15).
* Profile 0 at float32: GEMMs summing in other orders move the last f32
  bits and so the truncated bytes; decoded SNR within 0.1 dB of the JAX
  package's, decoded PCM of one stream within 2e-6 (|pcm| < 2, a few
  float32 ulps of the IDCT sum).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from bench import make_audio
import frad_python_tpu as jf
from frad_python_tpu import native as jnative
from frad_python_tpu.models import profile0 as jprofile0
from frad_python_tpu.ops import bitpack as jbitpack
from frad_python_tpu.ops import dct as jdct
from frad_python_tpu.ops import packing as jpacking
from frad_python_tpu.ops import policy as jpolicy
from frad_python_tpu.parallel import pipeline as jpipeline
import frad_python_tpu_torch as ft
from frad_python_tpu_torch import kernels, native
from frad_python_tpu_torch.common import FRM_SIGN
from frad_python_tpu_torch.models import batch as tbatch
from frad_python_tpu_torch.models import profile0 as tprofile0
from frad_python_tpu_torch.models import profile1 as tprofile1
from frad_python_tpu_torch.ops import bitpack as tbitpack
from frad_python_tpu_torch.ops import dct as tdct
from frad_python_tpu_torch.ops import packing as tpacking
from frad_python_tpu_torch.parallel import pipeline as tpipeline

CPU = torch.device("cpu")
DEPTHS = (12, 16, 24, 32, 48, 64)
#: decoded float32 PCM of one stream, the two packages' IDCT GEMMs apart
F32_ATOL = 2e-6


@pytest.fixture
def f64(monkeypatch):
    """Both packages compute the lossless transform in float64."""
    monkeypatch.setenv("FRAD_TPU_COMPUTE_DTYPE", "float64")
    monkeypatch.setenv("FRAD_TORCH_COMPUTE_DTYPE", "float64")
    jpolicy.compute_dtype.cache_clear()
    yield
    jpolicy.compute_dtype.cache_clear()


@pytest.fixture
def f32(monkeypatch):
    """Both packages compute in float32 (the JAX accelerator default)."""
    monkeypatch.setenv("FRAD_TPU_COMPUTE_DTYPE", "float32")
    monkeypatch.delenv("FRAD_TORCH_COMPUTE_DTYPE", raising=False)
    jpolicy.compute_dtype.cache_clear()
    yield
    jpolicy.compute_dtype.cache_clear()


def snr_db(ref, out):
    m = len(ref)
    err = out[:m] - ref
    return 10 * np.log10(np.sum(ref ** 2) / np.sum(err ** 2))


def assert_f64_close(got, want):
    """f64 decodes of one stream: the FFTs' last bits, scaled by the peak
    (a corrupt payload decodes to a loud frame)."""
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * max(1.0, np.abs(want).max()))


def bdis(stream: bytes) -> list[int]:
    headers, payloads, _ = tpipeline._parse_frames(stream)
    return [h.bit_depth_index for h, p in zip(headers, payloads) if p is not None]


def edge_values(n: int, seed: int) -> np.ndarray:
    """Normal values with the truncation edges mixed in: the f16 range
    (65504, rounding to inf from 65520), f16 and f32 subnormals, signed
    zeros, infinities and NaN."""
    v = np.random.default_rng(seed).standard_normal(n) * 30.0
    edges = [65504.0, 65519.99, 65520.0, -65520.0, 1e5, 6e-8, -3e-8, 6.1e-5, 1e-40,
             -0.0, 0.0, np.inf, -np.inf, np.nan, 3.4e38, 1e39, 1e-300, 2.0 ** -24]
    v[: len(edges)] = edges
    return v


# ----------------------------------------------------------------------
# Host packing
# ----------------------------------------------------------------------
@pytest.mark.parametrize("host", ["native", "numpy"])
@pytest.mark.parametrize("little", [False, True])
@pytest.mark.parametrize("bits", DEPTHS)
def test_packing_equals_jax(monkeypatch, bits, little, host):
    """Byte for byte, both sizes of the native threshold, with edges."""
    if host == "numpy":
        monkeypatch.setenv("FRAD_TORCH_NO_NATIVE", "1")
    for n in (20, 5000):
        v = edge_values(n, n + bits)
        with np.errstate(over="ignore", invalid="ignore"):
            got = tpacking.pack_floats(v, bits, little)
            want = jpacking.pack_floats(v, bits, little)
        assert got == want
        np.testing.assert_array_equal(tpacking.unpack_floats(got, bits, little),
                                      jpacking.unpack_floats(got, bits, little))
        f32 = v.astype(np.float32)
        with np.errstate(over="ignore", invalid="ignore"):
            assert tpacking.pack_floats(f32, bits, little) == jpacking.pack_floats(
                f32, bits, little)
    assert tpacking.DEPTHS == jpacking.DEPTHS and tpacking.FLOAT_MAX == jpacking.FLOAT_MAX
    for m in (0.0, 65504.0, 65505.0, 3.5e38, 1e300):
        assert tpacking.needed_depth(m, bits) == jpacking.needed_depth(m, bits)
    with pytest.raises(OverflowError):
        tpacking.needed_depth(np.inf, bits)


def test_unpack_partial_values_as_jax():
    """A partial trailing value: 16/32/64 bits raise ValueError as numpy
    (and the JAX package) does; 12/24/48 bits drop it."""
    for bits in DEPTHS:
        for n in (0, 1, 5, 13):
            raw = bytes(range(n))
            if tpacking.whole_values(n, bits):
                np.testing.assert_array_equal(tpacking.unpack_floats(raw, bits, False),
                                              jpacking.unpack_floats(raw, bits, False))
            else:
                with pytest.raises(ValueError):
                    jpacking.unpack_floats(raw, bits, False)
                with pytest.raises(ValueError):
                    tpacking.unpack_floats(raw, bits, False)


def test_native_lossless_wrappers_equal_jax_native():
    """The six newly bound entry points against the JAX package's own
    bindings of the same C++ source, and their call counters."""
    assert jnative.available()
    native.reset_calls()
    rng = np.random.default_rng(5)
    mat = rng.standard_normal((7, 3000)) * 100
    mat[2, 5] = np.nan
    for bits in (16, 24, 32, 48, 64):
        for little in (False, True):
            assert native.pack_floats(mat, bits, little) == jnative.pack_floats(mat, bits, little)
            blob, m = native.pack_floats_maxabs(mat, bits, little)
            jblob, jm = jnative.pack_floats_maxabs(mat, bits, little)
            assert blob == jblob
            np.testing.assert_array_equal(m, jm)
            np.testing.assert_array_equal(native.unpack_floats(blob, bits, little),
                                          jnative.unpack_floats(blob, bits, little))
    np.testing.assert_array_equal(native.maxabs_rows(mat), jnative.maxabs_rows(mat))
    pcm = np.clip(rng.standard_normal(4000) * 0.4, -1.2, 1.2)
    tri = native.f64_to_i24(pcm)
    np.testing.assert_array_equal(tri, jnative.f64_to_i24(pcm))
    np.testing.assert_array_equal(native.i24_to_f64(tri.tobytes()),
                                  jnative.i24_to_f64(tri.tobytes()))
    with pytest.raises(ValueError):
        native.i24_to_f64(b"\x00" * 4)
    with pytest.raises(ValueError):
        native.pack_floats(mat, 12, False)
    calls = {w.__name__: w.calls for w in native.WRAPPERS}
    assert calls["pack_floats"] == 10 and calls["pack_floats_maxabs"] == 10
    assert calls["unpack_floats"] == 10 and calls["maxabs_rows"] == 1
    assert calls["f64_to_i24"] == 1 and calls["i24_to_f64"] == 1


def test_frame_pack_batch_joined_form():
    """The (blob, offsets) form frames the same bytes as the list form; bad
    offsets raise."""
    rng = np.random.default_rng(3)
    parts = [rng.integers(0, 256, k, dtype=np.uint8).tobytes() for k in (300, 0, 1000, 77)]
    offsets = np.concatenate([[0], np.cumsum([len(p) for p in parts])])
    kw = dict(profile=0, is_compact=False, channels=2, srate=44100, ecc=True,
              ecc_dsize=96, ecc_codesize=24)
    bd, fs = np.full(4, 2, np.uint8), np.full(4, 2048, np.uint32)
    want = native.frame_pack_batch(parts, bd, fs, None, **kw)
    assert native.frame_pack_batch((b"".join(parts), offsets), bd, fs, None, **kw) == want
    assert want == jnative.frame_pack_batch(parts, bd, fs, None, **kw)
    with pytest.raises(ValueError):
        native.frame_pack_batch((b"".join(parts), offsets[:-1]), bd[:3], fs[:3], None, **kw)


# ----------------------------------------------------------------------
# Device packing: plain versions of the trunc kernels
# ----------------------------------------------------------------------
@pytest.mark.parametrize("little", [False, True])
@pytest.mark.parametrize("bits", [16, 24, 32])
def test_trunc_pack_unpack_plain_equal_jax(bits, little):
    """Byte for byte against the JAX device program and the host packing,
    with the f16 edges (65504, inf from 65520, subnormals, signed zeros)."""
    rng = np.random.default_rng(bits)
    x = (rng.standard_normal((3, 512)) * 3e4).astype(np.float32)
    x[0, :10] = [65504, 65519.99, 65520, -65520, 6e-8, -3e-8, 6.1e-5, -0.0, 0.0, 1e-40]
    words = tbitpack.trunc_pack_plain(torch.from_numpy(x), bits, little)
    jw = np.asarray(jbitpack.trunc_pack(x, bits, little))
    assert words.numpy().tobytes() == jw.tobytes()
    assert words.dtype == (torch.int16 if bits == 16 else torch.int32)
    for i in range(3):
        assert words[i].numpy().tobytes() == tpacking.pack_floats(x[i], bits, little)
    back = tbitpack.trunc_unpack_plain(words, bits, little)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jbitpack.trunc_unpack(jw, bits, little)))
    np.testing.assert_array_equal(
        back.numpy()[0], tpacking.unpack_floats(words[0].numpy().tobytes(), bits, little))


@pytest.mark.parametrize("bits", [16, 24, 32])
def test_trunc_kernel_wrappers_plain_path(bits):
    """On CPU tensors the kernel wrappers run their plain versions (no
    launch): the frame-major interleave of the [B, C, N] DCT output, its
    max|x| (NaN for a NaN frame, as jnp.max), and the inverse into the
    IDCT's layout; other devices are refused."""
    rng = np.random.default_rng(9)
    y = (rng.standard_normal((4, 2, 256)) * 100).astype(np.float32)
    y[1, 1, 7] = np.nan
    y[2, 0, 3] = -np.inf
    kernels.reset_launches()
    words, maxabs = kernels.trunc_pack(torch.from_numpy(y), bits, False)
    flat = y.transpose(0, 2, 1).reshape(4, -1)
    for b in range(4):
        assert words[b].numpy().tobytes() == tpacking.pack_floats(flat[b], bits, False)
    np.testing.assert_array_equal(maxabs.numpy(),
                                  np.asarray(jnp.max(jnp.abs(jnp.asarray(flat)), axis=1)))
    assert np.isnan(maxabs[1]) and np.isinf(maxabs[2])
    back = kernels.trunc_unpack(words, bits, False, 256, 2)
    assert back.shape == (4, 2, 256) and back.is_contiguous()
    np.testing.assert_array_equal(back.numpy().transpose(0, 2, 1).reshape(4, -1),
                                  np.asarray(jbitpack.trunc_unpack(
                                      words.numpy().view("<u2" if bits == 16 else "<u4"),
                                      bits, False)))
    assert kernels.trunc_pack.launches == 0 and kernels.trunc_unpack.launches == 0
    with pytest.raises(ValueError):
        kernels.trunc_pack(torch.empty((2, 2, 8), device="meta"), bits, False)
    with pytest.raises(ValueError):
        kernels.trunc_unpack(torch.empty((2, 8), dtype=torch.int32, device="meta"), bits,
                             False, 4, 2)


@pytest.mark.parametrize("host", ["native", "numpy"])
def test_i24_transfer_forms_equal_jax(monkeypatch, host):
    """int24 words, host and device forms, against the JAX package's."""
    if host == "numpy":
        monkeypatch.setenv("FRAD_TORCH_NO_NATIVE", "1")
    pcm = make_audio(0.05, 44100, 2)[:2048]
    pcm[:4, 0] = [1.0, -1.0, 0.9999999, -1.5]
    w = tbitpack.pcm_to_i24_words_host(pcm)
    np.testing.assert_array_equal(w, jbitpack.pcm_to_i24_words_host(pcm))
    words = w.reshape(2, -1).view(np.int32)
    dev = tbitpack.i24_words_to_pcm_device(torch.from_numpy(words))
    np.testing.assert_array_equal(dev.numpy(), np.asarray(jbitpack.i24_words_to_pcm_device(
        words.view(np.uint32))))
    np.testing.assert_array_equal(tbitpack.i24_words_to_pcm(words),
                                  jbitpack.i24_words_to_pcm(words.view(np.uint32)))
    frames = torch.from_numpy(pcm.reshape(2, 1024, 2).astype(np.float32))
    back = tbitpack.pcm_to_i24_words(frames)
    assert back.numpy().tobytes() == np.asarray(jbitpack.pcm_to_i24_words(
        frames.numpy())).tobytes()


# ----------------------------------------------------------------------
# The FFT form of the DCT
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n", [256, 2040, 16384])
def test_fft_dct_f64_equals_jax(n):
    """float64 FFT form against the JAX package's: relative error < 1e-14
    (the two FFTs' last bits), both directions."""
    x = np.random.default_rng(n).standard_normal((3, 2, n)) * 0.5
    want = np.asarray(jdct.dct2_forward(x))
    got = tdct.dct2(torch.from_numpy(x)).numpy()
    scale = np.abs(want).max()
    assert got.dtype == np.float64 and np.abs(got - want).max() < 1e-14 * scale
    back_want = np.asarray(jdct.idct2_forward(want))
    back = tdct.idct2(torch.from_numpy(want)).numpy()
    assert np.abs(back - back_want).max() < 1e-14 * np.abs(back_want).max()
    np.testing.assert_allclose(back, x, rtol=0, atol=1e-13)
    assert not tdct.use_matmul(n, torch.float64)


def test_fft_dct_f32_above_matrix_cap():
    """float32 at N = 16384 takes the complex64 FFT form, as in the JAX
    package: the two agree within 2e-5 of the coefficients' peak (f32 FFT
    rounding over 14 stages), and the round trip holds 1e-5."""
    n = 16384
    x = (np.random.default_rng(1).standard_normal((2, 2, n)) * 0.5).astype(np.float32)
    assert tdct.use_matmul(8192, torch.float32) and not tdct.use_matmul(n, torch.float32)
    want = np.asarray(jdct.dct2_forward(x))
    got = tdct.dct2(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()
    back = tdct.idct2(torch.from_numpy(got)).numpy()
    np.testing.assert_allclose(back, x, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", [2048, 2500, 4096])
def test_dct_gemm_cut_above_split(n):
    """One form on every device: the float32 DCT and IDCT run as one GEMM
    up to K_SPLIT_ABOVE and as K_CHUNK-long GEMMs above it, here on the
    CPU as on the card: bit for bit the same as that form's call."""
    x = torch.from_numpy(np.random.default_rng(n).standard_normal((3, 2, n))
                         .astype(np.float32) * 0.3)
    fwd, inv = tdct.device_matrices(n, CPU)
    form = ((lambda a, w: tdct.matmul_rows_chunked(a, w, tdct.K_CHUNK))
            if n > tdct.K_SPLIT_ABOVE else tdct.matmul_rows)
    assert torch.equal(tdct.dct2(x), form(x, fwd))
    assert torch.equal(tdct.idct2(x), form(x, inv))


@pytest.mark.parametrize("k", [1024, 2500, 4096])
def test_chunked_gemm_equals_one_gemm(k):
    """The contraction cut into K_CHUNK-long GEMMs (the DCT above
    K_SPLIT_ABOVE) is the same product: within 1e-12 of the one GEMM in
    float64 for a whole and a partial last chunk; in float32 the DCT of
    the cut contraction stays within 1e-6 of the coefficients' peak."""
    rng = np.random.default_rng(k)
    x = torch.from_numpy(rng.standard_normal((3, 2, k)))
    w = torch.from_numpy(rng.standard_normal((k, 40)))
    got = tdct.matmul_rows_chunked(x, w, tdct.K_CHUNK)
    want = tdct.matmul_rows(x, w)
    assert got.shape == want.shape == (3, 2, 40)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-12 * float(want.abs().max()))
    fwd, _ = tdct.device_matrices(k, CPU)
    x32 = x.to(torch.float32)
    ref = tdct.dct2(x)
    got32 = tdct.matmul_rows_chunked(x32, fwd, tdct.K_CHUNK).to(torch.float64)
    assert float((got32 - ref).abs().max()) <= 1e-6 * float(ref.abs().max())


# ----------------------------------------------------------------------
# batch_encode / batch_decode
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def audio():
    return make_audio(0.5, 44100, 2)


@pytest.mark.parametrize("little", [False, True])
@pytest.mark.parametrize("bits", DEPTHS)
def test_profile4_stream_equals_jax(audio, bits, little):
    """Byte for byte at every depth and byte order, a tail frame included;
    decodes to the JAX decode exactly."""
    want = jpipeline.batch_encode(audio, 4, 44100, bits, 1000, little_endian=little)
    got = ft.batch_encode(audio, 4, 44100, bits, 1000, little_endian=little, device=CPU)
    assert got == want
    out, sr = ft.batch_decode(got, device=CPU)
    jout, _ = jpipeline.batch_decode(want)
    assert sr == 44100
    np.testing.assert_array_equal(out, jout)


@pytest.mark.parametrize("little", [False, True])
@pytest.mark.parametrize("bits", DEPTHS)
def test_profile0_float64_stream_equals_jax(audio, bits, little):
    """Byte for byte at 12-32 bits; at 48 bits under 1% of the bytes
    differ (measured: 208 of 106,368); at 64 bits the decoded PCM agrees
    within 1e-12; every stream decodes within 1e-12 of the JAX decode."""
    want = jpipeline.batch_encode(audio, 0, 44100, bits, 1024, little_endian=little,
                                  compute_dtype="float64")
    got = ft.batch_encode(audio, 0, 44100, bits, 1024, little_endian=little,
                          compute_dtype="float64", device=CPU)
    assert len(got) == len(want) and bdis(got) == bdis(want)
    if bits <= 32:
        assert got == want
    elif bits == 48:
        assert sum(a != b for a, b in zip(got, want)) < 0.01 * len(want)
    jout, _ = jpipeline.batch_decode(want, compute_dtype="float64")
    for stream in (got, want):
        out, _ = ft.batch_decode(stream, compute_dtype="float64", device=CPU)
        np.testing.assert_allclose(out, jout, rtol=0, atol=1e-12)
    if bits >= 48:
        assert snr_db(audio, jout) > (195 if bits == 48 else 250)


@pytest.mark.parametrize("bits,i24", [(16, False), (24, False), (24, True), (32, False)])
def test_profile0_float32_fast_path_snr(audio, bits, i24):
    """The fused device path (DCT GEMM + trunc_pack, trunc_unpack + IDCT
    GEMM): the port's stream decoded by both packages and the JAX stream
    decoded by the port, each SNR within 0.1 dB of the JAX package's own.
    At 32 bits the container keeps the whole f32, so the SNR measures the
    transforms' own float32 rounding, where the port's GEMMs (MKL on the
    CPU) measured 3.0 dB above XLA's: there the bound is one-sided, at
    most 0.1 dB below."""
    kw = dict(compute_dtype="float32")
    jstream = jpipeline.batch_encode(audio, 0, 44100, bits, 2048, i24_upload=i24, **kw)
    jout, _ = jpipeline.batch_decode(jstream, i24_transfer=i24, **kw)
    snr_jax = snr_db(audio, jout)
    stream = ft.batch_encode(audio, 0, 44100, bits, 2048, i24_upload=i24, device=CPU, **kw)
    assert bdis(stream) == bdis(jstream) and len(stream) == len(jstream)
    outs = [ft.batch_decode(stream, i24_transfer=i24, device=CPU, **kw)[0],
            jpipeline.batch_decode(stream, i24_transfer=i24, **kw)[0],
            ft.batch_decode(jstream, i24_transfer=i24, device=CPU, **kw)[0]]
    for out in outs:
        assert out.shape == audio.shape
        assert snr_db(audio, out) >= snr_jax - 0.1
        assert bits == 32 or snr_db(audio, out) <= snr_jax + 0.1
    # one stream, two packages' IDCT GEMMs: a few float32 ulps (and one
    # int24 step of the i24 transfer)
    np.testing.assert_allclose(outs[2], jout, rtol=0,
                               atol=F32_ATOL + (2.0 ** -23 if i24 else 0.0))
    assert snr_jax > {16: 50, 24: 90, 32: 120}[bits]


@pytest.mark.parametrize("case", ["p0_f32_16", "p0_f64_16", "p4_16", "p0_f32_overflow_48"])
def test_escalation_depths_equal_jax(case):
    """Frames whose values leave the container float escalate to the same
    depth indexes as in the JAX package: 16 -> 24 bits for content beyond
    65504 (float32 fast path falling back, float64, profile 4), and 32 ->
    48 bits through a float32 overflow to inf, which redoes the batch at
    float64."""
    rng = np.random.default_rng(4)
    pcm = rng.standard_normal((6 * 512, 2)) * 0.3
    if case == "p0_f32_overflow_48":
        pcm[512:1024] *= 1e42
        profile, bits, dt = 0, 32, "float32"
    else:
        pcm[1024:1536] *= 1e8
        profile, bits = (4, 16) if case == "p4_16" else (0, 16)
        dt = "float64" if case == "p0_f64_16" else "float32"
    want = jpipeline.batch_encode(pcm, profile, 44100, bits, 512, compute_dtype=dt)
    got = ft.batch_encode(pcm, profile, 44100, bits, 512, compute_dtype=dt, device=CPU)
    assert bdis(got) == bdis(want) and len(set(bdis(got))) == 2
    if dt == "float64" or case == "p0_f32_overflow_48":
        out, _ = ft.batch_decode(got, compute_dtype="float64", device=CPU)
        jout, _ = jpipeline.batch_decode(want, compute_dtype="float64")
        np.testing.assert_allclose(out, jout, rtol=1e-9, atol=1e-9)
    if profile == 0 and dt == "float64":
        # the per-frame encoder escalates the same way
        for i in range(6):
            frame = pcm[i * 512:(i + 1) * 512]
            assert (tprofile0.analogue(frame, bits, 44100, False, CPU)[1]
                    == jprofile0.analogue(frame, bits, 44100, False)[1])


# ----------------------------------------------------------------------
# Streaming engines under float64
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def raw():
    pcm = make_audio(0.12, 44100, 2)
    return np.clip(np.rint(pcm * 32768.0), -32768, 32767).astype("<i2").tobytes()


def _engine_pair(mod, profile, bits, little=False, ecc=None):
    kw = dict(device=CPU) if mod is ft else {}
    e = mod.Encoder(profile, 44100, 2, bits, 512, "s16le", **kw)
    e.set_little_endian(little)
    if ecc is not None:
        e.set_ecc(*ecc)
    return e


def _encode(enc, raw: bytes, push: int) -> bytes:
    return b"".join(enc.process(raw[i:i + push]).buf
                    for i in range(0, len(raw), push)) + enc.flush().buf


def _decode(dec, stream: bytes, push: int = 4096) -> np.ndarray:
    parts = [dec.process(stream[i:i + push]).pcm for i in range(0, len(stream), push)]
    parts.append(dec.flush().pcm)
    parts = [p for p in parts if p.size]
    return np.concatenate(parts) if parts else np.empty((0, 0))


def _dec(mod, **kw):
    return mod.Decoder(device=CPU, **kw) if mod is ft else mod.Decoder(**kw)


@pytest.mark.parametrize("push", [1, 4096, 32768])
@pytest.mark.parametrize("profile,bits", [(0, 16), (0, 32), (4, 24), (4, 64)])
def test_engines_equal_jax_under_float64(f64, raw, profile, bits, push):
    """Encoder bytes equal the JAX Encoder's at every push size (per-frame
    and micro-batched paths alike); the Decoder, micro-batched and exact,
    agrees with the JAX Decoder within 1e-12 (profile 4 exactly)."""
    want = _encode(_engine_pair(jf, profile, bits), raw, push)
    got = _encode(_engine_pair(ft, profile, bits), raw, push)
    assert got == want
    for exact in (False, True):
        jout = _decode(_dec(jf, exact=exact), want, max(push, 64))
        out = _decode(_dec(ft, exact=exact), want, max(push, 64))
        if profile == 4:
            np.testing.assert_array_equal(out, jout)
        else:
            assert_f64_close(out, jout)


@pytest.mark.parametrize("push", [4096, 32768])
def test_engine_ecc_ratio_bytes_and_little_endian_equal_jax(f64, raw, push):
    """ECC armor at (96, 24), little-endian, and a lossless header that
    carries ratio bytes with ECC off (the per-frame path keeps them)."""
    for ecc in ((True, (96, 24)), (False, (48, 12))):
        want = _encode(_engine_pair(jf, 0, 24, True, ecc), raw, push)
        got = _encode(_engine_pair(ft, 0, 24, True, ecc), raw, push)
        assert got == want
        headers, payloads, _ = tpipeline._parse_frames(got)
        assert {(h.ecc, h.ecc_dsize, h.ecc_codesize) for h in headers} == {
            (ecc[0], *ecc[1])}
        for fix in (False, True):
            assert_f64_close(_decode(_dec(ft, fix_error=fix), got),
                             _decode(_dec(jf, fix_error=fix), want))


def test_engine_state_round_trip_profile0(f64, raw):
    """A profile 0 Encoder suspended mid-stream resumes in a new one (or
    from the JAX engine's state) with the same bytes."""
    ref = _encode(_engine_pair(ft, 0, 24), raw, 4096)
    enc = _engine_pair(ft, 0, 24)
    head = enc.process(raw[:5000]).buf
    for state in (enc.state_dict(), None):
        if state is None:
            jenc = _engine_pair(jf, 0, 24)
            head = jenc.process(raw[:5000]).buf
            state = jenc.state_dict()
        enc2 = _engine_pair(ft, 1, 16)
        enc2.load_state_dict(state)
        assert head + _encode(enc2, raw[5000:], 4096) == ref


# ----------------------------------------------------------------------
# Reserved profiles, repair, the stale overlap ratio
# ----------------------------------------------------------------------
def _set_profile(stream: bytes, profile: int) -> bytes:
    """Rewrite the profile bits of every lossless header."""
    out = bytearray(stream)
    headers, payloads, _ = tpipeline._parse_frames(stream)
    pos = 0
    for h, p in zip(headers, payloads):
        at = stream.index(FRM_SIGN, pos)
        out[at + 8] = (out[at + 8] & 0x1F) | (profile << 5)
        pos = at + h.header_bytes + (len(p) if p is not None else 0)
    return bytes(out)


@pytest.mark.parametrize("how", ["batch_decode", "Decoder", "exact"])
def test_reserved_profile_decodes_as_profile0(f64, audio, how):
    p0 = jpipeline.batch_encode(audio[:5000], 0, 44100, 24, 1024)
    reserved = _set_profile(p0, 5)
    assert {h.profile for h in tpipeline._parse_frames(reserved)[0]} == {5}
    want = _decode(_dec(jf, exact=how == "exact"), reserved)
    if how == "batch_decode":
        got, sr = ft.batch_decode(reserved, device=CPU)
        assert sr == 44100
        jb, _ = jpipeline.batch_decode(reserved)
        assert_f64_close(got, jb)
    else:
        got = _decode(_dec(ft, exact=how == "exact"), reserved)
    assert_f64_close(got, want)
    assert_f64_close(got, jpipeline.batch_decode(p0)[0])


@pytest.mark.parametrize("host", ["native", "numpy"])
def test_repair_of_damaged_profile0_stream_equals_jax(monkeypatch, audio, host):
    """batch_repair and the Repairer of a damaged armored profile 0 stream
    give the JAX package's bytes and the clean armored stream."""
    if host == "numpy":
        monkeypatch.setenv("FRAD_TORCH_NO_NATIVE", "1")
    from frad_python_tpu_torch.utils.damage import damage_stream

    armored = jpipeline.batch_encode(audio, 0, 44100, 24, 1024, enable_ecc=True,
                                     compute_dtype="float64")
    damaged = damage_stream(armored)
    assert damaged != armored
    got = ft.batch_repair(damaged, (96, 24))
    assert got == jpipeline.batch_repair(damaged, (96, 24)) == armored
    rep = ft.Repairer((96, 24))
    assert b"".join(rep.process(damaged[i:i + 4096])
                    for i in range(0, len(damaged), 4096)) + rep.flush() == armored
    plain = jpipeline.batch_encode(audio, 4, 44100, 16, 1024)
    assert ft.batch_repair(plain, (48, 12)) == jpipeline.batch_repair(plain, (48, 12))


@pytest.mark.parametrize("how", ["batch_decode", "Decoder", "exact"])
def test_stale_overlap_ratio_does_not_cut_lossless_frames(f32, audio, how):
    """A lossless header carries no overlap byte, so after a Profile 1 run
    the parsed header keeps its overlap ratio of 16: a Profile 0 run at
    the same rate and channel count must still decode whole, as in the
    JAX package (within 2e-6: float32 IDCTs on both sides)."""
    p1 = jpipeline.batch_encode(audio[:9000], 1, 44100, 16, 2048, compute_dtype="float32")
    p0 = jpipeline.batch_encode(audio[9000:], 0, 44100, 16, 1024, compute_dtype="float32")
    stream = p1 + p0
    if how == "batch_decode":
        want, _ = jpipeline.batch_decode(stream, compute_dtype="float32")
        got, _ = ft.batch_decode(stream, device=CPU)
    else:
        want = _decode(_dec(jf, exact=how == "exact"), stream)
        got = _decode(_dec(ft, exact=how == "exact"), stream)
    assert got.shape == want.shape
    assert len(got) >= len(audio) - 2048 + 1024          # every lossless sample
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
    np.testing.assert_allclose(got[-(len(audio) - 9000):], audio[9000:], rtol=0, atol=1e-3)


# ----------------------------------------------------------------------
# Profile 1 above the matrix cap
# ----------------------------------------------------------------------
def test_profile1_at_16384_samples():
    """Profile 1 with 16384-sample frames runs the float32 FFT form: flips
    of at most 1 on at most 1e-3 of symbols against the JAX package's
    (f32 FFTs rounding differently), decoded SNR within 0.1 dB."""
    pcm = make_audio(2.0, 44100, 2)
    kw = dict(i16_upload=True)
    jstream = jpipeline.batch_encode(pcm, 1, 44100, 16, 16384, compute_dtype="float32", **kw)
    stream = ft.batch_encode(pcm, 1, 44100, 16, 16384, device=CPU, **kw)
    _, jp, _ = tpipeline._parse_frames(jstream)
    _, tp, _ = tpipeline._parse_frames(stream)
    assert [p is None for p in jp] == [p is None for p in tp]
    d = np.concatenate([tprofile1.unpack_streams(a)[0].astype(np.int64)
                        - tprofile1.unpack_streams(b)[0] for a, b in zip(tp, jp)
                        if a is not None])
    assert np.abs(d).max() <= 1 and np.count_nonzero(d) <= 1e-3 * d.size
    jout, _ = jpipeline.batch_decode(jstream, compute_dtype="float32", i16_transfer=True)
    for out in (ft.batch_decode(stream, i16_transfer=True, device=CPU)[0],
                ft.batch_decode(jstream, i16_transfer=True, device=CPU)[0]):
        assert out.shape == jout.shape
        assert abs(snr_db(pcm, out) - snr_db(pcm, jout)) <= 0.1


# ----------------------------------------------------------------------
# Corrupt lossless payloads
# ----------------------------------------------------------------------
def _corrupt(stream: bytes, kind: str, rng) -> bytes:
    """Every second payload flipped, replaced by garbage or zeros, or cut
    (one byte, to half, to nothing) with the header's length rewritten."""
    headers, payloads, _ = tpipeline._parse_frames(stream)
    out, pos = [], 0
    for i, (h, p) in enumerate(zip(headers, payloads)):
        at = stream.index(FRM_SIGN, pos)
        hdr = bytearray(stream[at: at + h.header_bytes])
        pos = at + h.header_bytes + len(p)
        if i % 2:
            if kind == "flip":
                b = bytearray(p)
                for off in rng.integers(0, len(p), max(len(p) // 50, 1)):
                    b[int(off)] ^= int(rng.integers(1, 256))
                p = bytes(b)
            elif kind == "garbage":
                p = rng.integers(0, 256, len(p), dtype=np.uint8).tobytes()
            elif kind == "zero":
                p = bytes(len(p))
            else:
                p = p[: {"cut1": len(p) - 1, "half": len(p) // 2, "empty": 0}[kind]]
                hdr[4:8] = len(p).to_bytes(4, "big")
        out.append(bytes(hdr) + p)
    return b"".join(out)


@pytest.mark.parametrize("host", ["native", "numpy"])
@pytest.mark.parametrize("profile", [0, 4])
def test_corrupt_lossless_payloads_decode_as_jax(f64, monkeypatch, profile, host):
    """Flipped, garbage, zeroed and cut payloads, armored or not, repaired
    or not: the port raises nothing and decodes as the JAX Decoder does
    (micro-batched and exact), and batch_decode as the JAX batch_decode
    where that does not raise, else as the JAX Decoder (within 1e-12 of
    the peak; profile 4 exactly)."""
    if host == "numpy":
        monkeypatch.setenv("FRAD_TORCH_NO_NATIVE", "1")
    rng = np.random.default_rng(11 + profile)
    pcm = make_audio(0.1, 44100, 2)

    def same(got, want):
        if profile == 4:
            np.testing.assert_array_equal(got, want)
        else:
            assert_f64_close(got, want)

    for ecc, bits in ((False, 16), (True, 24), (False, 32)):
        clean = jpipeline.batch_encode(pcm, profile, 44100, bits, 512, enable_ecc=ecc)
        for kind in ("flip", "garbage", "zero", "cut1", "half", "empty"):
            bad = _corrupt(clean, kind, rng)
            for fix in ((False, True) if ecc else (False,)):
                for exact in (False, True):
                    want = _decode(_dec(jf, fix_error=fix, exact=exact), bad, 2048)
                    got = _decode(_dec(ft, fix_error=fix, exact=exact), bad, 2048)
                    same(got, want)
                try:
                    want, _ = jpipeline.batch_decode(bad, fix_error=fix)
                except ValueError:
                    want = _decode(_dec(jf, fix_error=fix), bad, len(bad))
                got, _ = ft.batch_decode(bad, fix_error=fix, device=CPU)
                same(got, want)


# ----------------------------------------------------------------------
# chip_smoke.py's floors
# ----------------------------------------------------------------------
def test_chip_smoke_lossless_snr_floor():
    """The p0_stereo_44k1 floor is the JAX package's float32 SNR on the
    smoke run's 30 s content minus 0.1 dB, and its i24 transfer variant
    clears it too."""
    pcm = make_audio(chip_smoke.SECONDS, chip_smoke.SRATE, chip_smoke.CHANNELS)
    kw = dict(compute_dtype="float32")
    snrs = []
    for i24 in (False, True):
        stream = jpipeline.batch_encode(pcm, 0, chip_smoke.SRATE, chip_smoke.P0_BITS,
                                        chip_smoke.FSIZE, i24_upload=i24, **kw)
        out, _ = jpipeline.batch_decode(stream, i24_transfer=i24, **kw)
        snrs.append(snr_db(pcm, out))
    assert abs((snrs[0] - 0.1) - chip_smoke.P0_SNR_FLOOR_DB) < 1e-3
    assert snrs[1] - 0.1 >= chip_smoke.P0_SNR_FLOOR_DB - 1e-3


def test_chip_smoke_profile1_16384_snr_floor():
    """The floor of Profile 1 at 16384-sample frames is the JAX package's
    float32 SNR on the 30 s content minus 0.1 dB (the masking model holds
    far less at this frame size: 2.44 dB here against 17.22 at 2048)."""
    pcm = make_audio(chip_smoke.SECONDS, chip_smoke.SRATE, chip_smoke.CHANNELS)
    stream = jpipeline.batch_encode(pcm, 1, chip_smoke.SRATE, chip_smoke.BITS,
                                    chip_smoke.P1_LONG_FSIZE, compute_dtype="float32",
                                    i16_upload=True)
    out, _ = jpipeline.batch_decode(stream, compute_dtype="float32", i16_transfer=True)
    assert abs((snr_db(pcm, out) - 0.1) - chip_smoke.P1_LONG_SNR_FLOOR_DB) < 1e-3


def test_chip_smoke_profile1_8192_snr_floor():
    """The floor of Profile 1 at 8192-sample frames (the DCT GEMM cut
    along K in the port) is the JAX package's float32 SNR on the 30 s
    content minus 0.1 dB; the port's CPU run clears it."""
    pcm = make_audio(chip_smoke.SECONDS, chip_smoke.SRATE, chip_smoke.CHANNELS)
    args = (1, chip_smoke.SRATE, chip_smoke.BITS, chip_smoke.P1_MID_FSIZE)
    stream = jpipeline.batch_encode(pcm, *args, compute_dtype="float32", i16_upload=True)
    out, _ = jpipeline.batch_decode(stream, compute_dtype="float32", i16_transfer=True)
    assert abs((snr_db(pcm, out) - 0.1) - chip_smoke.P1_MID_SNR_FLOOR_DB) < 1e-3
    got, _ = ft.batch_decode(ft.batch_encode(pcm, *args, i16_upload=True, device=CPU),
                             i16_transfer=True, device=CPU)
    assert snr_db(pcm, got) >= chip_smoke.P1_MID_SNR_FLOOR_DB


def test_chip_smoke_hires_snr_floor():
    """The hires_96k_8ch floor is the JAX package's float32 SNR over the
    first HIRES_FLOOR_FRAMES frames of the smoke run's content minus 0.1
    dB. Profile 0 codes each frame on its own, so those frames alone give
    the SNR the smoke run measures over the same samples of its 10 s
    track; the port's CPU run clears the floor."""
    h = chip_smoke.HIRES
    hi = make_audio(h["seconds"], h["srate"], h["channels"])
    hi = hi[: chip_smoke.HIRES_FLOOR_FRAMES * h["fsize"]]
    args = (0, h["srate"], h["bits"], h["fsize"])
    stream = jpipeline.batch_encode(hi, *args, compute_dtype="float32")
    out, _ = jpipeline.batch_decode(stream, compute_dtype="float32")
    assert abs((snr_db(hi, out) - 0.1) - chip_smoke.HIRES_SNR_FLOOR_DB) < 1e-3
    got, _ = ft.batch_decode(ft.batch_encode(hi, *args, device=CPU), device=CPU)
    assert snr_db(hi, got) >= chip_smoke.HIRES_SNR_FLOOR_DB
