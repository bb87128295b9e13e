"""The int24 transfer forms in the port against the JAX package, on the CPU
with the kernels' plain versions: `i24_pack` / `i24_unpack` (kernels/
i24_pack.py, kernels/i24_unpack.py; the CUDA kernels run only on a GPU,
where chip_smoke.py holds each against its plain version bit for bit), the
names `ops/bitpack.py` keeps for them, and Profile 0's batch calls with
`i24_upload` / `i24_transfer`. Inputs are made with numpy from a seed and
go through both packages.

Tolerances: the word forms are integer and exactly rounded float32
arithmetic, so they are compared exactly, edge values included (NaN, +-Inf,
+-1.0, values past +-1, ties of the rounding). Streams of the int24 upload
are equal byte for byte where the DCT GEMMs of the two packages round
alike; decoded PCM is held to a few float32 ulps of the IDCT sum plus one
int24 step (2^-23).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import frad_python_tpu_torch as ft
from frad_python_tpu.ops import bitpack as jbitpack
from frad_python_tpu.parallel import pipeline as jpipeline
from frad_python_tpu_torch import kernels
from frad_python_tpu_torch.models import batch as tbatch
from frad_python_tpu_torch.ops import bitpack as tbitpack

CPU = torch.device("cpu")
STEP = 2.0 ** -23
#: values whose handling the plain version's docstring spells out
EDGES = [np.nan, np.inf, -np.inf, 1.0, -1.0, 1.5, -1.5, 0.99999994, -0.99999994, 0.0, -0.0,
         0.5 * STEP, 1.5 * STEP, 2.5 * STEP, -0.5 * STEP, -1.5 * STEP, 1.0 - STEP, 3e38, -3e38]


def pcm_frames(shape, seed, edges=True) -> np.ndarray:
    x = (np.random.default_rng(seed).standard_normal(shape) * 0.4).astype(np.float32)
    if edges:
        x.reshape(-1)[: len(EDGES)] = EDGES
    return x


@pytest.mark.parametrize("shape", [(3, 64, 2), (1, 510, 2), (2, 25, 8), (5, 4, 1)])
def test_i24_pack_plain_equals_jax(shape):
    x = pcm_frames(shape, sum(shape))
    want = np.asarray(jbitpack.pcm_to_i24_words(jnp.asarray(x)))
    got = kernels.i24_pack_plain(torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == (shape[0], shape[1] * shape[2] * 3 // 4)
    assert got.numpy().tobytes() == want.tobytes()
    # the edge values, by the docstring: NaN -> 0, clamps, ties to even
    tri = np.frombuffer(got.numpy().tobytes(), np.uint8).reshape(-1, 3)[: len(EDGES)]
    val = tri[:, 0].astype(np.int64) | (tri[:, 1].astype(np.int64) << 8) \
        | (tri[:, 2].astype(np.int64) << 16)
    val = (val ^ 0x800000) - 0x800000
    top, low = (1 << 23) - 1, -(1 << 23)
    assert val.tolist() == [0, top, low, top, low, top, low, top, low, 0, 0,
                            0, 2, 2, 0, -2, top, top, low]
    # the wrapper takes the plain path on the CPU, and so do bitpack's names
    kernels.reset_launches()
    assert torch.equal(kernels.i24_pack(torch.from_numpy(x)), got)
    assert torch.equal(tbitpack.pcm_to_i24_words(torch.from_numpy(x)), got)
    # a transposed view (the decoder hands over the IDCT's [B, C, N] output so)
    view = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1))).transpose(1, 2)
    assert not view.is_contiguous() or shape[2] == 1
    assert torch.equal(kernels.i24_pack(view), got)
    assert kernels.i24_pack.launches == 0


@pytest.mark.parametrize("shape", [(3, 96), (1, 3), (4, 3060)])
def test_i24_unpack_plain_equals_jax(shape):
    rng = np.random.default_rng(shape[1])
    words = rng.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64).astype(np.int32)
    edge = np.array([-(1 << 23), (1 << 23) - 1, -1, 0]).astype("<i4").view(np.uint8)
    words[0, :3] = np.ascontiguousarray(edge.reshape(4, 4)[:, :3]).reshape(-1).view(np.int32)
    want = np.asarray(jbitpack.i24_words_to_pcm_device(jnp.asarray(words.view(np.uint32))))
    got = kernels.i24_unpack_plain(torch.from_numpy(words))
    assert got.dtype == torch.float32 and got.shape == (shape[0], shape[1] * 4 // 3)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    # -2^23, 2^23 - 1, -1 and 0 at the start of row 0
    assert got[0, :4].tolist() == [-1.0, 1.0 - STEP, -STEP, 0.0]
    kernels.reset_launches()
    assert torch.equal(kernels.i24_unpack(torch.from_numpy(words)), got)
    assert torch.equal(tbitpack.i24_words_to_pcm_device(torch.from_numpy(words)), got)
    assert kernels.i24_unpack.launches == 0
    # the host inverse gives the same values in float64
    np.testing.assert_array_equal(tbitpack.i24_words_to_pcm(words), got.numpy().astype(np.float64))


@pytest.mark.parametrize("seed", [0, 1])
def test_i24_round_trip(seed):
    x = pcm_frames((4, 128, 2), seed, edges=False)
    words = kernels.i24_pack(torch.from_numpy(x))
    back = kernels.i24_unpack(words).reshape(4, 128, 2).numpy()
    # one rounding to the int24 grid, then exact
    clipped = np.clip(x, -1.0, 1.0 - STEP)
    assert np.abs(back - clipped).max() <= 0.5 * STEP
    again = kernels.i24_pack(torch.from_numpy(back))
    assert torch.equal(again, words)
    # the host's words of the same samples are the device's
    host = tbitpack.pcm_to_i24_words_host(back.astype(np.float64)).reshape(4, -1)
    np.testing.assert_array_equal(host.view(np.int32), words.numpy())


def test_chip_smoke_i24_forms_cover_the_run():
    """The forms at which chip_smoke.py's p0_stereo_44k1 i24 run calls the
    two wrappers (warm-up included) are those of its I24_SHAPES table, and
    its edge inputs hold the values the plain version's docstring names."""
    import chip_smoke

    pcm = chip_smoke.make_audio(chip_smoke.SECONDS, chip_smoke.SRATE, chip_smoke.CHANNELS)
    args = (0, chip_smoke.SRATE, chip_smoke.P0_BITS, chip_smoke.FSIZE)
    warm = pcm[: 4 * chip_smoke.FSIZE + len(pcm) % chip_smoke.FSIZE]
    tally = chip_smoke.FormTally(only=("i24_pack", "i24_unpack"), device_type="cpu")
    with tally:
        for x in (warm, pcm):
            ft.batch_decode(ft.batch_encode(x, *args, i24_upload=True, device=CPU),
                            i24_transfer=True, device=CPU)
    want = set()
    for b, n, ch in chip_smoke.I24_SHAPES:
        want |= {("i24_pack", (b, n, ch), "float32", False),
                 ("i24_unpack", (b, n * ch * 3 // 4), "int32")}
    assert set(tally.seen) == want
    assert tbatch.i24_pack is kernels.i24_pack and tbatch.i24_unpack is kernels.i24_unpack
    x = chip_smoke.i24_inputs((2, 64, 2), 1)
    assert x.shape == (2, 2, 64) and np.isnan(x[0, 0, 0]) and np.isinf(x[0, 0, 1:3]).all()
    got = kernels.i24_unpack(kernels.i24_pack(torch.from_numpy(x).transpose(1, 2)))
    assert got.reshape(2, 64, 2)[0, :5, 0].tolist() == [0.0, 1.0 - STEP, -1.0, 1.0 - STEP, -1.0]
    assert set(chip_smoke.STREAMING_SHAPES) == {k.__name__ for k in kernels.KERNELS}


def _frames(b=4, n=256, seed=3) -> np.ndarray:
    t = np.arange(b * n) / 44100.0
    rng = np.random.default_rng(seed)
    sig = 0.4 * np.sin(2 * np.pi * 440.0 * t)[:, None] * np.ones((1, 2))
    return (sig + 0.01 * rng.standard_normal((b * n, 2))).reshape(b, n, 2)


@pytest.mark.parametrize("bits,little", [(24, False), (24, True), (16, False)])
def test_p0_i24_cores_match_jax(bits, little):
    """`p0_encode_pack_core_i24` and `p0_unpack_decode_i24_core` against the
    JAX package's fused programs on the same int24 words."""
    from frad_python_tpu.models import batch as jbatch

    frames = _frames()
    b, n, ch = frames.shape
    words = tbitpack.pcm_to_i24_words_host(frames).reshape(b, -1)
    np.testing.assert_array_equal(words, jbitpack.pcm_to_i24_words_host(frames).reshape(b, -1))
    got_w, got_m = tbatch.p0_encode_pack_core_i24(torch.from_numpy(words.view(np.int32)),
                                                 bits, little, n, ch)
    want_w, want_m = jbatch.p0_encode_pack_core_i24(jnp.asarray(words), bits, little, n, ch)
    want_w, want_m = np.asarray(want_w), np.asarray(want_m)
    # the DCT GEMMs of the two packages may round a coefficient's last bit
    # apart, which moves a truncated payload value by one step at most
    np.testing.assert_allclose(got_m.numpy(), want_m, rtol=1e-6)
    same = (got_w.numpy().view(np.uint8).reshape(-1) == want_w.view(np.uint8).reshape(-1)).mean()
    assert same > 0.9
    got_p = tbatch.p0_unpack_decode_i24_core(torch.from_numpy(want_w.view(got_w.numpy().dtype).copy()),
                                             bits, little, n, ch)
    want_p = np.asarray(jbatch.p0_unpack_decode_i24_core(jnp.asarray(want_w), bits, little, n, ch))
    got_v = tbitpack.i24_words_to_pcm(got_p.numpy())
    want_v = jbitpack.i24_words_to_pcm(want_p.view(np.uint32))
    # a few float32 ulps of the IDCT sum (|pcm| < 2), then the int24 grid
    assert np.abs(got_v - want_v).max() <= 2e-6 + STEP
    assert np.abs(got_v.reshape(b, n, ch) - frames).max() < (2e-3 if bits == 16 else 2e-5)


@pytest.mark.parametrize("little", [False, True])
def test_batch_i24_upload_and_transfer_match_jax(little):
    """`batch_encode(i24_upload=True)` / `batch_decode(i24_transfer=True)` at
    a small size (five 256-sample frames and a 100-sample tail) against the
    JAX package."""
    pcm = _frames(b=5, n=256).reshape(-1, 2)
    pcm = np.concatenate([pcm, pcm[:100]])
    kw = dict(compute_dtype="float32", little_endian=little)
    jstream = jpipeline.batch_encode(pcm, 0, 44100, 24, 256, i24_upload=True, **kw)
    stream = ft.batch_encode(pcm, 0, 44100, 24, 256, i24_upload=True, device=CPU, **kw)
    assert len(stream) == len(jstream)
    jout, jsr = jpipeline.batch_decode(jstream, i24_transfer=True, compute_dtype="float32")
    outs = [ft.batch_decode(s, i24_transfer=True, compute_dtype="float32", device=CPU)
            for s in (stream, jstream)]
    for out, sr in outs:
        assert sr == jsr == 44100 and out.shape == pcm.shape == jout.shape
        assert np.abs(out - pcm).max() < 2e-5             # the 24-bit container's truncation
    # one stream through both decoders: a few float32 ulps of the IDCT sum
    # (|pcm| < 2), and one int24 step of the transfer
    np.testing.assert_allclose(outs[1][0], jout, rtol=0, atol=2e-6 + STEP)
    # without the transfer form the same stream decodes within half a step
    plain, _ = ft.batch_decode(stream, compute_dtype="float32", device=CPU)
    assert np.abs(plain - outs[0][0]).max() <= 0.5 * STEP + 1e-12
    # the upload's quantisation is all that separates the two encodes
    direct = ft.batch_encode(pcm, 0, 44100, 24, 256, device=CPU, **kw)
    d_out, _ = ft.batch_decode(direct, compute_dtype="float32", device=CPU)
    assert np.abs(d_out - outs[0][0]).max() < 2e-5
