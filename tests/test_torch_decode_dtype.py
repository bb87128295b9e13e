"""`batch_decode`'s compute dtype reaches the frames it hands to the
streaming `Decoder`, on the CPU, against the JAX package.

A stream whose overlap fragment is longer than the next run's emit window
(overlap ratio 2 or 3 with a shorter tail frame) makes `batch_decode` stream
its last frames through a `Decoder`. That `Decoder` must decode at the
`compute_dtype` the caller passed, as the batch runs do, and not at the
environment's (`FRAD_TORCH_COMPUTE_DTYPE`, float32 when unset). The JAX
package's `batch_decode` drops the dtype there; its default off the TPU
is float64 throughout, which is what the port is held to.

Tolerances: `batch_decode(compute_dtype=X)` equals the same call under
`FRAD_TORCH_COMPUTE_DTYPE=X` exactly (one code path, one dtype); at
float64 the decode is within 1e-9 of the JAX package's (the lossy float64
bound of the port).
"""

import numpy as np
import pytest
import torch

from frad_python_tpu.ops import policy as jpolicy
from frad_python_tpu.parallel import pipeline as jpipeline
import frad_python_tpu_torch as ft
from frad_python_tpu_torch import decoder as tdecoder

CPU = torch.device("cpu")
DTYPES = ["float32", "float64"]


def _sine(ratio_seed: int) -> np.ndarray:
    t = np.arange(12000) / 44100
    return (0.5 * np.sin(2 * np.pi * 440 * t)
            + 0.01 * np.random.default_rng(ratio_seed).standard_normal(len(t)))[:, None]


#: (profile, overlap ratio, frame size): the reproduction (Profile 1, ratio 2:
#: its 768-sample tail frames take a 512-sample fragment into a 384-sample
#: window), ratio 3, and a Profile 2 draw
STREAMS = {"p1_ratio2": (1, 2, 1024), "p1_ratio3": (1, 3, 1024), "p2_ratio2": (2, 2, 1024)}


@pytest.fixture(scope="module")
def streams() -> dict:
    return {name: jpipeline.batch_encode(_sine(ratio), profile, 44100, 16, fsize,
                                         overlap_ratio=ratio, compute_dtype="float64")
            for name, (profile, ratio, fsize) in STREAMS.items()}


@pytest.fixture
def decoders(monkeypatch):
    """The compute dtypes of the Decoders that batch_decode builds."""
    made = []
    init = tdecoder.Decoder.__init__

    def counted(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(self.compute_dtype)

    monkeypatch.setattr(tdecoder.Decoder, "__init__", counted)
    return made


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(STREAMS))
def test_batch_decode_dtype_reaches_the_streamed_frames(streams, decoders, monkeypatch, name,
                                                        dtype):
    monkeypatch.delenv("FRAD_TORCH_COMPUTE_DTYPE", raising=False)
    got, sr = ft.batch_decode(streams[name], compute_dtype=dtype, device=CPU)
    assert decoders == [dtype] and sr == 44100     # the stream reached the fallback
    monkeypatch.setenv("FRAD_TORCH_COMPUTE_DTYPE", dtype)
    want, _ = ft.batch_decode(streams[name], device=CPU)
    assert got.shape == want.shape and len(got) >= 12000 and np.array_equal(got, want)
    # the engine itself, given the dtype, against the engine under the variable
    dec = ft.Decoder(device=CPU, compute_dtype=dtype)
    monkeypatch.delenv("FRAD_TORCH_COMPUTE_DTYPE")
    given = np.concatenate([dec.process(streams[name]).pcm, dec.flush().pcm])
    monkeypatch.setenv("FRAD_TORCH_COMPUTE_DTYPE", dtype)
    env = ft.Decoder(device=CPU)
    np.testing.assert_array_equal(given, np.concatenate([env.process(streams[name]).pcm,
                                                         env.flush().pcm]))


@pytest.mark.parametrize("name", list(STREAMS))
def test_batch_decode_float64_matches_jax(streams, monkeypatch, name):
    monkeypatch.delenv("FRAD_TORCH_COMPUTE_DTYPE", raising=False)
    monkeypatch.delenv("FRAD_TPU_COMPUTE_DTYPE", raising=False)
    jpolicy.compute_dtype.cache_clear()
    try:
        assert jpolicy.compute_dtype() == "float64"
        want, _ = jpipeline.batch_decode(streams[name])
    finally:
        jpolicy.compute_dtype.cache_clear()
    got, _ = ft.batch_decode(streams[name], compute_dtype="float64", device=CPU)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    # the float32 decode of the same stream is another, coarser result
    got32, _ = ft.batch_decode(streams[name], compute_dtype="float32", device=CPU)
    assert np.abs(got32 - want).max() > 1e-9


def test_decoder_refuses_an_unknown_dtype():
    with pytest.raises(ValueError, match="compute_dtype"):
        ft.Decoder(device=CPU, compute_dtype="float16")
