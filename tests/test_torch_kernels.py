"""The CUDA kernels' plain PyTorch versions against the JAX package: the
product chains of the encode and decode cores and the Pallas kernels in
interpret mode. The CUDA kernels themselves run only on a GPU, where
chip_smoke.py holds each against its plain version for exact equality;
here the wrappers must take the plain path for CPU tensors and refuse
tensors on any device they cannot launch on."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frad_python_tpu.models import batch as jbatch
from frad_python_tpu.ops import psycho as jpsycho
from frad_python_tpu.research import pallas_kernels as pk
from frad_python_tpu_torch import kernels
from frad_python_tpu_torch.kernels import build
from frad_python_tpu_torch.kernels.overlap_add import crossfade_window
from frad_python_tpu_torch.models import batch as tbatch

CPU = torch.device("cpu")
FACTOR = 2.0 ** 15


def _quant_inputs(seed, shape=(64, 512)):
    rng = np.random.default_rng(seed)
    freqs = (rng.standard_normal(shape) * 1e-2).astype(np.float32)
    div = (np.exp(rng.standard_normal(shape) * 2.0) * 0.1).astype(np.float32)
    div[:, -40:] = 0.0
    div[::5, :7] = 0.0
    return freqs, div


@jax.jit
def _jax_quant_chain(freqs, div):
    # the encode core's epilogue (models/batch.py:_p1_encode_jit)
    div = jnp.where(div == 0.0, jnp.inf, div)
    masked = freqs / div
    return jnp.rint(jpsycho.quant_jnp(masked * jnp.float32(FACTOR))).astype(jnp.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_power_quant_plain_equals_jax_product_chain(seed):
    freqs, div = _quant_inputs(seed)
    want = np.asarray(_jax_quant_chain(jnp.asarray(freqs), jnp.asarray(div)))
    got = kernels.power_quant_plain(torch.from_numpy(freqs), torch.from_numpy(div), FACTOR)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.abs(want).max() > 1000 and (want == 0).any()


def test_power_quant_plain_vs_pallas_interpret():
    freqs, div = _quant_inputs(7, (96, 256))
    pallas = np.asarray(pk.power_quant(jnp.asarray(freqs), jnp.asarray(div), FACTOR))
    got = kernels.power_quant_plain(torch.from_numpy(freqs), torch.from_numpy(div),
                                    FACTOR).numpy()
    # the Pallas kernel uses the pow form |x|**0.75, within an ulp of the
    # sqrt form before rint: symbols may differ by 1 at rounding boundaries
    assert np.abs(got - pallas).max() <= 1
    assert (got != pallas).mean() < 1e-3


def test_power_quant_wrapper_takes_plain_path_on_cpu():
    freqs, div = _quant_inputs(3)
    kernels.reset_launches()
    f, d = torch.from_numpy(freqs), torch.from_numpy(div)
    assert torch.equal(kernels.power_quant(f, d, FACTOR), kernels.power_quant_plain(f, d, FACTOR))
    assert kernels.power_quant.launches == 0


def _frames(seed, b=9, n=256, c=2):
    return np.random.default_rng(seed).standard_normal((b, n, c)).astype(np.float32) * 0.4


def test_crossfade_window_matches_jax_within_ulps():
    for olap in (16, 128, 1024):
        wj = np.asarray(0.5 * (1.0 - jnp.cos(jnp.pi * jnp.arange(1, olap + 1, dtype=jnp.float32)
                                             / (olap + 1))))
        wt = crossfade_window(olap, CPU).numpy()
        assert wt.dtype == np.float32
        # float32 cos of XLA and of numpy may differ in the last ulp
        np.testing.assert_allclose(wt, wj, rtol=0, atol=2e-7)


@pytest.mark.parametrize("olap,cut", [(16, 240), (128, 128), (0, 256)])
def test_overlap_add_plain_matches_overlap_add_core(olap, cut):
    n = olap + cut
    frames = _frames(olap, n=n)
    want = np.asarray(jbatch.overlap_add_core(jnp.asarray(frames), olap, cut))
    pcm = torch.from_numpy(frames).transpose(1, 2).contiguous()     # [B, C, N]
    w = crossfade_window(olap, CPU)
    out, frag = kernels.overlap_add_plain(pcm, w, cut, False)
    assert out.shape == (frames.shape[0], cut, 2) and out.dtype == torch.float32
    # the window's last-ulp difference (see above) times |x| <= ~2
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(frag.numpy(), frames[-1, cut:cut + olap, :])
    # i16 emit: clamp(rint(x * 32768)); a sample may round one step the
    # other way where the f32 blends differ in the last ulp
    out16, _ = kernels.overlap_add_plain(pcm, w, cut, True)
    want16 = np.clip(np.rint(want.astype(np.float32) * np.float32(32768.0)), -32768, 32767)
    assert out16.dtype == torch.int16
    assert np.abs(out16.numpy().astype(np.int64) - want16.astype(np.int64)).max() <= 1
    assert kernels.overlap_add(pcm, w, cut, True)[0].equal(out16)
    assert tbatch.overlap_add_core(torch.from_numpy(frames), olap, cut).equal(out)


def test_overlap_add_plain_matches_crossfade_frames_interpret():
    olap, cut = 128, 384
    frames = _frames(5, b=6, n=olap + cut)
    w = crossfade_window(olap, CPU)
    heads = frames[1:, :olap, :].transpose(0, 2, 1).reshape(-1, olap)
    tails = frames[:-1, cut:cut + olap, :].transpose(0, 2, 1).reshape(-1, olap)
    want = np.asarray(pk.crossfade_frames(jnp.asarray(heads), jnp.asarray(tails),
                                          jnp.asarray(w.numpy())))
    out, _ = kernels.overlap_add_plain(torch.from_numpy(frames).transpose(1, 2).contiguous(),
                                       w, cut, False)
    got = out[1:, :olap, :].numpy().transpose(0, 2, 1).reshape(-1, olap)
    # same window, same products and sum: only XLA's possible FMA
    # contraction can move the last ulp
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-7)
    np.testing.assert_array_equal(out[0].numpy(), frames[0, :cut, :])


def test_wrappers_refuse_devices_they_cannot_launch_on():
    meta = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError):
        kernels.power_quant(meta, meta, FACTOR)
    with pytest.raises(ValueError):
        kernels.overlap_add(torch.empty((2, 2, 8), device="meta"),
                            torch.empty(2, device="meta"), 6, True)
    with pytest.raises(ValueError):
        kernels.power_quant(meta, None, FACTOR)
    with pytest.raises(ValueError):
        kernels.tns_iir(meta, torch.empty((4, 13), device="meta"))
    with pytest.raises(ValueError):
        kernels.tns_levinson(torch.empty((4, 13), device="meta"))
    with pytest.raises(ValueError):
        kernels.egr_pack(torch.empty((4, 8), dtype=torch.int32, device="meta"), 16)
    with pytest.raises(ValueError):
        kernels.dequant(torch.empty((2, 8, 2), device="meta"), None, FACTOR)
    assert all(k.launches == 0 for k in kernels.KERNELS)


def test_build_needs_nvcc(monkeypatch, tmp_path):
    path = build.library_path()
    assert path.parent.parent == build.BUILD_DIR and path.name == build.LIB_NAME
    assert {p.name for p in build.sources()} == {"power_quant.cu", "overlap_add.cu",
                                                 "trunc_pack.cu", "trunc_unpack.cu",
                                                 "tns_iir.cu", "tns_levinson.cu",
                                                 "egr_pack.cu", "dequant.cu"}
    assert set(build.SIGNATURES) == {"frad_power_quant", "frad_overlap_add",
                                     "frad_trunc_pack", "frad_trunc_unpack",
                                     "frad_tns_iir", "frad_tns_levinson",
                                     "frad_egr_pack", "frad_dequant"}
    assert len(kernels.KERNELS) == len(build.SIGNATURES)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc()
