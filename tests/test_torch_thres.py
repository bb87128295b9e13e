"""The masking-threshold kernels' plain versions (`mask_thres`,
`thres_expand`) and their call sites against the JAX package, on the CPU
at small sizes. Inputs are made with numpy from a seed and go through
both.

Tolerances, each with its reason:

* thresholds `th`: 2e-6 relative at float32 (the band sums come from two
  GEMMs that add in their own order, then a 0.8 power), 1e-13 at float64.
* threshold symbols `thres_q` against `_p1_encode_jit`'s: a symbol is a
  rounding of a smooth function of `th`, so one may flip by 1 where it
  falls on a half; at most 1e-4 of them at float32 (reported in the
  failure), none at float64.
* `thres_expand`: the same operations one rounding each; XLA's power
  differs from torch's in the last ulps: 1e-6 relative at float32, 1e-14
  at float64.
* against the op sequence the port ran before the kernels: equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from frad_python_tpu.models import batch as jbatch
from frad_python_tpu.ops import psycho as jpsycho
from frad_python_tpu_torch import kernels
from frad_python_tpu_torch.kernels.mask_thres import E_HALF, thres_quant_plain
from frad_python_tpu_torch.models import batch as tbatch
from frad_python_tpu_torch.ops import psycho as tpsycho

DTYPES = ["float32", "float64"]
GEOMETRIES = [(512, 44100), (2048, 44100), (2048, 48000), (1024, 96000), (256, 8000)]


def t_(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def frames(dtype: str, b: int, n: int, ch: int = 2, seed: int = 0) -> np.ndarray:
    """[b, n, ch] PCM of chip_smoke's content with channel 1 louder, so
    thresholds fall on both sides of the clamp at 1."""
    pcm = chip_smoke.make_audio((b * n + 10) / 44100, 44100, ch)[: b * n]
    pcm = pcm * np.linspace(0.05, 1.0, ch) + \
        0.02 * np.random.default_rng(seed).standard_normal(pcm.shape)
    return pcm.reshape(b, n, ch).astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,srate", GEOMETRIES)
def test_mask_thres_plain_matches_jax(n, srate, dtype):
    rng = np.random.default_rng(n + srate)
    mags = np.abs(rng.standard_normal((6, n)) * np.exp(rng.standard_normal((6, 1)) * 3)
                  * 3000).astype(dtype)
    mags[5] = 0.0
    want = np.asarray(jpsycho.mask_thres_mos_jnp(jnp.asarray(mags), srate, 0.5))
    k = tpsycho.device_consts(n, srate, torch.device("cpu"), getattr(torch, dtype))
    sums = tpsycho.band_sums(t_(mags), k)
    th, tq = kernels.mask_thres(sums, k["inv_w"], k["aht"], k["nb"], 0.5, 2)
    assert th.shape == (6, 27) and th.dtype == sums.dtype and tq.shape == (3, 27, 2)
    assert tq.dtype == (torch.int64 if dtype == "float64" else torch.int32) and tq.is_contiguous()
    np.testing.assert_allclose(th.numpy(), want, rtol=2e-6 if dtype == "float32" else 1e-13,
                               atol=0)
    assert not th[:, k["nb"]:].any() and bool((th[5, :k["nb"]] > 0).all())   # floor, then zeros
    # the one function, and the op sequence the port ran before the kernel
    assert torch.equal(th, tpsycho.mask_thres_mos(t_(mags), srate, 0.5))
    assert torch.equal(tq, thres_quant_plain(th).reshape(3, 2, 27).transpose(1, 2))
    assert int(tq.max()) > 10 and int(tq.min()) == 0
    kernels.reset_launches()
    assert all(torch.equal(a, b) for a, b in zip(
        (th, tq), kernels.mask_thres_plain(sums, k["inv_w"], k["aht"], k["nb"], 0.5, 2)))
    assert kernels.mask_thres.launches == 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [512, 2048])
def test_threshold_symbols_match_the_jax_encode_core(n, dtype):
    x = frames(dtype, 6, n)
    factor = 2.0 ** 15
    for loss in (0.5, 1.8329800000000002):
        want_f, want_t = (np.asarray(a) for a in jbatch.p1_encode_core(x, 44100, loss, factor))
        got_f, got_t = (a.numpy() for a in tbatch.p1_encode_core(t_(x), 44100, loss, factor))
        assert got_t.shape == want_t.shape == (6, 27, 2) and got_t.dtype == want_t.dtype
        flips = got_t != want_t
        assert np.abs(got_t.astype(np.int64) - want_t).max() <= 1
        assert flips.mean() <= (1e-4 if dtype == "float32" else 0.0), \
            f"{int(flips.sum())} of {flips.size} threshold symbols flip"
        assert want_t.max() > 5 and (want_t == 0).any()
        assert (got_f != want_f).mean() <= (1e-4 if dtype == "float32" else 0.0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_thres_expand_plain_matches_jax(dtype):
    rng = np.random.default_rng(8)
    sym = np.rint(rng.laplace(0, 8, (5, 27, 2))).astype(dtype)
    sym[0, :4, 0] = (0, -0.0, 1, -1)
    want = np.asarray(jnp.power(jnp.asarray(E_HALF, dtype=dtype),
                                jpsycho.quant_jnp(jnp.swapaxes(jnp.asarray(sym), 1, 2))))
    got = kernels.thres_expand(t_(sym))
    assert got.shape == (5, 2, 27) and got.dtype == t_(sym).dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6 if dtype == "float32" else 1e-14,
                               atol=0)
    assert got[0, 0, 0] == 1.0 and got[0, 0, 1] == 1.0 and got[0, 0, 3] < 1.0 < got[0, 0, 2]
    e_half = torch.tensor(E_HALF, dtype=got.dtype)
    assert torch.equal(got, torch.pow(e_half, tpsycho.quant(t_(sym).transpose(1, 2))))
    kernels.reset_launches()
    assert torch.equal(kernels.thres_expand_plain(t_(sym)), got)
    assert torch.equal(kernels.thres_expand(t_(sym).transpose(0, 2).contiguous().transpose(0, 2)),
                       got)                                     # a strided input on the CPU
    assert kernels.thres_expand.launches == 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,srate", GEOMETRIES[:3])
def test_divisors_from_symbols_match_jax(n, srate, dtype):
    sym = np.rint(np.random.default_rng(n).laplace(0, 8, (3, 27, 2))).astype(dtype)
    want = np.asarray(jpsycho.mapping_from_opus_jnp(
        jnp.power(jnp.asarray(E_HALF, dtype=dtype),
                  jpsycho.quant_jnp(jnp.swapaxes(jnp.asarray(sym), 1, 2))), n, srate))
    got = tbatch._thres_expand(t_(sym), n, srate)
    assert got.shape == (3, 2, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6 if dtype == "float32" else 1e-13,
                               atol=0)


def test_chip_smoke_threshold_forms():
    """The card check's tables: thres_expand's forms follow the decoders'
    runs, and a small encode and decode on the CPU call both wrappers at
    forms of the tables' kind."""
    import frad_python_tpu_torch as ft

    assert ("float32", chip_smoke.OVERLAP_SHAPE[0]) in chip_smoke.THRES_EXPAND_FORMS
    assert ("float64", 114) in chip_smoke.THRES_EXPAND_FORMS
    assert ("float32", 2 * 688, chip_smoke.FSIZE) == chip_smoke.MASK_THRES_FORMS[0]
    pcm = chip_smoke.make_audio(0.3, 44100, 2)
    with chip_smoke.FormTally(only=("mask_thres", "thres_expand"), device_type="cpu") as tally:
        ft.batch_decode(ft.batch_encode(pcm, 1, 44100, 16, 2048, device="cpu"), device="cpu")
    nb = tpsycho.device_consts(2048, 44100, torch.device("cpu"))["nb"]
    assert set(tally.seen) == {("mask_thres", (12, nb), "float32", nb, 2),
                               ("mask_thres", (2, nb), "float32", nb, 2),
                               ("thres_expand", (6, 27, 2), "float32"),
                               ("thres_expand", (1, 27, 2), "float32")}   # the tail: a run
    assert set(tally.unchecked()) == set(tally.seen)           # nothing was held here
    assert tbatch.mask_thres is kernels.mask_thres
