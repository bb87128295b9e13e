"""The masking kernels' plain versions (`mask_thres`: spectra -> per-bin
divisor and threshold symbols; `thres_expand`: symbols -> per-bin
divisor) and their call sites against the JAX package, on the CPU at
small sizes. Inputs are made with numpy from a seed and go through both.

Tolerances, each with its reason:

* divisors: 2e-6 relative at float32 (the band sums add in the kernel's
  order where the JAX package runs a GEMM, then a 0.8 power; the
  interpolation is two products and a sum where it runs a GEMM), 1e-13 at
  float64.
* band sums against a float64 numpy sum: 1e-6 relative at float32 (a sum
  of at most a few hundred positive terms in float32).
* threshold and frequency symbols against `_p1_encode_jit`'s: a symbol is
  a rounding of a smooth function of the thresholds, so one may flip by 1
  where it falls on a half; at most 1e-4 of them at float32 (the rate is
  in the failure), none at float64.
* `thres_expand`'s thresholds: XLA's power differs from torch's in the
  last ulps: 1e-6 relative at float32, 1e-14 at float64.
* float64 batch streams: byte-equal to the JAX package's; decoded PCM
  within 2e-6 (float32) and 1e-9 (float64).
* the plain version against a scalar model of the order it states, and
  the kernel tables against a model of the kernels' arithmetic: equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from frad_python_tpu.models import batch as jbatch
from frad_python_tpu.ops import psycho as jpsycho
from frad_python_tpu.parallel import pipeline as jpipeline
import frad_python_tpu_torch as ft
from frad_python_tpu_torch import kernels
from frad_python_tpu_torch.kernels.mask_thres import (E_HALF, band_sums_plain,
                                                      interpolate_plain, thres_quant_plain)
from frad_python_tpu_torch.kernels.thres_expand import expand_plain
from frad_python_tpu_torch.models import batch as tbatch
from frad_python_tpu_torch.ops import psycho as tpsycho
from frad_python_tpu_torch.parallel import pipeline as tpipeline

CPU = torch.device("cpu")
DTYPES = ["float32", "float64"]
GEOMETRIES = [(512, 44100), (2048, 44100), (2048, 48000), (1024, 96000), (256, 8000)]
#: the divisor's geometries: every N the codec's lossy paths run (256 up to
#: the FFT form's 16384) against the sample rates of the edges' tables
DIV_NS = [256, 1024, 2048, 16384]
DIV_SRATES = [8000, 44100, 48000, 96000]
RTOL = {"float32": 2e-6, "float64": 1e-13}
FACTOR = 2.0 ** 15


def t_(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def frames(dtype: str, b: int, n: int, ch: int = 2, seed: int = 0) -> np.ndarray:
    """[b, n, ch] PCM of chip_smoke's content with channel 1 louder, so
    thresholds fall on both sides of the clamp at 1."""
    pcm = chip_smoke.make_audio((b * n + 10) / 44100, 44100, ch)[: b * n]
    pcm = pcm * np.linspace(0.05, 1.0, ch) + \
        0.02 * np.random.default_rng(seed).standard_normal(pcm.shape)
    return pcm.reshape(b, n, ch).astype(dtype)


def spectra(rows: int, n: int, dtype: str, seed: int, scale: float = 3000.0) -> np.ndarray:
    """Signed spectra over six decades with one silent row."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, n)) * np.exp(rng.standard_normal((rows, 1)) * 3) * scale
    x[-1] = 0.0
    return x.astype(dtype)


def jax_chain(x: np.ndarray, srate: int, loss: float, factor: float = 1.0):
    """The JAX package's encode chain on spectra x [R, N]: (thresholds,
    divisors, threshold symbols [R, 27])."""
    dt = x.dtype
    th = jpsycho.mask_thres_mos_jnp(jnp.abs(jnp.asarray(x)) * jnp.asarray(factor, dt), srate,
                                    jnp.asarray(loss, dt))
    div = jpsycho.mapping_from_opus_jnp(th, x.shape[1], srate)
    log_base = jnp.log(jnp.asarray(np.e / 2.0, dtype=dt))
    tq = jnp.rint(jpsycho.dequant_jnp(jnp.log(jnp.clip(th, min=1.0)) / log_base))
    return np.asarray(th), np.asarray(div), np.asarray(tq).astype(np.int64)


def plain_thresholds(x: torch.Tensor, srate: int, loss: float, factor: float = 1.0):
    k = tpsycho.device_consts(x.shape[1], srate, CPU, x.dtype)
    a = torch.abs(x) * factor
    return tpsycho.thres_from_sums(band_sums_plain(a * a, k), k["inv_w"], k["aht"],
                                   k["nb"], loss)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,srate", GEOMETRIES)
def test_mask_thres_plain_matches_jax(n, srate, dtype):
    x = spectra(6, n, dtype, n + srate)
    want_th, want_div, want_tq = jax_chain(x, srate, 0.5)
    div, tq = kernels.mask_thres(t_(x), 1.0, 0.5, srate, 2)
    assert div.shape == (6, n) and div.dtype == t_(x).dtype and tq.shape == (3, 27, 2)
    assert tq.dtype == (torch.int64 if dtype == "float64" else torch.int32) and tq.is_contiguous()
    np.testing.assert_allclose(div.numpy(), want_div, rtol=RTOL[dtype], atol=0)
    th = plain_thresholds(t_(x), srate, 0.5)
    np.testing.assert_allclose(th.numpy(), want_th, rtol=RTOL[dtype], atol=0)
    k = tpsycho.device_consts(n, srate, CPU, t_(x).dtype)
    assert not th[:, k["nb"]:].any() and bool((th[5, :k["nb"]] > 0).all())   # floor, then zeros
    flips = tq.transpose(1, 2).reshape(6, 27).numpy() != want_tq
    assert flips.mean() <= (1e-4 if dtype == "float32" else 0.0), \
        f"{int(flips.sum())} of {flips.size} threshold symbols flip"
    # the function is its stated steps
    assert torch.equal(tq, thres_quant_plain(th).reshape(3, 2, 27).transpose(1, 2))
    assert torch.equal(div, interpolate_plain(th, k))
    assert int(tq.max()) > 10 and int(tq.min()) == 0
    kernels.reset_launches()
    assert all(torch.equal(a, b) for a, b in zip(
        (div, tq), kernels.mask_thres_plain(t_(x), 1.0, 0.5, srate, 2)))
    assert kernels.mask_thres.launches == 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [512, 2048])
def test_threshold_symbols_match_the_jax_encode_core(n, dtype):
    x = frames(dtype, 6, n)
    for loss in (0.5, 1.8329800000000002):
        want_f, want_t = (np.asarray(a) for a in jbatch.p1_encode_core(x, 44100, loss, FACTOR))
        got_f, got_t = (a.numpy() for a in tbatch.p1_encode_core(t_(x), 44100, loss, FACTOR))
        assert got_t.shape == want_t.shape == (6, 27, 2) and got_t.dtype == want_t.dtype
        flips = got_t != want_t
        assert np.abs(got_t.astype(np.int64) - want_t).max() <= 1
        assert flips.mean() <= (1e-4 if dtype == "float32" else 0.0), \
            f"{int(flips.sum())} of {flips.size} threshold symbols flip"
        assert want_t.max() > 5 and (want_t == 0).any()
        assert (got_f != want_f).mean() <= (1e-4 if dtype == "float32" else 0.0), \
            f"{int((got_f != want_f).sum())} of {got_f.size} frequency symbols flip"


@pytest.mark.parametrize("dtype", DTYPES)
def test_thres_expand_plain_matches_jax(dtype):
    rng = np.random.default_rng(8)
    sym = np.rint(rng.laplace(0, 8, (5, 27, 2))).astype(dtype)
    sym[0, :4, 0] = (0, -0.0, 1, -1)
    e_half = jnp.asarray(E_HALF, dtype=dtype)
    th_want = jnp.power(e_half, jpsycho.quant_jnp(jnp.swapaxes(jnp.asarray(sym), 1, 2)))
    th = expand_plain(t_(sym))
    assert th.shape == (5, 2, 27) and th.dtype == t_(sym).dtype
    np.testing.assert_allclose(th.numpy(), np.asarray(th_want),
                               rtol=1e-6 if dtype == "float32" else 1e-14, atol=0)
    assert th[0, 0, 0] == 1.0 and th[0, 0, 1] == 1.0 and th[0, 0, 3] < 1.0 < th[0, 0, 2]
    got = kernels.thres_expand(t_(sym), 2048, 44100)
    want = np.asarray(jpsycho.mapping_from_opus_jnp(th_want, 2048, 44100))
    assert got.shape == (5, 2, 2048) and got.dtype == t_(sym).dtype and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL[dtype], atol=0)
    k = tpsycho.device_consts(2048, 44100, CPU, got.dtype)
    assert torch.equal(got, interpolate_plain(th, k))
    kernels.reset_launches()
    assert torch.equal(kernels.thres_expand_plain(t_(sym), 2048, 44100), got)
    assert torch.equal(kernels.thres_expand(t_(sym).transpose(0, 2).contiguous().transpose(0, 2),
                                            2048, 44100), got)      # a strided input on the CPU
    assert kernels.thres_expand.launches == 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,srate", GEOMETRIES[:3])
def test_divisors_from_symbols_match_jax(n, srate, dtype):
    """thres_expand's divisor against the JAX decode chain: the power of
    e/2 of the companded symbols, then the interpolation GEMM."""
    sym = np.rint(np.random.default_rng(n).laplace(0, 8, (3, 27, 2))).astype(dtype)
    want = np.asarray(jpsycho.mapping_from_opus_jnp(
        jnp.power(jnp.asarray(E_HALF, dtype=dtype),
                  jpsycho.quant_jnp(jnp.swapaxes(jnp.asarray(sym), 1, 2))), n, srate))
    got = kernels.thres_expand(t_(sym), n, srate)
    assert got.shape == (3, 2, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL[dtype], atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("srate", DIV_SRATES)
@pytest.mark.parametrize("n", DIV_NS)
def test_two_term_divisor_matches_the_jax_gemm(n, srate, dtype):
    """mask_thres's divisor against mapping_from_opus_jnp(mask_thres_mos_jnp
    (...)), on spectra at the codec's factor."""
    x = spectra(3, n, dtype, 7 * n + srate, 0.1)
    _, want, _ = jax_chain(x, srate, 0.5, FACTOR)
    div, _ = kernels.mask_thres(t_(x), FACTOR, 0.5, srate, 1)
    np.testing.assert_allclose(div.numpy(), want, rtol=RTOL[dtype], atol=0)
    valid = tpsycho.mapping_consts(n, srate)[2]
    assert not div[:, ~valid].any() and bool((div[:, valid] > 0).all())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,srate", GEOMETRIES + [(16384, 44100)])
def test_band_sums_in_the_stated_order(n, srate, dtype):
    """band_sums_plain is the order its docstring states (a scalar model
    of the 32 lanes and the shuffle tree, bit for bit), and within 1e-6
    relative of a float64 sum at float32."""
    rng = np.random.default_rng(n)
    sq = (rng.standard_normal((2, n)) * 30.0).astype(dtype) ** 2
    k = tpsycho.device_consts(n, srate, CPU, t_(sq).dtype)
    got = band_sums_plain(t_(sq), k).numpy()
    starts, nb, _ = tpsycho._mask_consts(n, srate)
    assert got.shape == (2, max(nb, 1))
    ft_ = np.dtype(dtype).type
    for r in range(2):
        for b in range(nb):
            lanes = [ft_(0.0)] * 32
            for t in range(starts[b], starts[b + 1]):
                lanes[(t - starts[b]) % 32] = ft_(lanes[(t - starts[b]) % 32] + sq[r, t])
            s = 16
            while s:
                lanes = [ft_(lanes[i] + lanes[i + s]) for i in range(s)]
                s //= 2
            assert got[r, b] == lanes[0]
            exact = sq[r, starts[b]:starts[b + 1]].astype(np.float64).sum()
            assert abs(float(got[r, b]) - exact) <= (1e-6 if dtype == "float32" else 1e-14) * exact


@pytest.mark.parametrize("n,srate", GEOMETRIES + [(16384, 96000), (8192, 44100), (6144, 44100),
                                                  (1792, 44100), (64, 44100), (16, 8000)])
def test_kernel_tables_and_interpolation_model(n, srate):
    """The kernels' band starts, and their arithmetic per bin (the band by a
    binary search over the starts, frac divided in float64, 1 - frac
    subtracted in float64, both rounded to the compute dtype), give the
    plain version's tables, which are the JAX interpolation matrix's
    entries; 1/width and the AHT floor the JAX package's."""
    starts, inv_w, aht, nb = tpsycho.kernel_tables(n, srate)
    ind, jinv_w, jaht, jnb, jb, jfrac, jvalid = jpsycho._mask_consts_jnp(n, srate)
    assert starts.dtype == np.int32 and starts.shape == (28,) and nb == jnb
    np.testing.assert_array_equal(inv_w[:len(jinv_w)], jinv_w)
    np.testing.assert_array_equal(aht[:ind.shape[1]], jaht[:ind.shape[1]])
    st = starts.astype(np.int64)
    t = np.arange(n)
    valid = t < st[26]
    b = np.zeros(n, dtype=np.int64)
    for step in (16, 8, 4, 2, 1):
        up = (b + step <= 26) & (st[np.minimum(b + step, 27)] <= t)
        b = np.where(up, b + step, b)
    bv, tv = b[valid], t[valid]
    frac = (tv - st[bv]).astype(np.float64) / (st[bv + 1] - st[bv]).astype(np.float64)
    assert np.array_equal(valid, jvalid) and np.array_equal(bv, jb[valid])
    w = jpsycho._interp_matrix(n, srate)
    for dtype in DTYPES:
        k = tpsycho.device_consts(n, srate, CPU, getattr(torch, dtype))
        assert np.array_equal(k["valid"].numpy(), valid)
        assert np.array_equal(k["lo"].numpy()[valid], bv)
        assert np.array_equal(k["hi"].numpy()[valid], bv + 1)
        for got, model, entries in ((k["w_hi"], frac, w[bv + 1, tv]),
                                    (k["w_lo"], 1.0 - frac, w[bv, tv])):
            got = got.numpy()
            assert not got[~valid].any()
            assert np.array_equal(got[valid], model.astype(dtype))
            assert np.array_equal(got[valid], entries.astype(dtype))


@pytest.mark.parametrize("profile", [1, 2])
def test_float64_batch_streams_equal_jax(profile):
    """The lossy batch calls at float64, 48 kHz mono at 1024 samples: the
    stream equals the JAX package's byte for byte, and both decodes agree
    within 1e-9."""
    t = np.arange(30000) / 48000
    pcm = (0.4 * np.sin(2 * np.pi * 330 * t) + 0.05 * np.random.default_rng(profile)
           .standard_normal(len(t)))[:, None]
    kw = dict(loss_level=0.5, overlap_ratio=16, compute_dtype="float64")
    s_jax = jpipeline.batch_encode(pcm, profile, 48000, 16, 1024, **kw)
    s_port = ft.batch_encode(pcm, profile, 48000, 16, 1024, device=CPU, **kw)
    assert s_port == s_jax and len(tpipeline._parse_frames(s_port)[0]) > 20
    want, _ = jpipeline.batch_decode(s_jax, compute_dtype="float64")
    got, _ = ft.batch_decode(s_port, compute_dtype="float64", device=CPU)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def test_chip_smoke_threshold_forms():
    """The card check's tables: thres_expand's forms follow the Profile 2
    decoders' runs, a small Profile 1 encode and decode on the CPU call
    mask_thres and dequant (with thresholds, no thres_expand) at forms of
    the tables' kind, and the check's inputs meet every case of the
    chain."""
    assert ("float32", chip_smoke.OVERLAP_SHAPE[0], 2048, 2) in chip_smoke.THRES_EXPAND_FORMS
    assert ("float64", 114, 2048, 2) in chip_smoke.THRES_EXPAND_FORMS
    assert ("float32", 2 * 688, chip_smoke.FSIZE, 2) == chip_smoke.MASK_THRES_FORMS[0]
    for forms in (chip_smoke.MASK_THRES_FORMS, chip_smoke.THRES_EXPAND_FORMS):
        assert {f[2] for f in forms} >= {256, 2048, 8192, 16384}
        assert {f[0] for f in forms} == set(DTYPES)
        assert any(f[1] == f[3] == 1 for f in forms) and any(f[1] % 2 for f in forms)
    pcm = chip_smoke.make_audio(0.3, 44100, 2)
    with chip_smoke.FormTally(only=("mask_thres", "thres_expand", "dequant"),
                              device_type="cpu") as tally:
        ft.batch_decode(ft.batch_encode(pcm, 1, 44100, 16, 2048, device="cpu"), device="cpu")
    assert set(tally.seen) == {("mask_thres", (12, 2048), "float32", 44100, 2),
                               ("mask_thres", (2, 1792), "float32", 44100, 2),   # the tail
                               ("dequant", (6, 2048, 2), "int16", True, 44100),
                               ("dequant", (1, 1792, 2), "int16", True, 44100)}
    # Profile 1's runs (at 8192 samples only Profile 1 runs) are dequant's
    assert ("float32", 172, 8192, 2) not in chip_smoke.THRES_EXPAND_FORMS
    assert ("int16", (172, 8192, 2), True) in chip_smoke.DEQUANT_FORMS
    assert set(tally.unchecked()) == set(tally.seen)           # nothing was held here
    assert tbatch.mask_thres is kernels.mask_thres
    met = set()
    for fi, (dtype, rows, n, ch) in enumerate(chip_smoke.MASK_THRES_FORMS[:4]):
        x = t_(chip_smoke.mask_thres_inputs(rows, n, dtype, 700 + fi))
        for loss in (0.5, 1.8329800000000002):
            met |= {c for c, hit in chip_smoke.thres_chain_cases(torch, x, 44100, loss).items()
                    if hit}
    assert met == {"floor", "clamp", "large", "zero", "past"}


def test_chip_smoke_threshold_chain_check():
    """The card check of a lossy call's trace passes the one-launch chains
    (Profile 1's decode: dequant straight into the IDCT GEMM) and fails the
    chains of six and two launches they replaced, and a Profile 1 decode
    that still launches thres_expand."""
    dct, idct = "void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64_8x5_nn_align1>", \
        "sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x64x8"
    enc = ["at::native::vectorized_elementwise_kernel<4, CUDAFunctorOnSelf_add<float>>", dct,
           "void (anonymous namespace)::mask_thres_kernel<float, int>(...)",
           "void (anonymous namespace)::power_quant_kernel<float, int>(...)", "egr_lengths"]
    dequant = "void (anonymous namespace)::dequant_kernel<short, float, 2, true>(...)"
    emit = "void (anonymous namespace)::overlap_add_kernel<float, short, 2>(...)"
    dec = [dequant, idct, emit]
    p2_dec = ["void (anonymous namespace)::dequant_kernel<short, float, 2, false>(...)",
              "void (anonymous namespace)::tns_iir_kernel<float>(...)",
              "void (anonymous namespace)::thres_expand_kernel<float>(...)",
              "at::native::vectorized_elementwise_kernel<4, MulFunctor<float>>", idct, emit]
    p2 = enc[:3] + ["void (anonymous namespace)::tns_autocorr_kernel<float, 8>(...)"]
    assert chip_smoke.threshold_chain_fault(enc + enc[1:], dec + dec, 1) == ""
    split_k = enc[:2] + ["void cublasLt::splitKreduce_kernel<32, 16, int, float>"] + enc[2:]
    assert chip_smoke.threshold_chain_fault(split_k, dec, 1) == ""
    assert chip_smoke.threshold_chain_fault(enc, [dequant, idct, split_k[2], emit], 1) == ""
    assert chip_smoke.short_names(enc[2:3]) == ["mask_thres_kernel"]
    assert chip_smoke.threshold_chain_fault(p2, p2_dec + p2_dec, 2) == ""
    # Profile 1's decode before dequant took the thresholds, and a GEMM
    # that does not follow dequant
    p1_parent = ["void (anonymous namespace)::thres_expand_kernel<float>(...)"] + dec
    assert "1 thres_expand" in chip_smoke.threshold_chain_fault(enc, p1_parent, 1)
    assert chip_smoke.threshold_chain_fault(enc, [dequant, emit, idct], 1)
    assert chip_smoke.threshold_chain_fault(enc, [dequant, emit], 1)
    assert chip_smoke.threshold_chain_fault(p2, p1_parent, 2) == ""
    assert "0 thres_expand" in chip_smoke.threshold_chain_fault(p2, dec, 2)
    parent = enc[:2] + ["at::native::vectorized_elementwise_kernel<4, AbsFunctor<float>>",
                        "at::native::vectorized_elementwise_kernel<4, MulFunctor<float>>",
                        "at::native::vectorized_elementwise_kernel<4, MulFunctor<float>>",
                        "void gemv2T_kernel_val<int, int, float, float, float, float, 128>",
                        enc[2], "void gemmSN_NN_kernel<float, 256, 4, 2, 8, 4, 4>", enc[3]]
    assert "around the threshold chain" in chip_smoke.threshold_chain_fault(parent, dec, 1)
    parent_dec = p1_parent[:1] + ["void gemmk1_kernel<int, float, 256, 5>"] + p1_parent[1:]
    assert "2 GEMMs" in chip_smoke.threshold_chain_fault(enc, parent_dec, 2)
    assert chip_smoke.threshold_chain_fault(enc[:2] + enc[3:], dec, 1)   # no mask_thres at all
