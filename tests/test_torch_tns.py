"""Profile 2's TNS in the port against the JAX package, on the CPU at small
sizes with the kernels' plain versions: `ops/tns.py` function by function,
the widened kernels' plain versions, and the Profile 2 cores. Inputs are
made with numpy from a seed and go through both. The codec, pipeline and
engines above them are in tests/test_torch_p2.py.

Tolerances, each with its reason:

* `_autocorr`: 5e-6 absolute at float32 (13 sums of up to 2048 products
  of a unit-norm signal, summed in another order than XLA's), 1e-13 at
  float64.
* `_levinson` (`tns_levinson_plain`): same operations in the same order;
  XLA may contract a multiply-add, so 2e-5 absolute at float32 (the
  recursion amplifies an ulp through up to 12 steps), 1e-11 at float64.
* `_quantise` / `_dequantise`: exact.
* `_fir`: 13 multiply-adds in the same order: 1e-5 of max|y| at float32,
  1e-13 at float64. `_iir` (`tns_iir_plain`): the JAX scan leaves the
  order of its 12-term sum to XLA and the filter feeds errors back: 1e-4
  of max|y| at float32, 1e-11 at float64. The plain version's own order
  (the 12 products, then from +0 the adds j = 12 .. 1, oldest output
  first, then x[t] - acc) is held against a scalar numpy loop bit for bit.
* `tns_analysis`: `lpc_q` must be equal lane for lane on these seeds (the
  count of differing lanes is asserted to be 0: they are wire bytes and a
  gate flip changes a whole frame); residuals like `_fir`.
* cores: symbols may flip by 1 at rint boundaries at float32 (at most
  1e-4 of them); at float64 none on these seeds. Decoded PCM within 2e-6
  (float32, |pcm| < 2: a few ulps of the IDCT sum after the TNS filter)
  and 1e-9 (float64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from frad_python_tpu.models import batch as jbatch
from frad_python_tpu.ops import psycho as jpsycho
from frad_python_tpu.ops import tns_jax
from frad_python_tpu_torch import kernels
from frad_python_tpu_torch.kernels.overlap_add import crossfade_window
from frad_python_tpu_torch.models import batch as tbatch
from frad_python_tpu_torch.ops import tns

CPU = torch.device("cpu")
DTYPES = ["float32", "float64"]
SIZES = [256, 2048]
ATOL_PCM = {"float32": 2e-6, "float64": 1e-9}


def spectra(n: int, dtype: str, seed: int = 7) -> np.ndarray:
    """[6, 2, n] spectra: tonal and decaying lanes (TNS runs), white noise
    (the flatness gate), energy and zero lanes, a near-constant lane (the
    tiny-coefficient gate) and tone/noise mixtures around the flatness
    gate's edge."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    lanes = [np.exp(-t / 40.0) * np.sin(t * 0.7) * 50,
             np.exp(-t / 15.0) * rng.standard_normal(n) * 20,
             rng.standard_normal(n),
             np.full(n, 1e-8),
             np.zeros(n),
             1.0 + 1e-4 * rng.standard_normal(n)]
    for mix in (0.2, 0.4, 0.5, 0.55, 0.6, 0.8):
        lanes.append((1 - mix) * np.exp(-t / 30.0) * np.sin(t * 0.3) * 30
                     + mix * rng.standard_normal(n))
    return np.stack(lanes).reshape(6, 2, n).astype(dtype)


def stable_coeffs(lanes: int, dtype: str, seed: int) -> np.ndarray:
    """[lanes, 13] dequantised filters with sum |a| < 1 (stable), every
    third lane the bypass [1, 0, ...]."""
    rng = np.random.default_rng(seed)
    q = np.zeros((lanes, 13))
    q[:, 1] = rng.integers(-7, 8, lanes)
    q[:, 2] = rng.integers(-3, 4, lanes)
    q[:, 3:6] = rng.integers(-1, 2, (lanes, 3))
    q[::3] = 0
    c = q / 15.0
    c[:, 0] = 1.0
    return c.astype(dtype)


def t_(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def snr_db(ref, out):
    m = min(len(ref), len(out))
    return 10 * np.log10(np.sum(ref[:m] ** 2) / np.sum((out[:m] - ref[:m]) ** 2))


# ----------------------------------------------------------------------
# ops/tns.py against ops/tns_jax.py, function by function
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
def test_autocorr_matches_jax(n, dtype):
    x = spectra(n, dtype)
    want = np.asarray(tns_jax._autocorr(jnp.asarray(x)))
    got = tns._autocorr(t_(x)).numpy()
    assert got.dtype == x.dtype and got.shape == (6, 2, 13)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6 if dtype == "float32" else 1e-13)


def _lags(dtype: str) -> np.ndarray:
    ac = np.asarray(tns_jax._autocorr(jnp.asarray(spectra(512, "float64")))).reshape(-1, 13)
    lag = np.arange(13)
    extra = np.stack([np.zeros(13),                                  # dead
                      np.cos(0.01 * lag),                            # clamped reflection
                      1.1e-10 * np.where(lag == 2, 2.0, 1.0),        # two clamps, then frozen
                      np.r_[1.0, np.random.default_rng(3).standard_normal(12) * 0.3]])
    return np.concatenate([ac, extra]).astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_levinson_plain_matches_jax(dtype):
    ac = _lags(dtype)
    want = np.asarray(tns_jax._levinson(jnp.asarray(ac)))
    got = kernels.tns_levinson_plain(t_(ac)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 if dtype == "float32" else 1e-11)
    np.testing.assert_array_equal(got[12], np.eye(13)[0])            # the dead lane
    assert got[14, 2] == np.dtype(dtype).type(-0.96) and not got[14, 3:].any()
    kernels.reset_launches()
    assert torch.equal(tns._levinson(t_(ac).reshape(4, 4, 13)).reshape(-1, 13), t_(got))
    assert all(k.launches == 0 for k in kernels.KERNELS)


@pytest.mark.parametrize("dtype", DTYPES)
def test_quantise_dequantise_match_jax(dtype):
    lpc = np.random.default_rng(5).standard_normal((40, 13)).astype(dtype) * 0.8
    lpc[:, 0] = 1.0
    want_q = np.asarray(tns_jax._quantise(jnp.asarray(lpc)))
    got_q = tns._quantise(t_(lpc)).numpy()
    np.testing.assert_array_equal(got_q, want_q)
    assert got_q.min() == -15 and got_q.max() == 14
    np.testing.assert_array_equal(tns._dequantise(t_(got_q)).numpy(),
                                  np.asarray(tns_jax._dequantise(jnp.asarray(want_q))))


@pytest.mark.parametrize("dtype", DTYPES)
def test_fir_matches_jax(dtype):
    x = spectra(256, dtype)
    c = stable_coeffs(12, dtype, 1).reshape(6, 2, 13)
    want = np.asarray(tns_jax._fir(jnp.asarray(x), jnp.asarray(c)))
    got = tns._fir(t_(x), t_(c)).numpy()
    tol = (1e-5 if dtype == "float32" else 1e-13) * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
def test_iir_plain_matches_jax(n, dtype):
    x = spectra(n, dtype).reshape(12, n)
    c = stable_coeffs(12, dtype, 2)
    want = np.asarray(tns_jax._iir(jnp.asarray(x), jnp.asarray(c)))
    got = kernels.tns_iir_plain(t_(x), t_(c))
    tol = (1e-4 if dtype == "float32" else 1e-11) * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    # a bypass lane returns its input bit for bit (signed zeros too)
    np.testing.assert_array_equal(got.numpy()[::3].view(np.uint8), x[::3].view(np.uint8))
    kernels.reset_launches()
    assert torch.equal(tns._iir(t_(x).reshape(6, 2, n), t_(c).reshape(6, 2, 13)).reshape(12, n),
                       got)
    assert kernels.tns_iir.launches == 0


def scalar_iir(x: np.ndarray, c: np.ndarray, newest_first: bool = False) -> np.ndarray:
    """One lane of `tns_iir_plain` with scalar operations in the lane's
    dtype: the 12 products, acc = +0, the adds j = 12, 11, .. 1 (with
    `newest_first` j = 1 .. 12, the order before the redesign), then
    x[t] - acc."""
    ft = x.dtype.type
    y = np.zeros(len(x) + 12, dtype=x.dtype)              # y[t + 12] is step t
    order = range(1, 13) if newest_first else range(12, 0, -1)
    for t in range(len(x)):
        p = {j: ft(c[j] * y[t + 12 - j]) for j in range(1, 13)}
        acc = ft(0)
        for j in order:
            acc = ft(acc + p[j])
        y[t + 12] = ft(x[t] - acc)
    return y[12:]


@pytest.mark.parametrize("dtype", DTYPES)
def test_iir_plain_order_is_the_scalar_loops(dtype):
    n = 160
    x = spectra(n, dtype).reshape(12, n)
    c = stable_coeffs(12, dtype, 4)
    c[1, 1:] = np.random.default_rng(9).uniform(-0.08, 0.08, 12)     # all 12 taps in use
    x[2, 5], x[2, 6] = -0.0, 0.0                                     # lane 0 is a bypass lane
    x[0, 3] = -0.0
    got = kernels.tns_iir_plain(t_(x), t_(c)).numpy()
    want = np.stack([scalar_iir(x[i], c[i]) for i in range(12)])
    assert got.dtype == x.dtype
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    # a bypassed lane returns x bit for bit, signed zeros included
    np.testing.assert_array_equal(got[::3].view(np.uint8), x[::3].view(np.uint8))
    # the order is part of the function: newest first rounds elsewhere
    other = np.stack([scalar_iir(x[i], c[i], newest_first=True) for i in range(12)])
    assert not np.array_equal(other, want)
    tol = (1e-5 if dtype == "float32" else 1e-13) * np.abs(want).max()
    np.testing.assert_allclose(other, want, rtol=0, atol=tol)


def _alike(got_lpc: np.ndarray, want_lpc: np.ndarray) -> np.ndarray:
    """Lanes whose quantised LPC rows agree (they decided the gates alike)."""
    return (got_lpc == want_lpc).all(axis=-1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
def test_tns_analysis_matches_jax(n, dtype):
    x = spectra(n, dtype)
    want_res, want_lpc = (np.asarray(a) for a in tns_jax.tns_analysis(jnp.asarray(x)))
    got_res, got_lpc = (a.numpy() for a in tns.tns_analysis(t_(x)))
    alike = _alike(got_lpc, want_lpc)
    assert int((~alike).sum()) == 0, f"{int((~alike).sum())} of 12 lanes decide differently"
    ran = want_lpc.any(axis=-1)
    assert ran[0].all() and not ran[1:3].any() and 3 <= ran.sum() <= 9   # both outcomes covered
    tol = (1e-5 if dtype == "float32" else 1e-12) * np.abs(want_res).max()
    np.testing.assert_allclose(got_res, want_res, rtol=0, atol=tol)
    np.testing.assert_array_equal(got_res[~ran], x[~ran])              # bypass: untouched


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
def test_tns_synthesis_matches_jax(n, dtype):
    x = spectra(n, dtype)
    res, lpc = (np.array(a) for a in tns_jax.tns_analysis(jnp.asarray(x)))
    # one filter that blows up past 1e6: the lane passes through
    lpc[5, 1] = 0
    lpc[5, 1, 1:3] = (-15, -14)
    want = np.asarray(tns_jax.tns_synthesis(jnp.asarray(res), jnp.asarray(lpc)))
    got = tns.tns_synthesis(t_(res), t_(lpc)).numpy()
    tol = (1e-4 if dtype == "float32" else 1e-10) * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    np.testing.assert_array_equal(got[5, 1], res[5, 1])
    ran = lpc.any(axis=-1)
    ran[5, 1] = False
    np.testing.assert_allclose(got[ran], x[ran], rtol=0,                 # analysis inverted
                               atol=(2e-3 if dtype == "float32" else 1e-9) * np.abs(x).max())


def test_tns_short_frame_is_bypassed():
    short = (np.random.default_rng(7).standard_normal((3, 16))
             * np.exp(-np.arange(16) / 3.0)).astype(np.float32)
    res, lpc = tns.tns_analysis(t_(short))
    np.testing.assert_array_equal(res.numpy(), short)
    assert not lpc.numpy().any()
    want_res, want_lpc = tns_jax.tns_analysis(jnp.asarray(short))
    np.testing.assert_array_equal(lpc.numpy(), np.asarray(want_lpc))


# ----------------------------------------------------------------------
# kernels' plain versions of the widened forms
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
def test_power_quant_plain_without_divisor_equals_jax_chain(dtype):
    x = (np.random.default_rng(11).standard_normal((32, 512)) * 0.3).astype(dtype)
    factor = 2.0 ** 15
    idt = jnp.int64 if dtype == "float64" else jnp.int32
    want = np.asarray(jnp.rint(jpsycho.quant_jnp(jnp.asarray(x) * factor)).astype(idt))
    got = kernels.power_quant_plain(t_(x), None, factor)
    assert got.dtype == (torch.int64 if dtype == "float64" else torch.int32)
    np.testing.assert_array_equal(got.numpy(), want)
    kernels.reset_launches()
    assert torch.equal(kernels.power_quant(t_(x), None, factor), got)
    assert kernels.power_quant.launches == 0 and np.abs(want).max() > 1000


def test_power_quant_plain_float64_with_divisor_equals_jax_chain():
    rng = np.random.default_rng(12)
    x = rng.standard_normal((32, 512)) * 1e-2
    div = np.exp(rng.standard_normal((32, 512)) * 2.0) * 0.1
    div[:, -40:] = 0.0
    d = jnp.where(jnp.asarray(div) == 0.0, jnp.inf, jnp.asarray(div))
    want = np.asarray(jnp.rint(jpsycho.quant_jnp(jnp.asarray(x) / d * 2.0 ** 15))
                      .astype(jnp.int64))
    got = kernels.power_quant_plain(t_(x), t_(div), 2.0 ** 15)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("i16", [False, True])
def test_overlap_add_plain_float64_matches_overlap_add_core(i16):
    olap, cut = 16, 240
    frames = np.random.default_rng(13).standard_normal((7, olap + cut, 2)) * 0.4
    want = np.asarray(jbatch.overlap_add_core(jnp.asarray(frames), olap, cut))
    w = crossfade_window(olap, CPU, torch.float64)
    assert w.dtype == torch.float64
    out, frag = kernels.overlap_add(t_(frames).transpose(1, 2).contiguous(), w, cut, i16)
    np.testing.assert_array_equal(frag.numpy(), frames[-1, cut:])
    if i16:
        want16 = np.clip(np.rint(want * 32768.0), -32768, 32767)
        assert out.dtype == torch.int16 and np.abs(out.numpy() - want16).max() <= 1
    else:
        assert out.dtype == torch.float64
        np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=1e-15)
        assert tbatch.overlap_add_core(t_(frames), olap, cut).equal(out)


# ----------------------------------------------------------------------
# the Profile 2 cores
# ----------------------------------------------------------------------
def _frames(dtype: str, b: int = 4, n: int = 2048, seed: int = 0) -> np.ndarray:
    """[b, n, 2] PCM frames of chip_smoke's content (harmonics plus
    noise), on which TNS runs on about half the lanes, from an offset
    that depends on `seed`."""
    pcm = chip_smoke.make_audio((b * n + seed * 1000) / 44100 + 0.01, 44100, 2)
    return pcm[seed * 1000: seed * 1000 + b * n].reshape(b, n, 2).astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_p2_encode_core_matches_jax(dtype):
    frames = _frames(dtype)
    factor = 2.0 ** 15
    want = [np.asarray(a) for a in jbatch.p2_encode_core(frames, 44100, 0.5, factor)]
    got = [a.numpy() for a in tbatch.p2_encode_core(t_(frames), 44100, 0.5, factor)]
    idt = np.int64 if dtype == "float64" else np.int32
    assert [g.shape for g in got] == [(4, 2048, 2), (4, 27, 2), (4, 13, 2)]
    assert all(g.dtype == idt for g in got) and all(w.dtype == idt for w in want)
    differing = int((~_alike(got[2].transpose(0, 2, 1), want[2].transpose(0, 2, 1))).sum())
    assert differing == 0, f"{differing} of 8 lanes decide TNS differently"
    assert want[2].any(axis=1).sum() >= 3                     # TNS ran on some lanes
    np.testing.assert_array_equal(got[1], want[1])
    flips = got[0] != want[0]
    assert np.abs(got[0] - want[0]).max() <= 1
    assert flips.mean() <= (1e-4 if dtype == "float32" else 0.0), flips.mean()


@pytest.mark.parametrize("dtype", DTYPES)
def test_p2_decode_cores_match_jax(dtype):
    frames = _frames(dtype, seed=1)
    factor = 2.0 ** 15
    fq, tq, lq = (np.asarray(a).astype(dtype)
                  for a in jbatch.p2_encode_core(frames, 44100, 0.5, factor))
    want = np.asarray(jbatch.p2_decode_core(fq, tq, lq, 44100, factor))
    got = tbatch.p2_decode_core(t_(fq), t_(tq), t_(lq), 44100, factor)
    assert got.dtype == t_(fq).dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_PCM[dtype])
    assert snr_db(frames.reshape(-1, 2).astype(np.float64),
                  got.numpy().reshape(-1, 2).astype(np.float64)) > 10
    olap, cut = 128, 1920
    want_oa = np.asarray(jbatch.overlap_add_core(jnp.asarray(want), olap, cut))
    out, frag = tbatch.p2_decode_oa_core(t_(fq), t_(tq), t_(lq), 44100, factor, olap, cut, False)
    np.testing.assert_allclose(out.numpy(), want_oa, rtol=0, atol=ATOL_PCM[dtype])
    np.testing.assert_allclose(frag.numpy(), want[-1, cut:], rtol=0, atol=ATOL_PCM[dtype])
    if dtype == "float32":
        # the int16 symbol upload is exact
        out16, _ = tbatch.p2_decode_oa_core(t_(fq.astype(np.int16)), t_(tq), t_(lq), 44100,
                                            factor, olap, cut, False)
        assert torch.equal(out16, out)


def _iir_newest_first(x: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """`tns_iir_plain` as it was before the sum's order changed: the adds
    j = 1 .. 12, the newest output first."""
    lanes, n = x.shape
    buf = torch.zeros((lanes, n + 12), dtype=x.dtype)
    a_rev = coeffs[:, 1:].flip(-1).contiguous()
    for t in range(n):
        p = a_rev * buf[:, t:t + 12]
        acc = torch.zeros_like(p[:, 0])
        for j in range(1, 13):
            acc = acc + p[:, 12 - j]
        buf[:, t + 12] = x[:, t] - acc
    return buf[:, 12:].contiguous()


@pytest.mark.parametrize("dtype", DTYPES)
def test_p2_decode_moves_only_in_its_last_bits_with_the_sums_order(dtype, monkeypatch):
    """The Profile 2 decode with the synthesis filter's sum taken oldest
    first against the same decode with the earlier order (newest first)
    and against the JAX package: the two orders differ (the change is
    real), by less than either differs from the JAX package's bound."""
    frames = _frames(dtype, seed=1)
    factor = 2.0 ** 15
    fq, tq, lq = (np.asarray(a).astype(dtype)
                  for a in jbatch.p2_encode_core(frames, 44100, 0.5, factor))
    want = np.asarray(jbatch.p2_decode_core(fq, tq, lq, 44100, factor))
    new = tbatch.p2_decode_core(t_(fq), t_(tq), t_(lq), 44100, factor).numpy()
    monkeypatch.setattr(tns, "tns_iir", _iir_newest_first)
    old = tbatch.p2_decode_core(t_(fq), t_(tq), t_(lq), 44100, factor).numpy()
    d_order, d_new, d_old = (float(np.abs(a - b).max())
                             for a, b in ((new, old), (new, want), (old, want)))
    print(f"p2_decode_core {dtype}: max|oldest first - newest first| {d_order}, against the JAX "
          f"package: oldest first {d_new}, newest first {d_old}")
    assert 0 < d_order <= ATOL_PCM[dtype]
    assert d_new <= ATOL_PCM[dtype] and d_old <= ATOL_PCM[dtype]


# ----------------------------------------------------------------------
# chip_smoke.py's kernel inputs
# ----------------------------------------------------------------------
def test_chip_smoke_tns_inputs_cover_every_case():
    x, coeffs, ac = (t_(a) for a in chip_smoke.tns_inputs(70, 256, "float32", 3))
    y = kernels.tns_iir(x, coeffs)
    lpc = kernels.tns_levinson_plain(ac)
    kind = torch.arange(70) % 7
    assert chip_smoke.bits_equal(torch, y[kind == 1], x[kind == 1])
    assert torch.isfinite(y).all() and (y[kind == 4].abs().amax(dim=-1) > 1e6).all()
    assert (lpc[kind == 2] == torch.eye(13)[0]).all() and not lpc[kind == 5][:, 3:].any()
    assert (lpc[kind == 5][:, 2] == torch.tensor(-0.96)).all()
    assert not chip_smoke.bits_equal(torch, torch.tensor([0.0]), torch.tensor([-0.0]))
    ms, by = chip_smoke.bound(22.6e6, 70e6)
    assert by == "bytes" and abs(ms - 22.6e6 / 3.35e12 * 1e3) < 1e-12
