"""The TNS analysis kernels' plain versions (`tns_autocorr`,
`tns_fir_gate`) and `ops/tns.tns_analysis` built from them, on the CPU at
small sizes: against scalar numpy loops of the same order (the kernels'
one written definition), and against the JAX package. The function-by-
function comparisons with `ops/tns_jax.py` are in tests/test_torch_tns.py.

Tolerances, each with its reason:

* against the scalar loops: equal bit for bit (`ac`, the residual, the
  quantised LPC); the gates are compared as booleans (numpy's `log` and
  torch's may differ in the last ulp, which moves a gate only for a row on
  its edge: none on these seeds).
* `tns_autocorr` with a divisor against the JAX chain: 5e-6 absolute at
  float32 (13 sums of up to 2048 products of a unit-norm signal in another
  order than XLA's), 1e-13 at float64; the divided spectra equal but for
  subnormal values, which XLA's CPU code flushes to zero (within 1000 times
  the smallest normal number: a subnormal over a divisor of 0.001 or more).
* `tns_analysis`, and `tns_fir_gate_plain` against the JAX chain from the
  same lags (`_levinson` -> `_quantise` -> `_fir` -> `_predgain`, the
  gates): `lpc_q` and the run mask equal lane for lane on the seeded
  spectra (0 differing lanes, the count printed); residuals 1e-5 of
  max|y| at float32, 1e-12 at float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from frad_python_tpu.ops import tns_jax
from frad_python_tpu_torch import kernels
from frad_python_tpu_torch.kernels.tns_autocorr import _SMEM_MAX as SMEM_MAX
from frad_python_tpu_torch.kernels.tns_autocorr import SUM_T, row_mean, row_sum
from frad_python_tpu_torch.kernels.tns_fir_gate import _SCRATCH as SCRATCH
from frad_python_tpu_torch.kernels.tns_fir_gate import fir_gate_plain
from frad_python_tpu_torch.ops import tns
from test_torch_tns import spectra

DTYPES = ["float32", "float64"]


def t_(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# ----------------------------------------------------------------------
# the order of the sums, spelled out with scalars
# ----------------------------------------------------------------------
def scalar_row_sum(v: np.ndarray, n: int):
    """`row_sum` of one row with scalar additions in the row's dtype."""
    ft = v.dtype.type
    steps = -(-n // SUM_T)
    acc = [ft(0)] * SUM_T
    for i in range(steps):
        for t in range(SUM_T):
            idx = i * SUM_T + t
            acc[t] = ft(acc[t] + (v[idx] if idx < len(v) else ft(0)))
    warps = []
    for w in range(SUM_T // 32):
        p = acc[w * 32:(w + 1) * 32]
        s = 16
        while s:
            p = [ft(p[i] + p[i + s]) for i in range(s)]
            s //= 2
        warps.append(p[0])
    s = len(warps) // 2
    while s:
        warps = [ft(warps[i] + warps[i + s]) for i in range(s)]
        s //= 2
    return warps[0]


def scalar_autocorr(x: np.ndarray, window: np.ndarray):
    """(ac [13], gate) of one row, as `tns_autocorr_plain` defines them."""
    ft = x.dtype.type
    n = len(x)
    mean = ft(scalar_row_sum(x, n) / ft(n))
    sig = (x - mean).astype(x.dtype)
    norm = ft(np.sqrt(np.float64(scalar_row_sum((sig * sig).astype(x.dtype), n))))
    if norm > ft(1e-6):
        sig = (sig / norm).astype(x.dtype)
    ac = np.array([ft(scalar_row_sum((sig[:n - l] * sig[l:]).astype(x.dtype), n) * window[l])
                   for l in range(13)], dtype=x.dtype)
    mag = np.abs(x)
    geo = np.exp(ft(scalar_row_sum(np.log((mag + ft(1e-10)).astype(x.dtype)), n) / ft(n)))
    ari = ft(scalar_row_sum(mag, n) / ft(n))
    flat = ft(geo / ft(ari + ft(1e-10))) < 0.5
    energy = scalar_row_sum((x * x).astype(x.dtype), n) >= ft(1e-10)
    return ac, bool(n >= 24 and flat and energy)


def scalar_fir_gate(x: np.ndarray, lpc: np.ndarray, gate: bool):
    """(out, lpc_out, run) of one row, as `tns_fir_gate_plain` defines them."""
    ft = x.dtype.type
    n = len(x)
    total = abs(lpc[1])
    for j in range(2, 13):
        total = ft(total + abs(lpc[j]))
    q = np.zeros(13, dtype=x.dtype)
    q[1:] = np.rint(np.clip((lpc[1:] * ft(15)).astype(x.dtype), -15, 14))
    run = bool(gate and total >= ft(0.01) and (q[1:] != 0).any())
    c = (q / ft(15)).astype(x.dtype)
    c[0] = 1
    y = np.empty_like(x)
    for t in range(n):
        acc = ft(c[0] * x[t])
        for j in range(1, 13):
            acc = ft(acc + ft(c[j] * (x[t - j] if t >= j else ft(0))))
        y[t] = acc
    run = run and bool(np.isfinite(y).all() and np.abs(y).max() <= ft(1e6))
    oc = (x - ft(scalar_row_sum(x, n) / ft(n))).astype(x.dtype)
    rc = (y - ft(scalar_row_sum(y, n) / ft(n))).astype(x.dtype)
    oe = scalar_row_sum((oc * oc).astype(x.dtype), n)
    re = scalar_row_sum((rc * rc).astype(x.dtype), n)
    gain = ft(0)
    if not (oe < ft(1e-10) or re < ft(1e-10) or re >= oe):
        gain = ft(ft(20) * np.log10(ft(oe / re)))
    run = run and bool(gain >= ft(0.030102999566398118))
    return (y if run else x), (q if run else np.zeros(13, dtype=x.dtype)), run


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,m", [(24, 24), (256, 256), (300, 300), (300, 288), (1792, 1780),
                                 (2048, 2048)])
def test_row_sum_order_is_the_scalar_loops(n, m, dtype):
    v = (np.random.default_rng(n + m).standard_normal((3, m))
         * np.exp(np.random.default_rng(m).standard_normal((3, m)) * 4)).astype(dtype)
    got = row_sum(t_(v), n).numpy()
    want = np.array([scalar_row_sum(row, n) for row in v])
    assert got.dtype == v.dtype
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    assert not np.array_equal(got, v.sum(axis=1)) or dtype == "float64" or n < 64
    if m == n:
        np.testing.assert_array_equal(row_mean(t_(v)).numpy(), (want / v.dtype.type(n)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [256, 300])
def test_tns_autocorr_plain_is_the_scalar_definition(n, dtype):
    x = spectra(n, dtype).reshape(12, n)
    window = tns._lag_window(getattr(torch, dtype), torch.device("cpu"))
    same, ac, gate = kernels.tns_autocorr_plain(t_(x), None, window)
    assert same.data_ptr() == t_(x).data_ptr() or torch.equal(same, t_(x))
    for i, row in enumerate(x):
        want_ac, want_gate = scalar_autocorr(row, window.numpy())
        np.testing.assert_array_equal(ac[i].numpy().view(np.uint8), want_ac.view(np.uint8))
        assert bool(gate[i]) == want_gate, i
    assert gate[:2].all() and not gate[2:5].any()


@pytest.mark.parametrize("dtype", DTYPES)
def test_tns_fir_gate_plain_is_the_scalar_definition(dtype):
    n = 300
    x = spectra(n, dtype).reshape(12, n)
    window = tns._lag_window(getattr(torch, dtype), torch.device("cpu"))
    _, ac, gate = kernels.tns_autocorr(t_(x), None, window)
    lpc = kernels.tns_levinson_plain(ac)
    out, lpc_out, run = kernels.tns_fir_gate_plain(t_(x), ac, gate)
    for i, row in enumerate(x):
        w_out, w_lpc, w_run = scalar_fir_gate(row, lpc[i].numpy(), bool(gate[i]))
        assert bool(run[i]) == w_run, i
        np.testing.assert_array_equal(out[i].numpy().view(np.uint8), w_out.view(np.uint8))
        np.testing.assert_array_equal(lpc_out[i].numpy().view(np.uint8), w_lpc.view(np.uint8))
    assert run[:2].all() and not run[2:5].any()


# ----------------------------------------------------------------------
# against the JAX package
# ----------------------------------------------------------------------
def divided(n: int, dtype: str):
    """(freqs, div) [12, n] whose quotient is `spectra` up to rounding, the
    divisor 0 over the last sixteenth of the bins."""
    x = spectra(n, "float64").reshape(12, n)
    div = np.exp(np.random.default_rng(n).standard_normal((12, n))) * 0.1
    freqs = x * div
    div[:, n - n // 16:] = 0.0
    return freqs.astype(dtype), div.astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [256, 1792, 2048])
def test_tns_autocorr_with_divisor_matches_jax(n, dtype):
    freqs, div = divided(n, dtype)
    jx = jnp.asarray(freqs) / jnp.where(jnp.asarray(div) == 0, jnp.inf, jnp.asarray(div))
    window = tns._lag_window(getattr(torch, dtype), torch.device("cpu"))
    kernels.reset_launches()
    x, ac, gate = kernels.tns_autocorr(t_(freqs), t_(div), window)
    assert kernels.tns_autocorr.launches == 0
    # XLA's CPU code flushes subnormals to zero, a spectrum value before the division too
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0,
                               atol=1e3 * np.finfo(dtype).tiny)
    assert not x[:, n - n // 16:].any()
    np.testing.assert_allclose(ac.numpy(), np.asarray(tns_jax._autocorr(jx)), rtol=0,
                               atol=5e-6 if dtype == "float32" else 1e-13)
    want_gate = np.asarray(tns_jax._flatness_gate(jx) & (jnp.sum(jx * jx, axis=-1) >= 1e-10))
    np.testing.assert_array_equal(gate.numpy(), want_gate)
    plain = kernels.tns_autocorr_plain(t_(freqs), t_(div), window)
    assert all(torch.equal(a, b) for a, b in zip((x, ac, gate), plain))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [256, 1792, 2048])
def test_tns_analysis_with_divisor_matches_jax(n, dtype):
    freqs, div = divided(n, dtype)
    jx = jnp.asarray(freqs) / jnp.where(jnp.asarray(div) == 0, jnp.inf, jnp.asarray(div))
    want_res, want_lpc = (np.asarray(a) for a in tns_jax.tns_analysis(jx))
    got_res, got_lpc = (a.numpy() for a in tns.tns_analysis(
        t_(freqs).reshape(6, 2, n), t_(div).reshape(6, 2, n)))
    assert got_res.shape == (6, 2, n) and got_lpc.shape == (6, 2, 13)
    got_res, got_lpc = got_res.reshape(12, n), got_lpc.reshape(12, 13)
    differing = int((got_lpc != want_lpc).any(axis=-1).sum())
    assert differing == 0, f"{differing} of 12 lanes decide differently"
    ran = want_lpc.any(axis=-1)
    assert 3 <= ran.sum() <= 10
    np.testing.assert_allclose(got_res, want_res, rtol=0, atol=(
        1e-5 if dtype == "float32" else 1e-12) * np.abs(want_res).max())
    np.testing.assert_array_equal(got_res[~ran], (t_(freqs) / torch.where(
        t_(div) == 0, torch.inf, t_(div))).numpy()[~ran])                 # bypass: untouched
    # the run mask is tns_fir_gate's third output
    window = tns._lag_window(getattr(torch, dtype), torch.device("cpu"))
    x, ac, gate = kernels.tns_autocorr(t_(freqs), t_(div), window)
    out, lpc_out, run = kernels.tns_fir_gate(x, ac, gate)
    np.testing.assert_array_equal(run.numpy(), ran)
    np.testing.assert_array_equal(out.numpy(), got_res)
    np.testing.assert_array_equal(lpc_out.numpy(), got_lpc)


def jax_fir_gate(x: np.ndarray, ac: np.ndarray, gate: np.ndarray):
    """(out, lpc_out, run) of the back of `tns_jax.tns_analysis` from the
    lags and the gate: `_levinson`, `_quantise`, `_dequantise`, `_fir`,
    `_predgain` and the gates and selects around them."""
    jx = jnp.asarray(x)
    lpc = tns_jax._levinson(jnp.asarray(ac))
    run = jnp.asarray(gate) & (jnp.sum(jnp.abs(lpc[..., 1:]), axis=-1) >= 0.01)
    lpc_q = tns_jax._quantise(lpc)
    run = run & jnp.any(lpc_q[..., 1:] != 0, axis=-1)
    resid = tns_jax._fir(jx, tns_jax._dequantise(lpc_q))
    run = run & jnp.all(jnp.isfinite(resid), axis=-1) & (jnp.max(jnp.abs(resid), axis=-1) <= 1e6)
    run = run & (tns_jax._predgain(jx, resid) >= tns_jax.MIN_PRED)
    out = jnp.where(run[..., None], resid, jx)
    return tuple(np.asarray(a) for a in (out, jnp.where(run[..., None], lpc_q, 0.0), run))


@pytest.mark.parametrize("dtype", DTYPES)
def test_tns_fir_gate_plain_is_the_recursion_then_the_fir_gate(dtype):
    """The fused function from the lags: bit for bit the recursion followed
    by `fir_gate_plain`, and the JAX chain within the module's tolerances,
    on natural rows and on chip_smoke.py's gate rows."""
    n = 2048
    freqs, div = divided(n, dtype)
    window = tns._lag_window(getattr(torch, dtype), torch.device("cpu"))
    x, ac, gate = kernels.tns_autocorr(t_(freqs), t_(div), window)
    xb, ac_b, gate_b = chip_smoke.fir_gate_inputs(torch, x, ac[0])
    x, ac, gate = torch.cat([x, xb]), torch.cat([ac, ac_b]), torch.cat([gate, gate_b])
    got = kernels.tns_fir_gate_plain(x, ac, gate)
    want = fir_gate_plain(x, kernels.tns_levinson_plain(ac), gate)
    for g, w in zip(got, want):
        assert torch.equal(g, w) if g.dtype == torch.bool else chip_smoke.bits_equal(torch, g, w)
    out, lpc_out, run = (a.numpy() for a in got)
    j_out, j_lpc, j_run = jax_fir_gate(x.numpy(), ac.numpy(), gate.numpy())
    flipped = int((run != j_run).sum())
    print(f"tns_fir_gate_plain {dtype} [{len(run)}, {n}]: {flipped} lanes decide differently "
          f"from the JAX chain, TNS runs on {int(run.sum())}")
    assert flipped == 0
    assert 3 <= run.sum() <= len(run) - 3
    np.testing.assert_array_equal(lpc_out, j_lpc)
    np.testing.assert_array_equal(out[~run], x.numpy()[~run])              # bypass: untouched
    np.testing.assert_array_equal(j_out[~run], x.numpy()[~run])
    np.testing.assert_allclose(out[run], j_out[run], rtol=0, atol=(
        1e-5 if dtype == "float32" else 1e-12) * np.abs(j_out[run]).max())


@pytest.mark.parametrize("dtype,shape", chip_smoke.FIR_GATE_EXTRA_FORMS)
def test_chip_smoke_fir_gate_extra_forms_reach_their_paths(dtype, shape):
    """The card check's extra tns_fir_gate forms, through the plain
    version: TNS runs on a row of each; the 1001-sample rows start both on
    and off 16-byte boundaries; the long float64 rows fit a block's shared
    memory alone, but not beside their residual."""
    lanes, n = shape
    freqs, div = (t_(a) for a in chip_smoke.analysis_inputs(lanes, n, dtype, 700 + n))
    x, ac, gate = kernels.tns_autocorr_plain(freqs, div, tns._lag_window(freqs.dtype,
                                                                         torch.device("cpu")))
    out, lpc_out, run = kernels.tns_fir_gate(x, ac, gate)
    assert run.any() and lpc_out[run].any()
    size = x.element_size()
    starts = {lane * n * size % 16 for lane in range(lanes)}
    if n == 1001:
        assert 0 in starts and len(starts) > 1
    else:
        assert (2 * n + SCRATCH) * size > SMEM_MAX >= (n + SCRATCH) * size


def test_tns_analysis_is_two_wrapper_calls_and_no_launch_on_the_cpu():
    x = spectra(256, "float32")
    kernels.reset_launches()
    with chip_smoke.FormTally(device_type="cpu") as tally:
        tns.tns_analysis(t_(x))
    assert tally.seen == {("tns_autocorr", (12, 256), "float32", False): 1,
                          ("tns_fir_gate", (12, 256), "float32"): 1}
    assert all(k.launches == 0 for k in kernels.KERNELS)
    assert tns._fir is kernels.tns_fir_gate.__globals__["fir_plain"]
    assert tns._flatness_gate is kernels.tns_autocorr.__globals__["flatness_gate_plain"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_chip_smoke_analysis_inputs_cover_every_gate(dtype):
    """The card check's inputs, through the plain versions: every gate is
    met from both sides, and bypassed rows come back bit for bit."""
    lanes, n = 28, 512
    freqs, div = (t_(a) for a in chip_smoke.analysis_inputs(lanes, n, dtype, 5))
    window = tns._lag_window(freqs.dtype, torch.device("cpu"))
    x, ac, gate = kernels.tns_autocorr(freqs, div, window)
    out, lpc_out, run = kernels.tns_fir_gate(x, ac, gate)
    kind = torch.arange(lanes) % chip_smoke.ANALYSIS_KINDS
    assert run[kind == 0].all() and gate[kind == 12].all() and not run[kind == 12].any()
    for k in (2, 3, 4, 13):
        assert not gate[kind == k].any(), k
    assert torch.isinf(x[kind == 13]).any() and chip_smoke.bits_equal(torch, out[~run], x[~run])
    assert not lpc_out[~run].any() and lpc_out[run].any()
    assert 0 < int(gate[(kind >= 6) & (kind < 12)].sum()) < 12       # the flatness edge
    xb, ac_b, gate_b = chip_smoke.fir_gate_inputs(torch, x, ac[0])
    out_b, lpc_out_b, run_b = kernels.tns_fir_gate(xb, ac_b, gate_b)
    kind_b = torch.arange(lanes) % chip_smoke.FIR_KINDS
    assert run_b[(kind_b == 0) | (kind_b == 6)].all()
    assert not run_b[(kind_b > 0) & (kind_b < 6)].any()
    assert chip_smoke.bits_equal(torch, out_b[~run_b], xb[~run_b])
    assert torch.isnan(out_b[kind_b == 5]).any() and not lpc_out_b[~run_b].any()
    # the AR(1) lags give the LPC [1, -rho, ~0, ...]: kind 1 sums under 0.01,
    # kind 2 rounds to 0; kind 4 overflows in the filter, kind 3 fails on
    # the gain alone
    lpc_b = tns._levinson(ac_b)
    rho = {1: 0.0005, 2: 0.02, 3: -0.9, 4: -0.9}
    for k, r in rho.items():
        np.testing.assert_allclose(lpc_b[kind_b == k][:, 1].numpy(), -r, rtol=1e-6)
        assert (lpc_b[kind_b == k][:, 2:].abs() < 1e-6).all()
    total = lpc_b[:, 1:].abs().sum(-1)
    assert (total[kind_b == 1] < 0.01).all() and (total[kind_b == 2] >= 0.01).all()
    assert not tns._quantise(lpc_b)[kind_b == 2].any() and tns._quantise(lpc_b)[kind_b == 3].any()
    resid = tns._fir(xb, tns._dequantise(tns._quantise(lpc_b)))
    assert not torch.isfinite(resid[kind_b == 4]).all()
    assert torch.isfinite(resid[kind_b == 3]).all() and (tns._predgain(xb, resid)[kind_b == 3]
                                                         == 0).all()


# ----------------------------------------------------------------------
# the kernel's split of the sums over two threads an owner
# ----------------------------------------------------------------------
#: threads of the tns_autocorr kernel's block, lags of an owner's first thread
NT, LAGS0 = 2 * SUM_T, 7


def split_kernel_model(freqs: torch.Tensor, div, window: torch.Tensor):
    """(x, ac, gate) of rows [L, n] as csrc/tns_autocorr.cu computes them
    with 512 threads a row: thread tid is half h = tid // 256 of owner
    t = tid % 256; the first half sums x, x^2 and |x| (slots 0-2), the
    second log(|x| + 1e-10) (slot 3); the centring sum stays with the first
    half; the first half sums lags 0-6, the second lags 7-12. Every running sum adds the
    owner's elements t, t + 256, ... from +0 (padded steps add +0); lane 0
    of each warp writes its warp's shuffle-tree sum to scratch slot
    (warp % 8) * kt + first + k, and `tree` adds the 8 warp sums of a slot."""
    dt = freqs.dtype
    lanes, n = freqs.shape
    zero, tiny = torch.zeros((), dtype=dt), torch.tensor(1e-10, dtype=dt)
    x = freqs if div is None else freqs / torch.where(div == 0, torch.inf, div)
    steps = -(-n // SUM_T)

    def owned(v, i):              # [L, 256]: element t + 256 i of each owner, +0 past n
        idx = torch.arange(SUM_T) + i * SUM_T
        return torch.where(idx < n, v[:, idx.clamp(max=n - 1)], zero)

    def warp_sums(sums, scratch, kt):
        """sums {(half, first slot): [L, K, 256] running sums} -> scratch"""
        for (h, first), s in sums.items():
            for w in range(h * 8, h * 8 + 8):
                p = s[..., (w % 8) * 32:(w % 8) * 32 + 32]
                for sh in (16, 8, 4, 2, 1):
                    p = p[..., :sh] + p[..., sh:2 * sh]
                for k in range(s.shape[1]):
                    scratch[:, (w % 8) * kt + first + k] = p[:, k, 0]

    def tree(scratch, kt, slot):
        w = [scratch[:, j * kt + slot] for j in range(8)]
        for sh in (4, 2, 1):
            w = [w[j] + w[j + sh] for j in range(sh)]
        return w[0]

    lg = torch.log(torch.abs(x) + tiny)            # each thread's own log, elementwise
    s = {(0, 0): torch.zeros((lanes, 3, SUM_T), dtype=dt),
         (1, 3): torch.zeros((lanes, 1, SUM_T), dtype=dt)}
    for i in range(steps):
        xi = owned(x, i)
        s[(0, 0)] = s[(0, 0)] + torch.stack([xi, xi * xi, torch.abs(xi)], 1)
        s[(1, 3)] = s[(1, 3)] + owned(lg, i)[:, None]
    sc1 = torch.zeros((lanes, 8 * 4), dtype=dt)
    warp_sums(s, sc1, 4)
    nn = torch.full((lanes,), n, dtype=dt)
    mean = tree(sc1, 4, 0) / nn
    flat = torch.exp(tree(sc1, 4, 3) / nn) / (tree(sc1, 4, 2) / nn + tiny) < 0.5
    gate = flat & (n >= 24) & (tree(sc1, 4, 1) >= tiny)

    row = x - mean[:, None]
    e = torch.zeros((lanes, 1, SUM_T), dtype=dt)
    for i in range(steps):
        ri = owned(row, i)
        e = e + (ri * ri)[:, None]
    sc2 = torch.zeros((lanes, 8), dtype=dt)
    warp_sums({(0, 0): e}, sc2, 1)
    norm = torch.from_numpy(np.sqrt(tree(sc2, 1, 0).double().numpy())).to(dt)
    row = torch.where(norm[:, None] > torch.tensor(1e-6, dtype=dt), row / norm[:, None], row)

    acc = {(0, 0): torch.zeros((lanes, LAGS0, SUM_T), dtype=dt),
           (1, LAGS0): torch.zeros((lanes, LAGS0, SUM_T), dtype=dt)}
    for i in range(steps):
        a = owned(row, i)
        for (h, l0), sums in acc.items():
            for j in range(13 - LAGS0 if h else LAGS0):
                idx = torch.arange(SUM_T) + i * SUM_T + l0 + j
                nb = torch.where(idx < n, row[:, idx.clamp(max=n - 1)], zero)
                sums[:, j] = sums[:, j] + torch.where(idx < n, a * nb, zero)
    sc3 = torch.zeros((lanes, 8 * 2 * LAGS0), dtype=dt)
    warp_sums(acc, sc3, 2 * LAGS0)
    ac = torch.stack([tree(sc3, 2 * LAGS0, l) * window[l] for l in range(13)], -1)
    return x, ac, gate


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [256, 300, 2048])
@pytest.mark.parametrize("with_div", [False, True])
def test_tns_autocorr_split_model_is_the_plain_version(n, dtype, with_div):
    """The kernel's split of each owner's sums over two threads changes
    no sum's order: its model equals tns_autocorr_plain bit for bit."""
    if with_div:
        freqs, div = (t_(a) for a in divided(n, dtype))
    else:
        freqs, div = t_(spectra(n, dtype).reshape(12, n)), None
    window = tns._lag_window(freqs.dtype, torch.device("cpu"))
    got = split_kernel_model(freqs, div, window)
    want = kernels.tns_autocorr_plain(freqs, div, window)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.equal(g, w) if g.dtype == torch.bool else chip_smoke.bits_equal(torch, g, w)
    assert want[2].any() and not want[2].all()
