"""The port's tensor ops against the JAX package on the CPU: constant
tables equal exactly; DCT/IDCT and the psycho chain agree at float32
within the stated tolerances; the EGR packer's words are bit-identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frad_python_tpu.ops import bitpack as jbitpack
from frad_python_tpu.ops import dct as jdct
from frad_python_tpu.ops import golomb as jgolomb
from frad_python_tpu.ops import psycho as jpsycho
from frad_python_tpu_torch.kernels.mask_thres import band_sums_plain, interpolate_plain
from frad_python_tpu_torch.ops import bitpack as tbitpack
from frad_python_tpu_torch.ops import dct as tdct
from frad_python_tpu_torch.ops import policy
from frad_python_tpu_torch.ops import psycho as tpsycho
from frad_python_tpu_torch.ops import window as twindow
from frad_python_tpu.ops import window as jwindow

CPU = torch.device("cpu")
GEOMS = [(2048, 44100), (2048, 48000), (256, 8000), (1792, 96000), (128, 44100)]


@pytest.mark.parametrize("n", [128, 1792, 2048])
def test_dct_matrices_equal(n):
    jf, ji = jdct._dct_matrices(n, "float32")
    tf, ti = tdct._dct_matrices(n, "float32")
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(ti, ji)
    df, di = tdct.device_matrices(n, CPU)
    assert df.dtype == torch.float32
    np.testing.assert_array_equal(df.numpy(), jf)
    np.testing.assert_array_equal(di.numpy(), ji)


@pytest.mark.parametrize("n,srate", GEOMS)
def test_psycho_tables_equal(n, srate):
    """The port's copies of the JAX package's masking and mapping tables
    (`_mask_consts_jnp`: 1/width, AHT floor, active bands, per-bin band,
    fraction and validity) are equal, and the plain versions' tensors are
    them cast as the JAX cores cast them (the interpolation weights are the
    entries of its `_interp_matrix`)."""
    ind, inv_w, aht, nb, b, frac, valid = jpsycho._mask_consts_jnp(n, srate)
    t_inv_w, t_aht, t_nb = tpsycho.band_consts(n, srate)
    np.testing.assert_array_equal(t_inv_w, inv_w)
    np.testing.assert_array_equal(t_aht, aht[:ind.shape[1]])
    assert t_nb == nb
    for got, want in zip(tpsycho.mapping_consts(n, srate), (b, frac, valid)):
        np.testing.assert_array_equal(got, want)
    c = tpsycho.device_consts(n, srate, CPU)
    assert c["nb"] == nb
    # the JAX cores cast the same f64 tables to f32 (jnp.asarray(.., f32))
    np.testing.assert_array_equal(c["inv_w"].numpy(), np.asarray(jnp.asarray(inv_w, jnp.float32)))
    np.testing.assert_array_equal(c["aht"].numpy(),
                                  np.asarray(jnp.asarray(aht[:ind.shape[1]], jnp.float32)))
    w = np.asarray(jnp.asarray(jpsycho._interp_matrix(n, srate), jnp.float32))
    t = np.arange(n)
    np.testing.assert_array_equal(c["w_lo"].numpy(), np.where(valid, w[b, t], 0.0))
    np.testing.assert_array_equal(c["w_hi"].numpy(),
                                  np.where(valid, w[np.minimum(b + 1, 26), t], 0.0))
    # the band sums' gather covers each active band's bins once, in order
    idx = c["sum_index"].numpy()
    for i in range(nb):
        got = idx[i].ravel()
        np.testing.assert_array_equal(got[got < n], np.nonzero(ind[:, i])[0])


def test_window_equal():
    for n in (1, 128, 1024):
        np.testing.assert_array_equal(twindow.hanning_in_overlap(n),
                                      jwindow.hanning_in_overlap(n))


def _frames(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 0.3


@pytest.mark.parametrize("n", [256, 2048])
def test_dct_idct_match_jax(n):
    x = _frames((3, 2, n), n)
    want = np.asarray(jdct.dct2_forward(jnp.asarray(x)))
    got = tdct.dct2(torch.from_numpy(x)).numpy()
    # f32 GEMMs summing in different orders: |X| <= max|x| ~ 1.5, so a few
    # float32 ulps of the sum
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    back_want = np.asarray(jdct.idct2_forward(jnp.asarray(want)))
    back = tdct.idct2(torch.from_numpy(np.array(want))).numpy()
    np.testing.assert_allclose(back, back_want, rtol=0, atol=2e-5)
    np.testing.assert_allclose(back, x, rtol=0, atol=1e-4)


@pytest.mark.parametrize("n,srate", GEOMS[:3])
def test_psycho_chain_matches_jax(n, srate):
    rng = np.random.default_rng(srate)
    spec = (np.abs(rng.standard_normal((8, n))) * 300.0).astype(np.float32)
    want = np.asarray(jax.jit(lambda f: jpsycho.mask_thres_mos_jnp(f, srate, jnp.float32(0.5)))(
        jnp.asarray(spec)))
    k = tpsycho.device_consts(n, srate, CPU)
    got = tpsycho.thres_from_sums(band_sums_plain(torch.from_numpy(spec) ** 2, k), k["inv_w"],
                                  k["aht"], k["nb"], 0.5).numpy()
    assert got.shape == want.shape == (8, tpsycho.SUBBANDS)
    # band sums (the kernel's order against a GEMM's) then pow(., 0.8):
    # float32 relative error
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)

    div_want = np.asarray(jpsycho.mapping_from_opus_jnp(jnp.asarray(want), n, srate))
    div_got = interpolate_plain(torch.from_numpy(np.array(want)), k).numpy()
    np.testing.assert_allclose(div_got, div_want, rtol=2e-6, atol=1e-30)

    x = (rng.standard_normal((3, 500)) * 50).astype(np.float32)
    np.testing.assert_array_equal(tpsycho.quant(torch.from_numpy(x)).numpy(),
                                  np.asarray(jpsycho.quant_jnp(jnp.asarray(x))))
    # pow(|x|, 4/3): libm implementations may differ in the last ulp
    np.testing.assert_allclose(tpsycho.dequant(torch.from_numpy(x)).numpy(),
                               np.asarray(jpsycho.dequant_jnp(jnp.asarray(x))),
                               rtol=3e-7, atol=0)


def _symbol_frames(kind):
    rng = np.random.default_rng(3)
    if kind == "speech":
        s = np.rint(rng.laplace(0, 3, (9, 1024)))
        s[2] = 0                                   # an all-zero frame
        s[4, ::7] = 4096                           # a power of two as max
    elif kind == "overflow":
        s = rng.integers(-(1 << 15), 1 << 15, (5, 512))   # rows overflow max_words
        s[0] = rng.integers(-2, 3, 512)
    else:
        s = rng.integers(-(1 << 22), 1 << 22, (4, 300))
    return s.astype(np.int32)


@pytest.mark.parametrize("kind", ["speech", "overflow", "wide"])
def test_egr_pack_frames_bit_identical(kind):
    sym = _symbol_frames(kind)
    max_words = max(sym.shape[1] * 12 // 32, 16)
    jw, jn, jk, jo = (np.asarray(a) for a in jbitpack.egr_pack_frames(jnp.asarray(sym), max_words))
    tw, tn, tk, to = tbitpack.egr_pack_frames(torch.from_numpy(sym), max_words)
    np.testing.assert_array_equal(tw.numpy().astype(np.uint32), jw)
    np.testing.assert_array_equal(tn.numpy(), jn)
    np.testing.assert_array_equal(tk.numpy(), jk)
    np.testing.assert_array_equal(to.numpy(), jo)
    if kind == "overflow":
        assert to.numpy()[1:].all() and not to.numpy()[0]

    flat, used = tbitpack.compact_words(tw, tn, to)
    flat, used = flat.numpy().astype(np.uint32), used.numpy()
    assert len(flat) == used.sum()
    offs = np.cumsum(used) - used
    for i in range(len(sym)):
        if to.numpy()[i]:
            assert used[i] == 0
            continue
        row = flat[offs[i]: offs[i] + used[i]]
        stream = tbitpack.words_to_stream(row, tn.numpy()[i], tk.numpy()[i])
        assert stream == jbitpack.words_to_stream(jw[i], jn[i], jk[i])
        assert stream == jgolomb.encode(sym[i].astype(np.int64))


def test_policy_device_and_dtype():
    assert policy.resolve_device("cpu") == CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            policy.resolve_device(None)
    with pytest.raises(ValueError):
        policy.check_compute_dtype("float16")
    assert policy.check_compute_dtype("float32") == "float32"
    assert policy.check_compute_dtype("float64") == "float64"
    assert policy.check_compute_dtype(None) == policy.compute_dtype()
    a = np.arange(6, dtype=np.int16).reshape(2, 3)
    t = policy.to_device(a, CPU)
    (back,) = policy.to_host(t)
    np.testing.assert_array_equal(back, a)
