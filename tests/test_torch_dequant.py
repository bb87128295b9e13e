"""`dequant` (CPU: its plain version) against the JAX package's pre-IDCT
chain (`psycho.dequant_jnp(x) / factor * div`, `models/batch.py:
_p1_decode_jit`), and the decode cores around it against the lines they
held before the kernel took the chain's place.

Tolerances: float64 within 1e-12 relative (two pow implementations);
float32 within 2 ulp (XLA's and torch's powf each within an ulp of the
true power, then two roundings both make alike). The cores against their
former lines: exact, the same operations in the same order on the same
machine."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frad_python_tpu.ops import psycho as jpsycho
from frad_python_tpu_torch import kernels
from frad_python_tpu_torch.models import batch as tbatch
from frad_python_tpu_torch.ops import psycho as tpsycho
from frad_python_tpu_torch.ops import tns as ttns
from frad_python_tpu_torch.ops.dct import idct2

SHAPES = [(3, 256, 2), (2, 512, 1), (2, 128, 8), (1, 8192, 2), (1, 16384, 1)]
EDGES = [0, -0.0, 1, -1, 2, -3, 32767, -32768, 7, -100]


def inputs(shape, sym_dtype, seed):
    b, n, c = shape
    rng = np.random.default_rng(seed)
    sym = np.rint(rng.laplace(0, 30, shape))
    sym[0, :len(EDGES), 0] = EDGES
    compute = np.float64 if sym_dtype == np.float64 else np.float32
    div = (np.exp(rng.standard_normal((b, c, n)) * 2.0) * 0.1).astype(compute)
    div[:, :, -n // 16:] = 0.0
    return sym.astype(sym_dtype), div, compute


def ulp_distance(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in float32 ulps (as ordered integers)."""
    def ordered(x):
        i = x.view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(ordered(a) - ordered(b)).max())


@pytest.mark.parametrize("with_div", [True, False])
@pytest.mark.parametrize("sym_dtype", [np.int16, np.float32, np.float64])
@pytest.mark.parametrize("shape", SHAPES)
def test_dequant_plain_against_the_jax_chain(shape, sym_dtype, with_div):
    sym, div, compute = inputs(shape, sym_dtype, sum(shape))
    factor = 2.0 ** 15
    d_t = torch.from_numpy(div) if with_div else None
    got = kernels.dequant_plain(torch.from_numpy(sym), d_t, factor)
    assert got.shape == (shape[0], shape[2], shape[1])
    assert got.dtype == (torch.float64 if compute == np.float64 else torch.float32)
    # the wrapper on CPU tensors is the plain version, bit for bit
    again = kernels.dequant(torch.from_numpy(sym), d_t, factor)
    assert torch.equal(got, again) and kernels.dequant.launches == 0

    x = jnp.swapaxes(jnp.asarray(sym.astype(compute)), 1, 2)
    want = jpsycho.dequant_jnp(x) / jnp.asarray(factor, compute)
    if with_div:
        want = want * jnp.asarray(div)
    want = np.asarray(want)
    assert want.dtype == compute
    if compute == np.float64:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)
    else:
        assert ulp_distance(got.numpy(), want) <= 2
    # signs, zeros and the int16 extremes
    g = got.numpy()[0, 0, :len(EDGES)]
    if with_div:
        g = g / div[0, 0, :len(EDGES)]
    np.testing.assert_allclose(
        g, np.sign(EDGES) * np.abs(np.array(EDGES, dtype=np.float64)) ** (4 / 3) / factor,
        rtol=1e-5)
    assert g[0] == 0 and g[1] == 0 and not np.signbit(g[:2]).any()


def test_dequant_refuses_what_the_kernel_does_not_take():
    sym = torch.zeros((2, 8, 2), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError):
        kernels.dequant(sym, None, 2.0)
    with pytest.raises(ValueError):
        kernels.dequant(torch.zeros((2, 8, 2), dtype=torch.int16),
                        torch.zeros((2, 2, 8), device="meta"), 2.0)


def former_p1_decode_core(freqs_flat, thres_flat, srate, factor):
    """`p1_decode_core` as it stood before the `dequant` kernel."""
    if freqs_flat.dtype == torch.int16:
        freqs_flat = freqs_flat.to(torch.float32)
    n = freqs_flat.shape[1]
    masked = tpsycho.dequant(freqs_flat.transpose(1, 2)) / factor
    return idct2(masked * tbatch._thres_expand(thres_flat, n, srate)).transpose(1, 2)


def former_p2_decode_core(freqs_flat, thres_flat, lpc_flat, srate, factor):
    """`p2_decode_core` as it stood before the `dequant` kernel."""
    if freqs_flat.dtype == torch.int16:
        freqs_flat = freqs_flat.to(torch.float32)
    n = freqs_flat.shape[1]
    masked = tpsycho.dequant(freqs_flat.transpose(1, 2)) / factor
    freqs = ttns.tns_synthesis(masked, lpc_flat.transpose(1, 2)) \
        * tbatch._thres_expand(thres_flat, n, srate)
    return idct2(freqs).transpose(1, 2)


@pytest.mark.parametrize("sym_dtype", [np.int16, np.float32, np.float64])
@pytest.mark.parametrize("shape,srate", [((3, 256, 2), 44100), ((2, 512, 1), 48000),
                                         ((1, 1024, 3), 32000)])
def test_decode_cores_unchanged(shape, srate, sym_dtype):
    b, n, c = shape
    rng = np.random.default_rng(n + c)
    compute = np.float64 if sym_dtype == np.float64 else np.float32
    fq = torch.from_numpy(np.rint(rng.laplace(0, 10, shape)).astype(sym_dtype))
    tq = torch.from_numpy(rng.integers(0, 30, (b, 27, c)).astype(compute))
    factor = 2.0 ** 15
    got = tbatch.p1_decode_core(fq, tq, srate, factor)
    want = former_p1_decode_core(fq, tq, srate, factor)
    assert got.shape == (b, n, c) and got.dtype == want.dtype
    assert torch.equal(got, want)

    lpc = np.zeros((b, 13, c))
    lpc[:, 0] = 15.0
    lpc[0, 1:4, 0] = [-6, 3, -1]              # one active TNS lane, the rest bypass
    lpc = torch.from_numpy(lpc.astype(compute))
    got2 = tbatch.p2_decode_core(fq, tq, lpc, srate, factor)
    want2 = former_p2_decode_core(fq, tq, lpc, srate, factor)
    assert torch.equal(got2, want2)
    assert not torch.equal(got2[0, :, 0], got[0, :, 0])
