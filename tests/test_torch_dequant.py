"""`dequant` (CPU: its plain version) against the JAX package's pre-IDCT
chain (`psycho.dequant_jnp(x) / factor`, times the divisor of
`mapping_from_opus_jnp((e/2) ** quant_jnp(thres))` for Profile 1:
`models/batch.py:_p1_decode_jit`), and the decode cores around it against
the lines they held before the kernel took the chain's place.

Tolerances: without thresholds, float64 within 1e-12 relative (two pow
implementations) and float32 within 2 ulp (XLA's and torch's powf each
within an ulp of the true power, then two roundings both make alike); with
them, the divisor's own tolerance against the JAX GEMM
(tests/test_torch_thres.py: 2e-6 relative at float32, 1e-13 at float64)
on top. The Profile 1 form against the composition of the divisor form it
replaced (the dequant, then `thres_expand_plain`'s divisor): exact. The
cores against their former lines: exact, the same operations in the same
order on the same machine."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from frad_python_tpu.ops import psycho as jpsycho
from frad_python_tpu_torch import kernels
from frad_python_tpu_torch.models import batch as tbatch
from frad_python_tpu_torch.models import profile1 as tprofile1
from frad_python_tpu_torch.ops import psycho as tpsycho
from frad_python_tpu_torch.ops import tns as ttns
from frad_python_tpu_torch.ops.dct import idct2

SHAPES = [(3, 256, 2), (2, 512, 1), (2, 128, 8), (1, 8192, 2), (1, 16384, 1)]
EDGES = [0, -0.0, 1, -1, 2, -3, 32767, -32768, 7, -100]
#: relative tolerance of the Profile 1 form against the JAX chain: the
#: divisor's (2e-6 / 1e-13) and the dequant's (2 float32 ulp / 1e-12)
P1_RTOL = {np.float32: 2e-6 + 2 * 2.0 ** -23, np.float64: 1e-13 + 1e-12}


def inputs(shape, sym_dtype, seed):
    """(symbols [B, N, C], threshold symbols [B, 27, C] in the compute
    dtype, the compute dtype): Laplace symbols with the edges in frame 0,
    threshold symbols of both signs with zeros."""
    b, n, c = shape
    rng = np.random.default_rng(seed)
    sym = np.rint(rng.laplace(0, 30, shape))
    sym[0, :len(EDGES), 0] = EDGES
    compute = np.float64 if sym_dtype == np.float64 else np.float32
    thres = np.rint(rng.laplace(0, 6, (b, 27, c)))
    thres[0, :4, 0] = (0, -0.0, 1, -1)
    return sym.astype(sym_dtype), thres.astype(compute), compute


def ulp_distance(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in float32 ulps (as ordered integers)."""
    def ordered(x):
        i = x.view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(ordered(a) - ordered(b)).max())


@pytest.mark.parametrize("srate", [44100, 48000, None])
@pytest.mark.parametrize("sym_dtype", [np.int16, np.float32, np.float64])
@pytest.mark.parametrize("shape", SHAPES)
def test_dequant_plain_against_the_jax_chain(shape, sym_dtype, srate):
    """srate None: Profile 2's form, no thresholds."""
    sym, thres, compute = inputs(shape, sym_dtype, sum(shape))
    b, n, c = shape
    factor = 2.0 ** 15
    s_t = torch.from_numpy(sym)
    t_t = torch.from_numpy(thres) if srate else None
    got = kernels.dequant_plain(s_t, t_t, factor, srate or 0)
    assert got.shape == (b, c, n)
    assert got.dtype == (torch.float64 if compute == np.float64 else torch.float32)
    # the wrapper on CPU tensors is the plain version, bit for bit
    kernels.reset_launches()
    again = kernels.dequant(s_t, t_t, factor, srate or 0)
    assert torch.equal(got, again) and kernels.dequant.launches == 0
    div = kernels.thres_expand_plain(torch.from_numpy(thres), n, srate) if srate else None
    if srate:
        # the composition it replaced: the dequant, then thres_expand's divisor
        former = tpsycho.dequant(s_t.to(got.dtype).transpose(1, 2)) / factor * div
        assert torch.equal(got, former)

    x = jnp.swapaxes(jnp.asarray(sym.astype(compute)), 1, 2)
    want = jpsycho.dequant_jnp(x) / jnp.asarray(factor, compute)
    if srate:
        e_half = jnp.asarray(np.e / 2.0, dtype=compute)
        th = jnp.power(e_half, jpsycho.quant_jnp(jnp.swapaxes(jnp.asarray(thres), 1, 2)))
        want = want * jpsycho.mapping_from_opus_jnp(th, n, srate)
    want = np.asarray(want)
    assert want.dtype == compute
    if srate:
        np.testing.assert_allclose(got.numpy(), want, rtol=P1_RTOL[compute], atol=0)
        assert (want == 0).any() and (want != 0).mean() > 0.5
    elif compute == np.float64:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)
    else:
        assert ulp_distance(got.numpy(), want) <= 2
    # signs, zeros and the int16 extremes
    g = got.numpy()[0, 0, :len(EDGES)]
    if srate:
        g = g / div.numpy()[0, 0, :len(EDGES)]
    np.testing.assert_allclose(
        g, np.sign(EDGES) * np.abs(np.array(EDGES, dtype=np.float64)) ** (4 / 3) / factor,
        rtol=1e-5)
    assert g[0] == 0 and g[1] == 0 and not np.signbit(g[:2]).any()


def test_dequant_refuses_what_the_kernel_does_not_take():
    kernels.reset_launches()
    sym = torch.zeros((2, 8, 2), dtype=torch.int16)
    thres = torch.zeros((2, 27, 2))
    with pytest.raises(ValueError):                          # symbols on no card
        kernels.dequant(sym.to("meta"), None, 2.0)
    with pytest.raises(ValueError):
        kernels.dequant(sym.to("meta"), thres.to("meta"), 2.0, 44100)
    with pytest.raises(ValueError):                          # thresholds elsewhere
        kernels.dequant(sym, thres.to("meta"), 2.0, 44100)
    with pytest.raises(ValueError):                          # [B, 26, C], [B, 27, 1]
        kernels.dequant(sym, thres[:, 1:], 2.0, 44100)
    with pytest.raises(ValueError):
        kernels.dequant(sym, thres[..., :1], 2.0, 44100)
    with pytest.raises(ValueError):                          # [B, N] symbols
        kernels.dequant(sym[..., 0], None, 2.0)
    with pytest.raises(TypeError):                           # not the compute dtype
        kernels.dequant(sym, thres.double(), 2.0, 44100)
    with pytest.raises(TypeError):
        kernels.dequant(sym.to(torch.int32), None, 2.0)
    # factors whose reciprocal is not exact, or not a factor at all: the
    # kernel's product would not round as the plain version's division
    for factor in (3.0, 2.0 ** 15 + 1, 0.5, 2.0 ** 127, 0.0, -2.0, float("inf"), float("nan")):
        with pytest.raises(ValueError, match="power of two"):
            kernels.dequant(sym, thres, factor, 44100)
        with pytest.raises(ValueError, match="power of two"):
            kernels.dequant(sym.to("meta"), None, factor)
    assert kernels.dequant.launches == 0


def test_scale_by_the_reciprocal():
    """The kernel multiplies by 1 / factor where the plain version divides
    by factor (on the CPU): for the codec's factors 2^(bits - 1) the two
    round alike, subnormal results included, at float32 and float64."""
    rng = np.random.default_rng(11)
    for np_dtype, it in ((np.float32, torch.int32), (np.float64, torch.int64)):
        tiny = np.finfo(np_dtype).tiny
        x = np.concatenate([rng.standard_normal(4096) * 10.0 ** rng.uniform(-30, 30, 4096),
                            [tiny, tiny * 3.5, 0.0, -0.0, 1.0]]).astype(np_dtype)
        for bits in tprofile1.DEPTHS:
            factor = tprofile1._scale_factor(bits)
            quo = torch.from_numpy(x) / factor
            prod = torch.from_numpy(x) * torch.tensor(1.0 / factor, dtype=quo.dtype)
            assert torch.equal(quo.view(it), prod.view(it)), (np_dtype, bits)


def kernel_path(symbols: torch.Tensor, with_thres: bool) -> tuple:
    """The path of csrc/dequant.cu that the C entry `frad_dequant` picks
    for `symbols` [B, N, C]: (symbol dtype, with thresholds, channel path:
    1, 2 or 0 for any count, 16-byte vectors or element-wise). The output
    and the device tables are fresh allocations, 16-byte aligned."""
    _, n, c = symbols.shape
    v = 2 if symbols.dtype == torch.float64 else 4
    vec = n % v == 0 and symbols.data_ptr() % 16 == 0
    return symbols.dtype, with_thres, c if c in (1, 2) else 0, vec


def test_chip_smoke_dequant_forms_reach_every_kernel_path():
    """chip_smoke.py holds the kernel at DEQUANT_FORMS and at
    DEQUANT_EDGE_FORMS (each of these with and without threshold symbols,
    and also on `offset_view` copies): together every symbol dtype, with
    and without thresholds, reaches the C = 1, C = 2 and any-channel paths,
    each with 16-byte vectors and element-wise."""
    rng = np.random.default_rng(0)
    paths = set()
    for dtype, shape, with_thres in chip_smoke.DEQUANT_FORMS:
        sym, _ = chip_smoke.dequant_inputs(torch, rng, dtype, shape, "cpu")
        paths.add(kernel_path(sym, with_thres))
    for dtype, shape in chip_smoke.DEQUANT_EDGE_FORMS:
        sym, thres = chip_smoke.dequant_inputs(torch, rng, dtype, shape, "cpu")
        shifted = chip_smoke.offset_view(torch, sym)
        assert shifted.is_contiguous() and torch.equal(shifted, sym)
        assert chip_smoke.offset_view(torch, thres).is_contiguous()
        for x, with_thres in itertools.product((sym, shifted), (True, False)):
            paths.add(kernel_path(x, with_thres))
    want = set(itertools.product((torch.int16, torch.float32, torch.float64), (True, False),
                                 (1, 2, 0), (True, False)))
    assert paths == want, sorted(map(str, want - paths))


def former_p1_decode_core(freqs_flat, thres_flat, srate, factor):
    """`p1_decode_core` as it stood before the `dequant` kernel."""
    if freqs_flat.dtype == torch.int16:
        freqs_flat = freqs_flat.to(torch.float32)
    n = freqs_flat.shape[1]
    masked = tpsycho.dequant(freqs_flat.transpose(1, 2)) / factor
    return idct2(masked * kernels.thres_expand(thres_flat.contiguous(), n, srate)).transpose(1, 2)


def former_p2_decode_core(freqs_flat, thres_flat, lpc_flat, srate, factor):
    """`p2_decode_core` as it stood before the `dequant` kernel."""
    if freqs_flat.dtype == torch.int16:
        freqs_flat = freqs_flat.to(torch.float32)
    n = freqs_flat.shape[1]
    masked = tpsycho.dequant(freqs_flat.transpose(1, 2)) / factor
    freqs = ttns.tns_synthesis(masked, lpc_flat.transpose(1, 2)) \
        * kernels.thres_expand(thres_flat.contiguous(), n, srate)
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
