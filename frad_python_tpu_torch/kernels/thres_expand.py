"""`thres_expand`: the lossy decoders' threshold chain, from the threshold
symbols to the per-bin divisor, in one launch.

The port of the head of the JAX package's XLA device programs
frad_python_tpu/models/batch.py:_p1_decode_jit and :_p2_decode_jit
(`(e/2) ** quant_jnp(thres)` and `mapping_from_opus_jnp`): threshold
symbols [B, 27, C] -> per-bin divisors [B, C, N]: each row's 27
thresholds (e/2)^(sign(t) * sqrt(|t| * sqrt(|t|))), then the two-term
interpolation of `mask_thres` (`interpolate_plain`: th[lo] * w_lo +
th[hi] * w_hi, 0 past band 25), with the same weights and roundings.

The interpolation is the port's own form: the JAX package runs a GEMM
against the [27, N] interpolation matrix, so divisors differ from its in
the last bits (float32 PCM within 2e-6, float64 within 1e-9), and a
non-finite threshold reaches only the bins whose two terms read it.
`thres_expand` launches the CUDA kernel (csrc/thres_expand.cu) for CUDA
tensors and runs `thres_expand_plain` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import psycho
from . import build
from .mask_thres import E_HALF, interpolate_plain


def expand_plain(thres_flat: torch.Tensor) -> torch.Tensor:
    """[B, 27, C] threshold symbols (float32 or float64) -> [B, C, 27]
    thresholds: the 3/4-power compand in its square-root form, then the
    power of e/2."""
    e_half = torch.tensor(E_HALF, dtype=thres_flat.dtype, device=thres_flat.device)
    return torch.pow(e_half, psycho.quant(thres_flat.transpose(1, 2)))


def thres_expand_plain(thres_flat: torch.Tensor, n: int, srate: int) -> torch.Tensor:
    """[B, 27, C] threshold symbols -> [B, C, n] per-bin divisors in their
    dtype: `expand_plain`, then `interpolate_plain`."""
    k = psycho.device_consts(n, srate, thres_flat.device, thres_flat.dtype)
    return interpolate_plain(expand_plain(thres_flat), k)


def thres_expand(thres_flat: torch.Tensor, n: int, srate: int) -> torch.Tensor:
    """See `thres_expand_plain`; one kernel launch for a CUDA tensor."""
    if thres_flat.device.type == "cpu":
        return thres_expand_plain(thres_flat, n, srate)
    if thres_flat.device.type != "cuda":
        raise ValueError(f"thres_expand: tensor on {thres_flat.device}")
    if thres_flat.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"thres_expand: float32 or float64 required, got {thres_flat.dtype}")
    if thres_flat.dim() != 3 or thres_flat.shape[1] != psycho.SUBBANDS \
            or not thres_flat.is_contiguous() or n < 1:
        raise ValueError(f"thres_expand: contiguous [B, {psycho.SUBBANDS}, C] symbols and "
                         f"n >= 1 required, got {tuple(thres_flat.shape)}, n={n}")
    b, _, c = thres_flat.shape
    k = psycho.device_consts(n, srate, thres_flat.device, thres_flat.dtype)
    out = torch.empty((b, c, n), dtype=thres_flat.dtype, device=thres_flat.device)
    lib = build.library()
    with build.on_device("thres_expand", thres_flat) as stream:
        err = lib.frad_thres_expand(
            ctypes.c_void_p(thres_flat.data_ptr()), ctypes.c_void_p(out.data_ptr()), b, c, n,
            *(ctypes.c_void_p(k[t].data_ptr()) for t in ("band8", "w_lo", "w_hi")), E_HALF,
            int(thres_flat.dtype == torch.float64),
            stream)
    build.check("frad_thres_expand", err)
    thres_expand.launches += 1
    return out


#: kernel launches since the last reset (CPU calls do not count)
thres_expand.launches = 0
