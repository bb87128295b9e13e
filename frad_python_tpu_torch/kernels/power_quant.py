"""`power_quant`: masked divide + power-law compand + round, to integers.

The port of the Pallas kernel `power_quant` (frad_python_tpu/research/
pallas_kernels.py), in the JAX product's sqrt form (`psycho.quant_jnp`):
float32 spectra give int32 symbols, float64 spectra int64. Without a
divisor (`div=None`) it is Profile 2's epilogue, which divides before its
TNS analysis and compands the residual: rint(quant(x * factor)).
`power_quant` launches the CUDA kernel (csrc/power_quant.cu) for CUDA
tensors and runs `power_quant_plain` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.psycho import quant
from . import build


def _int_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.int64 if dtype == torch.float64 else torch.int32


def power_quant_plain(freqs: torch.Tensor, div: torch.Tensor | None,
                      factor: float) -> torch.Tensor:
    """rint(quant(freqs / div * factor)) as int32 (int64 for float64
    input); a bin with div == 0 is 0. `div=None`: rint(quant(freqs * factor)).

    Same operations in the same order as the JAX encode cores: the zero
    divisor becomes inf, so the bin divides to 0."""
    if div is not None:
        freqs = freqs / torch.where(div == 0, torch.inf, div)
    return torch.round(quant(freqs * factor)).to(_int_dtype(freqs.dtype))


def power_quant(freqs: torch.Tensor, div: torch.Tensor | None,
                factor: float) -> torch.Tensor:
    """[R, N] float32 (float64) spectra and divisors, or no divisors ->
    [R, N] int32 (int64) symbols."""
    if freqs.device.type == "cpu" and (div is None or div.device.type == "cpu"):
        return power_quant_plain(freqs, div, factor)
    if freqs.device.type != "cuda" or (div is not None and div.device != freqs.device):
        raise ValueError(f"power_quant: tensors on {freqs.device} and "
                         f"{None if div is None else div.device}")
    if freqs.dtype not in (torch.float32, torch.float64) or (
            div is not None and div.dtype != freqs.dtype):
        raise TypeError(f"power_quant: float32 or float64 inputs of one dtype required, got "
                        f"{freqs.dtype}, {None if div is None else div.dtype}")
    if freqs.dim() != 2 or (div is not None and freqs.shape != div.shape):
        raise ValueError(f"power_quant: equal [R, N] shapes required, got "
                         f"{tuple(freqs.shape)}, {None if div is None else tuple(div.shape)}")
    if not (freqs.is_contiguous() and (div is None or div.is_contiguous())):
        raise ValueError("power_quant: contiguous inputs required")
    out = torch.empty(freqs.shape, dtype=_int_dtype(freqs.dtype), device=freqs.device)
    lib = build.library()
    with build.on_device("power_quant", freqs, div) as stream:
        err = lib.frad_power_quant(
            ctypes.c_void_p(freqs.data_ptr()),
            ctypes.c_void_p(div.data_ptr()) if div is not None else None,
            ctypes.c_void_p(out.data_ptr()), freqs.numel(), float(factor),
            int(freqs.dtype == torch.float64),
            stream)
    build.check("frad_power_quant", err)
    power_quant.launches += 1
    return out


#: kernel launches since the last reset (CPU calls do not count)
power_quant.launches = 0
