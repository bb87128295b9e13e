"""`power_quant`: masked divide + power-law compand + round, to int32.

The port of the Pallas kernel `power_quant` (frad_python_tpu/research/
pallas_kernels.py), in the JAX product's sqrt form (`psycho.quant_jnp`).
`power_quant` launches the CUDA kernel (csrc/power_quant.cu) for CUDA
tensors and runs `power_quant_plain` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.psycho import quant
from . import build


def power_quant_plain(freqs: torch.Tensor, div: torch.Tensor, factor: float) -> torch.Tensor:
    """rint(quant(freqs / div * factor)) as int32; a bin with div == 0 is 0.

    Same operations in the same order as the JAX encode core: the zero
    divisor becomes inf, so the bin divides to 0."""
    d = torch.where(div == 0, torch.inf, div)
    return torch.round(quant((freqs / d) * factor)).to(torch.int32)


def power_quant(freqs: torch.Tensor, div: torch.Tensor, factor: float) -> torch.Tensor:
    """[R, N] float32 spectra and divisors -> [R, N] int32 symbols."""
    if freqs.device.type == "cpu" and div.device.type == "cpu":
        return power_quant_plain(freqs, div, factor)
    if freqs.device.type != "cuda" or div.device != freqs.device:
        raise ValueError(f"power_quant: tensors on {freqs.device} and {div.device}")
    if freqs.dtype != torch.float32 or div.dtype != torch.float32:
        raise TypeError(f"power_quant: float32 inputs required, got {freqs.dtype}, {div.dtype}")
    if freqs.dim() != 2 or freqs.shape != div.shape:
        raise ValueError(f"power_quant: equal [R, N] shapes required, got "
                         f"{tuple(freqs.shape)}, {tuple(div.shape)}")
    if not (freqs.is_contiguous() and div.is_contiguous()):
        raise ValueError("power_quant: contiguous inputs required")
    out = torch.empty(freqs.shape, dtype=torch.int32, device=freqs.device)
    lib = build.library()
    err = lib.frad_power_quant(
        ctypes.c_void_p(freqs.data_ptr()), ctypes.c_void_p(div.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), freqs.numel(), float(factor),
        ctypes.c_void_p(torch.cuda.current_stream(freqs.device).cuda_stream))
    build.check("frad_power_quant", err)
    power_quant.launches += 1
    return out


#: kernel launches since the last reset (CPU calls do not count)
power_quant.launches = 0
