"""`dequant`: the lossy decoders' dequantiser, written in the inverse
DCT's layout.

The port of the pre-IDCT chain of the JAX package's XLA device programs
(frad_python_tpu/models/batch.py:_p1_decode_jit and :_p2_decode_jit):
sign(x)|x|^(4/3) / factor, times the per-bin divisor for Profile 1;
Profile 2 runs its TNS synthesis before the multiply and passes no
divisor. `dequant` launches the CUDA kernel (csrc/dequant.cu) for CUDA
tensors and runs `dequant_plain` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import psycho
from . import build

_EXPONENT = 1.0 / psycho.QUANT_ALPHA
_SYM_KINDS = {(torch.int16, torch.float32): 0, (torch.float32, torch.float32): 1,
              (torch.float64, torch.float64): 2}


def _compute_dtype(symbols: torch.Tensor) -> torch.dtype:
    """int16 symbols (an exact upload of small EGR symbols) compute at
    float32, float symbols in their own dtype."""
    return torch.float32 if symbols.dtype == torch.int16 else symbols.dtype


def dequant_plain(symbols: torch.Tensor, div: torch.Tensor | None,
                  factor: float) -> torch.Tensor:
    """[B, N, C] symbols (int16, float32 or float64) and per-bin divisors
    [B, C, N] or None -> sign(x)|x|^(4/3) / factor * div as [B, C, N] in
    the compute dtype: the power, the division, the multiply, in that
    order. The result keeps the strides torch gives a transposed view's
    product (the kernel's is contiguous): the values are the same."""
    x = symbols.to(_compute_dtype(symbols)).transpose(1, 2)
    out = psycho.dequant(x) / factor
    return out if div is None else out * div


def dequant(symbols: torch.Tensor, div: torch.Tensor | None, factor: float) -> torch.Tensor:
    """See `dequant_plain`; one kernel launch for CUDA tensors."""
    if symbols.device.type == "cpu" and (div is None or div.device.type == "cpu"):
        return dequant_plain(symbols, div, factor)
    if symbols.device.type != "cuda" or (div is not None and div.device != symbols.device):
        raise ValueError(f"dequant: tensors on {symbols.device} and "
                         f"{None if div is None else div.device}")
    dtype = _compute_dtype(symbols)
    kind = _SYM_KINDS.get((symbols.dtype, dtype))
    if kind is None or (div is not None and div.dtype != dtype):
        raise TypeError(f"dequant: int16, float32 or float64 symbols and divisors of the "
                        f"compute dtype required, got {symbols.dtype}, "
                        f"{None if div is None else div.dtype}")
    if symbols.dim() != 3 or not symbols.is_contiguous():
        raise ValueError(f"dequant: contiguous [B, N, C] symbols required, got "
                         f"{tuple(symbols.shape)}")
    b, n, c = symbols.shape
    if div is not None and (div.shape != (b, c, n) or not div.is_contiguous()):
        raise ValueError(f"dequant: contiguous [{b}, {c}, {n}] divisors required, got "
                         f"{tuple(div.shape)}")
    out = torch.empty((b, c, n), dtype=dtype, device=symbols.device)
    lib = build.library()
    err = lib.frad_dequant(
        ctypes.c_void_p(symbols.data_ptr()),
        ctypes.c_void_p(div.data_ptr()) if div is not None else None,
        ctypes.c_void_p(out.data_ptr()), b, n, c, float(factor), _EXPONENT, kind,
        ctypes.c_void_p(torch.cuda.current_stream(symbols.device).cuda_stream))
    build.check("frad_dequant", err)
    dequant.launches += 1
    return out


#: kernel launches since the last reset (CPU calls do not count)
dequant.launches = 0
