"""`dequant`: the lossy decoders' dequantiser, written in the inverse
DCT's layout, with Profile 1's threshold expansion folded in.

The port of the pre-IDCT chain of the JAX package's XLA device programs
(frad_python_tpu/models/batch.py:_p1_decode_jit and :_p2_decode_jit):
sign(x)|x|^(4/3) / factor, times the per-bin divisor that Profile 1's
threshold symbols give (the arithmetic of `thres_expand`, computed in the
same launch and never stored); Profile 2 runs its TNS synthesis before the
multiply, so it passes no thresholds and multiplies by `thres_expand`'s
divisor itself. `dequant` launches the CUDA kernel (csrc/dequant.cu) for
CUDA tensors and runs `dequant_plain` for CPU tensors.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..ops import psycho
from . import build
from .mask_thres import E_HALF
from .thres_expand import thres_expand_plain

_EXPONENT = 1.0 / psycho.QUANT_ALPHA
_SYM_KINDS = {torch.int16: 0, torch.float32: 1, torch.float64: 2}


def _compute_dtype(symbols: torch.Tensor) -> torch.dtype:
    """int16 symbols (an exact upload of small EGR symbols) compute at
    float32, float symbols in their own dtype."""
    return torch.float32 if symbols.dtype == torch.int16 else symbols.dtype


def dequant_plain(symbols: torch.Tensor, thres_flat: torch.Tensor | None, factor: float,
                  srate: int = 0) -> torch.Tensor:
    """[B, N, C] symbols (int16, float32 or float64) and threshold symbols
    [B, 27, C] in the compute dtype, or None -> sign(x)|x|^(4/3) / factor,
    times `thres_expand_plain(thres_flat, N, srate)` when given, as
    [B, C, N] in the compute dtype: the power, the division, the multiply,
    in that order. The result keeps the strides torch gives a transposed
    view's product (the kernel's is contiguous): the values are the same."""
    x = symbols.to(_compute_dtype(symbols)).transpose(1, 2)
    out = psycho.dequant(x) / factor
    if thres_flat is None:
        return out
    return out * thres_expand_plain(thres_flat, symbols.shape[1], srate)


def _check(symbols: torch.Tensor, thres_flat: torch.Tensor | None, factor: float) -> None:
    """Refuse what the kernel does not take, on any device. The factor is a
    power of two from 1 to 2^126 (the codec's are 2^(bits - 1)): its
    reciprocal is exact at float32, so the kernel's product with it rounds
    as the plain version's division does."""
    if not (math.frexp(factor)[0] == 0.5 and 1.0 <= factor <= 2.0 ** 126):
        raise ValueError(f"dequant: a factor that is a power of two from 1 to 2^126 "
                         f"required, got {factor}")
    if symbols.dtype not in _SYM_KINDS or (
            thres_flat is not None and thres_flat.dtype != _compute_dtype(symbols)):
        raise TypeError(f"dequant: int16, float32 or float64 symbols and threshold symbols of "
                        f"the compute dtype required, got {symbols.dtype}, "
                        f"{None if thres_flat is None else thres_flat.dtype}")
    if symbols.dim() != 3:
        raise ValueError(f"dequant: [B, N, C] symbols required, got {tuple(symbols.shape)}")
    b, _, c = symbols.shape
    if thres_flat is not None and thres_flat.shape != (b, psycho.SUBBANDS, c):
        raise ValueError(f"dequant: [{b}, {psycho.SUBBANDS}, {c}] threshold symbols required, "
                         f"got {tuple(thres_flat.shape)}")


def dequant(symbols: torch.Tensor, thres_flat: torch.Tensor | None, factor: float,
            srate: int = 0) -> torch.Tensor:
    """See `dequant_plain`; one kernel launch for CUDA tensors. The kernel
    scales by 1 / factor, as torch divides a CUDA tensor by a Python
    number: for the powers of two that `_check` lets through, exact, so the
    bits of a division."""
    _check(symbols, thres_flat, factor)
    if symbols.device.type == "cpu" and (thres_flat is None or thres_flat.device.type == "cpu"):
        return dequant_plain(symbols, thres_flat, factor, srate)
    if symbols.device.type != "cuda" or (
            thres_flat is not None and thres_flat.device != symbols.device):
        raise ValueError(f"dequant: tensors on {symbols.device} and "
                         f"{None if thres_flat is None else thres_flat.device}")
    if not symbols.is_contiguous() or (thres_flat is not None and not thres_flat.is_contiguous()):
        raise ValueError("dequant: contiguous symbols and threshold symbols required")
    b, n, c = symbols.shape
    dtype = _compute_dtype(symbols)
    out = torch.empty((b, c, n), dtype=dtype, device=symbols.device)
    if thres_flat is None:
        tables = (None, None, None)
    else:
        k = psycho.device_consts(n, srate, symbols.device, dtype)
        tables = tuple(ctypes.c_void_p(k[t].data_ptr()) for t in ("band8", "w_lo", "w_hi"))
    lib = build.library()
    with build.on_device("dequant", symbols, thres_flat) as stream:
        err = lib.frad_dequant(
            ctypes.c_void_p(symbols.data_ptr()),
            ctypes.c_void_p(thres_flat.data_ptr()) if thres_flat is not None else None,
            ctypes.c_void_p(out.data_ptr()), b, n, c, *tables, 1.0 / factor, _EXPONENT, E_HALF,
            _SYM_KINDS[symbols.dtype],
            stream)
    build.check("frad_dequant", err)
    dequant.launches += 1
    return out


#: kernel launches since the last reset (CPU calls do not count)
dequant.launches = 0
