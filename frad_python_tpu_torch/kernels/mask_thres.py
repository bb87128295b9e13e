"""`mask_thres`: the lossy encoders' masking-threshold chain, between the
band-sum GEMM and the interpolation GEMM.

The port of the elementwise chain of the JAX package's XLA device
programs (frad_python_tpu/ops/psycho.py:mask_thres_mos_jnp after its
band-sum product, and the threshold symbols of frad_python_tpu/models/
batch.py:_p1_encode_jit and :_p2_encode_jit): band sums [R, nb'] ->
thresholds th [R, 27] = max(sqrt(sum / width)^0.8, AHT floor) * loss level
(zeros from band `nb` on), and their log-companded symbols
rint(sign * |log(max(th, 1)) / log(e/2)|^(4/3)) in the [B, 27, C] layout
the pipeline copies back. `mask_thres` launches the CUDA kernel
(csrc/mask_thres.cu) for CUDA tensors and runs `mask_thres_plain` for CPU
tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops import psycho
from . import build

E_HALF = np.e / 2.0
_EXPONENT = 1.0 / psycho.QUANT_ALPHA


def thres_quant_plain(thres: torch.Tensor) -> torch.Tensor:
    """Masking thresholds -> log-companded integer symbols (int64 at
    float64, else int32): the clamp at 1, the logarithm, an IEEE division
    by log(e/2) taken in the thresholds' dtype on their device, the
    4/3-power compand, the half-even rounding."""
    log_base = torch.log(torch.tensor(E_HALF, dtype=thres.dtype, device=thres.device))
    return torch.round(
        psycho.dequant(torch.log(torch.clamp(thres, min=1.0)) / log_base)
    ).to(torch.int64 if thres.dtype == torch.float64 else torch.int32)


def mask_thres_plain(sums: torch.Tensor, inv_w: torch.Tensor, aht: torch.Tensor, nb: int,
                     loss_level: float, channels: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Band sums [R, nb'] (R = frames * channels) with the per-band
    1 / width and AHT floor [nb'] -> (th [R, 27] in the sums' dtype,
    thres_q [R / channels, 27, channels])."""
    th = psycho.thres_from_sums(sums, inv_w, aht, nb, float(loss_level))
    tq = thres_quant_plain(th).reshape(-1, channels, psycho.SUBBANDS)
    return th, tq.transpose(1, 2).contiguous()


def mask_thres(sums: torch.Tensor, inv_w: torch.Tensor, aht: torch.Tensor, nb: int,
               loss_level: float, channels: int) -> tuple[torch.Tensor, torch.Tensor]:
    """See `mask_thres_plain`; one kernel launch for CUDA tensors."""
    if all(t.device.type == "cpu" for t in (sums, inv_w, aht)):
        return mask_thres_plain(sums, inv_w, aht, nb, loss_level, channels)
    if sums.device.type != "cuda" or inv_w.device != sums.device or aht.device != sums.device:
        raise ValueError(f"mask_thres: tensors on {sums.device}, {inv_w.device}, {aht.device}")
    if sums.dtype not in (torch.float32, torch.float64) or inv_w.dtype != sums.dtype \
            or aht.dtype != sums.dtype:
        raise TypeError(f"mask_thres: float32 or float64 of one kind required, got "
                        f"{sums.dtype}, {inv_w.dtype}, {aht.dtype}")
    if sums.dim() != 2 or not sums.is_contiguous():
        raise ValueError(f"mask_thres: contiguous [R, nb'] sums required, got "
                         f"{tuple(sums.shape)}")
    rows, nbp = sums.shape
    if inv_w.shape != (nbp,) or aht.shape != (nbp,) or not inv_w.is_contiguous() \
            or not aht.is_contiguous():
        raise ValueError(f"mask_thres: contiguous [{nbp}] band tables required, got "
                         f"{tuple(inv_w.shape)}, {tuple(aht.shape)}")
    if not 0 <= nb <= min(nbp, psycho.SUBBANDS) or channels < 1 or rows % channels:
        raise ValueError(f"mask_thres: nb={nb} of {nbp} bands, {rows} rows of {channels} "
                         f"channels")
    f64 = sums.dtype == torch.float64
    th = torch.empty((rows, psycho.SUBBANDS), dtype=sums.dtype, device=sums.device)
    tq = torch.empty((rows // channels, psycho.SUBBANDS, channels),
                     dtype=torch.int64 if f64 else torch.int32, device=sums.device)
    lib = build.library()
    err = lib.frad_mask_thres(
        ctypes.c_void_p(sums.data_ptr()), ctypes.c_void_p(inv_w.data_ptr()),
        ctypes.c_void_p(aht.data_ptr()), ctypes.c_void_p(th.data_ptr()),
        ctypes.c_void_p(tq.data_ptr()), rows, nbp, nb, channels, float(loss_level),
        psycho.SPREAD_ALPHA, _EXPONENT, E_HALF, int(f64),
        ctypes.c_void_p(torch.cuda.current_stream(sums.device).cuda_stream))
    build.check("frad_mask_thres", err)
    mask_thres.launches += 1
    return th, tq


#: kernel launches since the last reset (CPU calls do not count)
mask_thres.launches = 0
