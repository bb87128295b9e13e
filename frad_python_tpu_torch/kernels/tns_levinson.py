"""`tns_levinson`: Profile 2's order-12 Levinson-Durbin recursion.

The port of the XLA device program `_levinson` (frad_python_tpu/ops/
tns_jax.py): autocorrelation lags [L, 13] -> LPC coefficients [L, 13],
with the reflection clamp at 0.96 and the reference's early exit emulated
by freezing converged lanes. `tns_levinson` launches the CUDA kernel
(csrc/tns_levinson.cu) for CUDA tensors and runs `tns_levinson_plain`
for CPU tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

MAX_ORDER = 12


def _const(value: float, dtype: torch.dtype) -> float:
    """`value` rounded to `dtype`, as a Python float: a threshold that
    compares alike whether the comparison runs in `dtype` or wider."""
    return float(np.float32(value)) if dtype == torch.float32 else float(value)


def tns_levinson_plain(ac: torch.Tensor) -> torch.Tensor:
    """[..., 13] autocorrelation -> [..., 13] LPC, unrolled over the order
    as masked vector steps (about 400 small ops): `acc` summed j ascending,
    one division, the clamp, the update, then the freeze."""
    dt = ac.dtype
    lim, dead_thr, stop_thr = _const(0.96, dt), _const(1e-10, dt), _const(1e-12, dt)
    lpc = torch.zeros_like(ac)
    lpc[..., 0] = 1.0
    error = ac[..., 0].clone()
    dead = error <= dead_thr
    frozen = dead.clone()

    for i in range(1, MAX_ORDER + 1):
        acc = torch.zeros_like(error)
        for j in range(i):
            acc = acc + lpc[..., j] * ac[..., i - j]
        safe_err = torch.where(error == 0, torch.ones_like(error), error)
        refl = -acc / safe_err
        refl = torch.where(refl >= lim, torch.full_like(refl, lim), refl)
        refl = torch.where(refl <= -lim, torch.full_like(refl, -lim), refl)

        upd = lpc.clone()
        upd[..., i] = refl
        for j in range(1, i):
            upd[..., j] = lpc[..., j] + refl * lpc[..., i - j]
        lpc = torch.where(frozen[..., None], lpc, upd)
        new_err = error * (1.0 - refl * refl)
        error = torch.where(frozen, error, new_err)
        frozen = frozen | (error <= stop_thr)

    unit = torch.zeros_like(lpc)
    unit[..., 0] = 1.0
    return torch.where(dead[..., None], unit, lpc)


def tns_levinson(ac: torch.Tensor) -> torch.Tensor:
    """[L, 13] float32 or float64 autocorrelation -> [L, 13] LPC; one
    kernel launch for a CUDA tensor."""
    if ac.device.type == "cpu":
        return tns_levinson_plain(ac)
    if ac.device.type != "cuda":
        raise ValueError(f"tns_levinson: tensor on {ac.device}")
    if ac.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"tns_levinson: float32 or float64 required, got {ac.dtype}")
    if ac.dim() != 2 or ac.shape[1] != MAX_ORDER + 1:
        raise ValueError(f"tns_levinson: [L, {MAX_ORDER + 1}] required, got {tuple(ac.shape)}")
    if not ac.is_contiguous():
        raise ValueError("tns_levinson: contiguous input required")
    out = torch.empty_like(ac)
    lib = build.library()
    err = lib.frad_tns_levinson(
        ctypes.c_void_p(ac.data_ptr()), ctypes.c_void_p(out.data_ptr()), ac.shape[0],
        int(ac.dtype == torch.float64),
        ctypes.c_void_p(torch.cuda.current_stream(ac.device).cuda_stream))
    build.check("frad_tns_levinson", err)
    tns_levinson.launches += 1
    return out


#: kernel launches since the last reset (CPU calls do not count)
tns_levinson.launches = 0
