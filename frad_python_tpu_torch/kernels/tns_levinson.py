"""Profile 2's order-12 Levinson-Durbin recursion, plain.

The port of the XLA device program `_levinson` (frad_python_tpu/ops/
tns_jax.py): autocorrelation lags [L, 13] -> LPC coefficients [L, 13],
with the reflection clamp at 0.96 and the reference's early exit emulated
by freezing converged lanes. On the card the recursion runs inside the
`tns_fir_gate` kernel (csrc/tns_levinson.cuh, one thread of each row's
block); `tns_levinson_plain` is its plain version and the front of
`tns_fir_gate_plain`.
"""

from __future__ import annotations

import numpy as np
import torch

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

