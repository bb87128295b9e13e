"""`tns_fir_gate`: the back of Profile 2's TNS analysis: the Levinson
recursion, coefficient quantisation, the analysis FIR, the remaining gates
and the two selects.

The port of the XLA device programs `_levinson`, `_quantise`,
`_dequantise`, `_fir`, `_predgain` and the gates and selects of
`tns_analysis` in frad_python_tpu/ops/tns_jax.py: spectra x [L, N], the
autocorrelation ac [L, 13] and the gate [L] of `tns_autocorr` -> (out
[L, N], lpc_out [L, 13], run [L]): lpc = levinson(ac), q = rint(clip(15 *
lpc, -15, 14)), the residual of the 13-tap causal FIR with q / 15, and
run = gate, sum |lpc[1:]| >= 0.01, some q != 0, the residual finite with
max |r| <= 1e6, and a prediction gain of log10(2) / 10 dB or more; out =
run ? residual : x, lpc_out = run ? q : 0. `tns_fir_gate` launches the
CUDA kernel (csrc/tns_fir_gate.cu) for CUDA tensors and runs
`tns_fir_gate_plain` for CPU tensors; `fir_gate_plain` is the same after
the recursion, from the LPC. The sums follow `tns_autocorr.row_sum`'s
order.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build
from .tns_autocorr import _SMEM_MAX, row_mean, row_sum
from .tns_levinson import MAX_ORDER, _const, tns_levinson_plain

COEF_RES = 4
_SCALE = (1 << COEF_RES) - 1
MIN_PRED = 0.030102999566398118  # log10(2)/10
#: the kernel keeps a row (and its residual, where both fit) and ~120 values
#: more in shared memory, within a block's 227 KB
_SCRATCH = 128


def quantise(lpc: torch.Tensor) -> torch.Tensor:
    """[..., 13] LPC -> integer-valued coefficients, the first one 0."""
    q = torch.round(torch.clamp(lpc[..., 1:] * _SCALE, -_SCALE, _SCALE - 1))
    return torch.cat([torch.zeros_like(lpc[..., :1]), q], dim=-1)


def dequantise(lpc_q: torch.Tensor) -> torch.Tensor:
    """Quantised coefficients / 15 as an IEEE division (a division by a
    Python number is a multiplication by its reciprocal on a CUDA tensor),
    the first one 1."""
    deq = lpc_q / torch.full_like(lpc_q, _SCALE)
    deq[..., 0] = 1.0
    return deq


def fir_plain(x: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """Causal FIR: y[t] = sum_j c[..., j] * x[..., t-j] (13 taps), summed
    j ascending from c0 * x[t], products and sums unfused."""
    y = coeffs[..., 0:1] * x
    for j in range(1, MAX_ORDER + 1):
        y = y + coeffs[..., j:j + 1] * F.pad(x[..., :-j], (j, 0))
    return y


def predgain_plain(orig: torch.Tensor, resid: torch.Tensor) -> torch.Tensor:
    """Prediction gain in dB of the centred residual against the centred
    row; 0 for an energy under 1e-10 or a residual no smaller than the
    row."""
    n = orig.shape[-1]
    tiny = _const(1e-10, orig.dtype)
    oc = orig - row_mean(orig)[..., None]
    rc = resid - row_mean(resid)[..., None]
    oe = row_sum(oc * oc, n)
    re = row_sum(rc * rc, n)
    gain = 20.0 * torch.log10(torch.where(re == 0, 1.0, oe / torch.where(re == 0, 1.0, re)))
    return torch.where((oe < tiny) | (re < tiny) | (re >= oe), 0.0, gain)


def fir_gate_plain(x: torch.Tensor, lpc: torch.Tensor, gate: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[L, N] spectra, [L, 13] LPC, [L] bool -> (out [L, N], lpc_out
    [L, 13], run [L] bool): `tns_fir_gate_plain` after the recursion."""
    dt = x.dtype
    mag = torch.abs(lpc)
    total = mag[..., 1]
    for j in range(2, MAX_ORDER + 1):
        total = total + mag[..., j]
    run = gate & (total >= _const(0.01, dt))
    lpc_q = quantise(lpc)
    run = run & (lpc_q[..., 1:] != 0).any(dim=-1)

    resid = fir_plain(x, dequantise(lpc_q))
    run = run & torch.isfinite(resid).all(dim=-1) \
        & (torch.abs(resid).amax(dim=-1) <= _const(1e6, dt))
    run = run & (predgain_plain(x, resid) >= _const(MIN_PRED, dt))

    out = torch.where(run[..., None], resid, x)
    lpc_out = torch.where(run[..., None], lpc_q, torch.zeros_like(lpc_q))
    return out, lpc_out, run


def tns_fir_gate_plain(x: torch.Tensor, ac: torch.Tensor, gate: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[L, N] spectra, [L, 13] autocorrelation, [L] bool -> (out [L, N],
    lpc_out [L, 13], run [L] bool)."""
    return fir_gate_plain(x, tns_levinson_plain(ac), gate)


def tns_fir_gate(x: torch.Tensor, ac: torch.Tensor, gate: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """See `tns_fir_gate_plain`; one kernel launch for CUDA tensors."""
    if all(t.device.type == "cpu" for t in (x, ac, gate)):
        return tns_fir_gate_plain(x, ac, gate)
    if x.dim() != 2 or not x.is_contiguous() or x.shape[1] < 1:
        raise ValueError(f"tns_fir_gate: contiguous [L, N] required, got {tuple(x.shape)}")
    lanes, n = x.shape
    if ac.shape != (lanes, MAX_ORDER + 1) or not ac.is_contiguous() \
            or gate.shape != (lanes,) or not gate.is_contiguous():
        raise ValueError(f"tns_fir_gate: contiguous [{lanes}, {MAX_ORDER + 1}] ac and "
                         f"[{lanes}] gate required, got {tuple(ac.shape)}, {tuple(gate.shape)}")
    if x.device.type != "cuda" or ac.device != x.device or gate.device != x.device:
        raise ValueError(f"tns_fir_gate: tensors on {x.device}, {ac.device}, {gate.device}")
    if x.dtype not in (torch.float32, torch.float64) or ac.dtype != x.dtype \
            or gate.dtype != torch.bool:
        raise TypeError(f"tns_fir_gate: float32 or float64 rows and lags of one kind and a "
                        f"bool gate required, got {x.dtype}, {ac.dtype}, {gate.dtype}")
    if (n + _SCRATCH) * x.element_size() > _SMEM_MAX:
        raise ValueError(f"tns_fir_gate: a row of {n} {x.dtype} values exceeds a block's "
                         f"shared memory")
    out = torch.empty_like(x)
    lpc_out = torch.empty_like(ac)
    run = torch.empty_like(gate)
    lib = build.library()
    with build.on_device("tns_fir_gate", x, ac, gate) as stream:
        err = lib.frad_tns_fir_gate(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(ac.data_ptr()),
            ctypes.c_void_p(gate.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(lpc_out.data_ptr()), ctypes.c_void_p(run.data_ptr()), lanes, n,
            int(x.dtype == torch.float64),
            stream)
    build.check("frad_tns_fir_gate", err)
    tns_fir_gate.launches += 1
    return out, lpc_out, run


#: kernel launches since the last reset (CPU calls do not count)
tns_fir_gate.launches = 0
