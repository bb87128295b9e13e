"""Batched Temporal Noise Shaping (Profile 2's tensor domain) on one
device: the counterpart of the JAX package's `ops/tns_jax.py`.

Over [..., N] spectra, one lane per (frame, channel), float32 or float64.
The analysis is two kernels:

* `tns_autocorr`: the masking divide, autocorrelation lags 0..12 and the
  spectral-flatness and energy gates
* `tns_fir_gate`: Levinson-Durbin, coefficient quantisation, the analysis
  FIR, the tiny-coefficient, blow-up and prediction-gain gates, and the
  selects of the passthrough for bypassed lanes

and the synthesis IIR is the `tns_iir` kernel. On the CPU each runs its
plain PyTorch version; `_autocorr`, `_levinson`, `_fir`, `_flatness_gate`,
`_predgain`, `_quantise` and `_dequantise` are those plain pieces by their
JAX names.

The gates are thresholds on float sums, taken in the order the kernels fix
(`kernels/tns_autocorr.row_sum`), which is not XLA's: a lane that sits on
a gate can decide differently from the JAX package (and then its whole
frame's symbols differ). The tests count such lanes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels.tns_autocorr import autocorr_plain, tns_autocorr
from ..kernels.tns_fir_gate import tns_fir_gate
from ..kernels.tns_iir import tns_iir
# the plain pieces of the two analysis kernels, under the JAX module's names
from ..kernels.tns_autocorr import flatness_gate_plain as _flatness_gate  # noqa: F401
from ..kernels.tns_fir_gate import COEF_RES, MIN_PRED  # noqa: F401
from ..kernels.tns_fir_gate import dequantise as _dequantise
from ..kernels.tns_fir_gate import fir_plain as _fir  # noqa: F401
from ..kernels.tns_fir_gate import predgain_plain as _predgain  # noqa: F401
from ..kernels.tns_fir_gate import quantise as _quantise  # noqa: F401
from ..kernels.tns_levinson import MAX_ORDER, tns_levinson_plain


@functools.lru_cache(maxsize=16)
def _lag_window(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """exp(-0.5 * (0.01 l)^2) for l = 0..12, computed in `dtype`."""
    ft = np.float64 if dtype == torch.float64 else np.float32
    w = np.exp(ft(-0.5) * (np.arange(MAX_ORDER + 1, dtype=ft) * ft(0.01)) ** 2)
    return torch.from_numpy(w.astype(ft)).to(device)


def _autocorr(x: torch.Tensor) -> torch.Tensor:
    """[..., N] -> [..., 13] windowed, normalised autocorrelation."""
    return autocorr_plain(x, _lag_window(x.dtype, x.device))


def _levinson(ac: torch.Tensor) -> torch.Tensor:
    """[..., 13] autocorrelation -> [..., 13] LPC (the recursion at the
    front of the `tns_fir_gate` kernel, plain, over the flattened lanes)."""
    return tns_levinson_plain(ac.reshape(-1, MAX_ORDER + 1)).reshape(ac.shape)


def _iir(x: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """All-pole IIR: y[t] = x[t] - sum_{j>=1} c[..., j] * y[t-j] (the
    `tns_iir` kernel over the flattened lanes)."""
    y = tns_iir(x.reshape(-1, x.shape[-1]).contiguous(),
                coeffs.reshape(-1, MAX_ORDER + 1).contiguous())
    return y.reshape(x.shape)


def tns_analysis(freqs: torch.Tensor, div: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., N] spectra, divided first by the per-bin divisors `div`
    [..., N] where given (a divisor of 0 reads as infinity) -> (residual,
    quantised LPC [..., 13]); bypassed lanes return (the divided spectra,
    zeros). Two kernel launches on a CUDA tensor."""
    n = freqs.shape[-1]
    rows = freqs.reshape(-1, n).contiguous()
    div_rows = None if div is None else div.reshape(-1, n).contiguous()
    x, ac, gate = tns_autocorr(rows, div_rows, _lag_window(freqs.dtype, freqs.device))
    out, lpc_out, _ = tns_fir_gate(x, ac, gate)
    return out.reshape(freqs.shape), lpc_out.reshape(freqs.shape[:-1] + (MAX_ORDER + 1,))


def tns_synthesis(tns_freqs: torch.Tensor, lpc_q: torch.Tensor) -> torch.Tensor:
    """Inverse of `tns_analysis`: [..., N] residuals and [..., 13]
    quantised LPC -> spectra; a lane whose filter blows up passes through."""
    run = (lpc_q != 0).any(dim=-1)
    lpc_deq = _dequantise(lpc_q)
    unit = torch.zeros_like(lpc_deq)
    unit[..., 0] = 1.0
    filtered = _iir(tns_freqs, torch.where(run[..., None], lpc_deq, unit))
    good = torch.isfinite(filtered).all(dim=-1) & (torch.abs(filtered).amax(dim=-1) <= 1e6)
    return torch.where((run & good)[..., None], filtered, tns_freqs)
