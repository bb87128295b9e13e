"""Batched Temporal Noise Shaping (Profile 2's tensor domain), as torch ops
on one device: the counterpart of the JAX package's `ops/tns_jax.py`.

Over [..., N] spectra, one lane per (frame, channel), float32 or float64:

* autocorrelation lags 0..12 as 13 shifted reductions
* Levinson-Durbin: the `tns_levinson` kernel
* analysis FIR as 13 shifted multiply-adds
* synthesis IIR: the `tns_iir` kernel
* every bypass gate of the reference (spectral flatness, energy, tiny
  coefficients, blow-up, prediction gain) as a per-lane mask that selects
  the passthrough.

The gates are thresholds on float reductions, and a torch reduction sums
in another order than XLA's: a lane that sits on a gate can decide
differently from the JAX package (and then its whole frame's symbols
differ). The tests count such lanes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.tns_iir import tns_iir
from ..kernels.tns_levinson import tns_levinson
from .psycho import sqrt_rn

MAX_ORDER = 12
COEF_RES = 4
MIN_PRED = 0.030102999566398118  # log10(2)/10


@functools.lru_cache(maxsize=8)
def _lag_window(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """exp(-0.5 * (0.01 l)^2) for l = 0..12, computed in `dtype`."""
    ft = np.float64 if dtype == torch.float64 else np.float32
    w = np.exp(ft(-0.5) * (np.arange(MAX_ORDER + 1, dtype=ft) * ft(0.01)) ** 2)
    return torch.from_numpy(w.astype(ft)).to(device)


def _autocorr(x: torch.Tensor) -> torch.Tensor:
    """[..., N] -> [..., 13] windowed, normalised autocorrelation."""
    n = x.shape[-1]
    sig = x - x.mean(dim=-1, keepdim=True)
    norm = sqrt_rn((sig * sig).sum(dim=-1, keepdim=True))
    sig = torch.where(norm > 1e-6, sig / torch.where(norm == 0, 1.0, norm), sig)
    lags = [(sig[..., : n - l] * sig[..., l:]).sum(dim=-1) for l in range(MAX_ORDER + 1)]
    return torch.stack(lags, dim=-1) * _lag_window(x.dtype, x.device)


def _levinson(ac: torch.Tensor) -> torch.Tensor:
    """[..., 13] autocorrelation -> [..., 13] LPC (the `tns_levinson` kernel)."""
    return tns_levinson(ac.reshape(-1, MAX_ORDER + 1).contiguous()).reshape(ac.shape)


def _quantise(lpc: torch.Tensor) -> torch.Tensor:
    scale = (1 << COEF_RES) - 1
    q = torch.round(torch.clamp(lpc[..., 1:] * scale, -scale, scale - 1))
    return torch.cat([torch.zeros_like(lpc[..., :1]), q], dim=-1)


def _dequantise(lpc_q: torch.Tensor) -> torch.Tensor:
    scale = (1 << COEF_RES) - 1
    deq = lpc_q / scale
    deq[..., 0] = 1.0
    return deq


def _fir(x: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """Causal FIR: y[t] = sum_j c[..., j] * x[..., t-j] (13 taps)."""
    y = coeffs[..., 0:1] * x
    for j in range(1, MAX_ORDER + 1):
        y = y + coeffs[..., j:j + 1] * F.pad(x[..., :-j], (j, 0))
    return y


def _iir(x: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """All-pole IIR: y[t] = x[t] - sum_{j>=1} c[..., j] * y[t-j] (the
    `tns_iir` kernel over the flattened lanes)."""
    y = tns_iir(x.reshape(-1, x.shape[-1]).contiguous(),
                coeffs.reshape(-1, MAX_ORDER + 1).contiguous())
    return y.reshape(x.shape)


def _flatness_gate(freqs: torch.Tensor) -> torch.Tensor:
    """Spectral-flatness gate: True = run TNS."""
    mag = torch.abs(freqs)
    geo = torch.exp(torch.log(mag + 1e-10).mean(dim=-1))
    ari = mag.mean(dim=-1)
    return geo / (ari + 1e-10) < 0.5


def _predgain(orig: torch.Tensor, resid: torch.Tensor) -> torch.Tensor:
    oc = orig - orig.mean(dim=-1, keepdim=True)
    rc = resid - resid.mean(dim=-1, keepdim=True)
    oe = (oc * oc).sum(dim=-1)
    re = (rc * rc).sum(dim=-1)
    gain = 20.0 * torch.log10(torch.where(re == 0, 1.0, oe / torch.where(re == 0, 1.0, re)))
    return torch.where((oe < 1e-10) | (re < 1e-10) | (re >= oe), 0.0, gain)


def tns_analysis(freqs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., N] -> (residual, quantised LPC [..., 13]); bypassed lanes
    return (freqs, zeros)."""
    n = freqs.shape[-1]
    if n >= MAX_ORDER * 2:
        run = _flatness_gate(freqs)
    else:
        run = torch.zeros(freqs.shape[:-1], dtype=torch.bool, device=freqs.device)
    run = run & ((freqs * freqs).sum(dim=-1) >= 1e-10)

    lpc = _levinson(_autocorr(freqs))
    run = run & (torch.abs(lpc[..., 1:]).sum(dim=-1) >= 0.01)
    lpc_q = _quantise(lpc)
    run = run & (lpc_q[..., 1:] != 0).any(dim=-1)
    lpc_deq = _dequantise(lpc_q)

    resid = _fir(freqs, lpc_deq)
    finite = torch.isfinite(resid).all(dim=-1) & (torch.abs(resid).amax(dim=-1) <= 1e6)
    run = run & finite
    run = run & (_predgain(freqs, resid) >= MIN_PRED)

    out = torch.where(run[..., None], resid, freqs)
    lpc_out = torch.where(run[..., None], lpc_q, torch.zeros_like(lpc_q))
    return out, lpc_out


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
