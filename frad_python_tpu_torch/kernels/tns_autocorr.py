"""`tns_autocorr`: the front of Profile 2's TNS analysis: the masking
divide, the windowed autocorrelation and the two gates on the spectrum.

The port of the XLA device programs `_autocorr`, `_flatness_gate` and the
energy gate of frad_python_tpu/ops/tns_jax.py (with the masked divide of
frad_python_tpu/models/batch.py:_p2_encode_jit in front): spectra [L, N]
and per-bin divisors [L, N] or None -> the divided spectra x [L, N], their
normalised autocorrelation lags 0..12 times the lag window, ac [L, 13],
and the gate [L]: spectral flatness under 0.5 and energy of 1e-10 or more,
false for rows shorter than 24. `tns_autocorr` launches the CUDA kernel
(csrc/tns_autocorr.cu) for CUDA tensors and runs `tns_autocorr_plain` for
CPU tensors.

The gates and the Levinson recursion's input are float sums, so the order
of every sum is part of the function. `row_sum` is that order, written
out: 256 running sums (sum t takes elements t, t + 256, t + 512, ... in
ascending order from +0, the row padded with +0), then a fixed tree over
them. Neither version calls a library reduction where a sum is taken.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..ops.psycho import sqrt_rn
from . import build
from .tns_levinson import MAX_ORDER, _const

#: running sums a row is cut into (two of the kernel's threads each)
SUM_T = 256
_WARP = 32
#: the kernel keeps a row and the warp sums of its 18 sums (19 slots) in
#: shared memory, within a block's 227 KB
_SMEM_MAX = 232448 - 64
_SCRATCH = (SUM_T // _WARP) * 19


def row_sum(v: torch.Tensor, n: int) -> torch.Tensor:
    """Sum over the last axis of v [..., m], m <= n, in the kernels' order.

    v is padded with +0 to ceil(n / 256) * 256 elements. Running sum t
    (0 <= t < 256) adds elements t, t + 256, ... in ascending order,
    starting from +0. The 256 sums are then added as a tree: within each
    group of 32 neighbours, p[i] += p[i + s] for s = 16, 8, 4, 2, 1 (a
    warp's shuffle reduction), and over the 8 group sums for s = 4, 2, 1."""
    steps = -(-n // SUM_T)
    v = F.pad(v, (0, steps * SUM_T - v.shape[-1]))
    v = v.reshape(v.shape[:-1] + (steps, SUM_T))
    acc = torch.zeros_like(v[..., 0, :])
    for i in range(steps):
        acc = acc + v[..., i, :]
    p = acc.reshape(acc.shape[:-1] + (SUM_T // _WARP, _WARP))
    s = _WARP // 2
    while s:
        p = p[..., :s] + p[..., s:2 * s]
        s //= 2
    p = p[..., 0]
    s = SUM_T // _WARP // 2
    while s:
        p = p[..., :s] + p[..., s:2 * s]
        s //= 2
    return p[..., 0]


def row_mean(v: torch.Tensor) -> torch.Tensor:
    """`row_sum` over the row's length, as an IEEE division (a division by
    a Python number is a multiplication by its reciprocal on a CUDA
    tensor)."""
    s = row_sum(v, v.shape[-1])
    return s / torch.full_like(s, v.shape[-1])


def masked_divide(freqs: torch.Tensor, div: torch.Tensor | None) -> torch.Tensor:
    """freqs / div with a divisor of 0 read as infinity (bins past the last
    active band come out 0); freqs itself without a divisor."""
    if div is None:
        return freqs
    return freqs / torch.where(div == 0, torch.inf, div)


def autocorr_plain(x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """[..., N] -> [..., 13]: lags 0..12 of the centred row, normalised
    where its norm exceeds 1e-6, times `window`."""
    n = x.shape[-1]
    sig = x - row_mean(x)[..., None]
    norm = sqrt_rn(row_sum(sig * sig, n))[..., None]
    sig = torch.where(norm > _const(1e-6, x.dtype),
                      sig / torch.where(norm == 0, 1.0, norm), sig)
    lags = [row_sum(sig[..., : n - l] * sig[..., l:], n) for l in range(MAX_ORDER + 1)]
    return torch.stack(lags, dim=-1) * window


def flatness_gate_plain(x: torch.Tensor) -> torch.Tensor:
    """Spectral-flatness gate: geometric over arithmetic mean of |x| under
    0.5 (True = run TNS)."""
    mag = torch.abs(x)
    geo = torch.exp(row_mean(torch.log(mag + _const(1e-10, x.dtype))))
    ari = row_mean(mag)
    return geo / (ari + _const(1e-10, x.dtype)) < 0.5


def tns_autocorr_plain(freqs: torch.Tensor, div: torch.Tensor | None, window: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[L, N] spectra, [L, N] divisors or None, [13] lag window -> (x
    [L, N], ac [L, 13], gate [L] bool)."""
    x = masked_divide(freqs, div)
    n = x.shape[-1]
    gate = flatness_gate_plain(x) if n >= MAX_ORDER * 2 else \
        torch.zeros(x.shape[:-1], dtype=torch.bool, device=x.device)
    gate = gate & (row_sum(x * x, n) >= _const(1e-10, x.dtype))
    return x, autocorr_plain(x, window), gate


def tns_autocorr(freqs: torch.Tensor, div: torch.Tensor | None, window: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """See `tns_autocorr_plain`; one kernel launch for CUDA tensors.
    Without a divisor the returned x is `freqs` itself."""
    tensors = [t for t in (freqs, div, window) if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return tns_autocorr_plain(freqs, div, window)
    if freqs.device.type != "cuda" or any(t.device != freqs.device for t in tensors):
        raise ValueError(f"tns_autocorr: tensors on {[str(t.device) for t in tensors]}")
    if freqs.dtype not in (torch.float32, torch.float64) \
            or any(t.dtype != freqs.dtype for t in tensors):
        raise TypeError(f"tns_autocorr: float32 or float64 of one kind required, got "
                        f"{[t.dtype for t in tensors]}")
    if freqs.dim() != 2 or not freqs.is_contiguous() or freqs.shape[1] < 1:
        raise ValueError(f"tns_autocorr: contiguous [L, N] required, got {tuple(freqs.shape)}")
    if div is not None and (div.shape != freqs.shape or not div.is_contiguous()):
        raise ValueError(f"tns_autocorr: contiguous {tuple(freqs.shape)} divisors required, "
                         f"got {tuple(div.shape)}")
    if window.shape != (MAX_ORDER + 1,) or not window.is_contiguous():
        raise ValueError(f"tns_autocorr: [{MAX_ORDER + 1}] window required, got "
                         f"{tuple(window.shape)}")
    lanes, n = freqs.shape
    if (n + _SCRATCH) * freqs.element_size() > _SMEM_MAX:
        raise ValueError(f"tns_autocorr: a row of {n} {freqs.dtype} values exceeds a block's "
                         f"shared memory")
    x = freqs if div is None else torch.empty_like(freqs)
    ac = torch.empty((lanes, MAX_ORDER + 1), dtype=freqs.dtype, device=freqs.device)
    gate = torch.empty((lanes,), dtype=torch.bool, device=freqs.device)
    lib = build.library()
    with build.on_device("tns_autocorr", freqs, div, window) as stream:
        err = lib.frad_tns_autocorr(
            ctypes.c_void_p(freqs.data_ptr()),
            ctypes.c_void_p(div.data_ptr()) if div is not None else None,
            ctypes.c_void_p(window.data_ptr()),
            ctypes.c_void_p(x.data_ptr()) if div is not None else None,
            ctypes.c_void_p(ac.data_ptr()), ctypes.c_void_p(gate.data_ptr()), lanes, n,
            int(freqs.dtype == torch.float64),
            stream)
    build.check("frad_tns_autocorr", err)
    tns_autocorr.launches += 1
    return x, ac, gate


#: kernel launches since the last reset (CPU calls do not count)
tns_autocorr.launches = 0
