"""`tns_iir`: Profile 2's TNS synthesis filter, an order-12 all-pole IIR.

The port of the XLA device program `_iir` (frad_python_tpu/ops/
tns_jax.py, a `lax.scan` over time): y[t] = x[t] - sum_{j=1..12}
c[j] * y[t-j] per lane. `tns_iir` launches the CUDA kernel
(csrc/tns_iir.cu) for CUDA tensors and runs `tns_iir_plain` for CPU
tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

MAX_ORDER = 12


def tns_iir_plain(x: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """x [L, N], coeffs [L, 13] -> y [L, N], a Python loop over time.

    The order of each step's sum is fixed (the kernel copies it): the 12
    products, then acc = +0 and the adds j = 12, 11, .. 1 (the oldest
    output first), then x[t] - acc. Only c[1] * y[t-1], the last add and
    the subtract then wait for the step before, which is what lets the
    kernel run ahead. A lane with coefficients [1, 0, ...] returns x bit
    for bit. The JAX scan leaves the order of its sum to XLA, so the two
    agree to a tolerance, not exactly."""
    lanes, n = x.shape
    # y with 12 leading zeros: the window y[t-12 .. t-1] is buf[:, t : t+12]
    buf = torch.zeros((lanes, n + MAX_ORDER), dtype=x.dtype, device=x.device)
    a_rev = coeffs[:, 1:].flip(-1).contiguous()       # a_rev[:, k] = c[12 - k]
    for t in range(n):
        p = a_rev * buf[:, t:t + MAX_ORDER]           # p[:, 12 - j] = c[j] * y[t-j]
        acc = torch.zeros_like(p[:, 0])
        for j in range(MAX_ORDER, 0, -1):
            acc = acc + p[:, MAX_ORDER - j]
        buf[:, t + MAX_ORDER] = x[:, t] - acc
    return buf[:, MAX_ORDER:].contiguous()


def tns_iir(x: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """x [L, N] and coeffs [L, 13], float32 or float64 -> y [L, N]; one
    kernel launch for CUDA tensors."""
    if x.device.type == "cpu" and coeffs.device.type == "cpu":
        return tns_iir_plain(x, coeffs)
    if x.device.type != "cuda" or coeffs.device != x.device:
        raise ValueError(f"tns_iir: tensors on {x.device} and {coeffs.device}")
    if x.dtype not in (torch.float32, torch.float64) or coeffs.dtype != x.dtype:
        raise TypeError(f"tns_iir: float32 or float64 inputs of one dtype required, got "
                        f"{x.dtype}, {coeffs.dtype}")
    if x.dim() != 2 or coeffs.shape != (x.shape[0], MAX_ORDER + 1):
        raise ValueError(f"tns_iir: x [L, N] and coeffs [L, {MAX_ORDER + 1}] required, got "
                         f"{tuple(x.shape)}, {tuple(coeffs.shape)}")
    if not (x.is_contiguous() and coeffs.is_contiguous()):
        raise ValueError("tns_iir: contiguous inputs required")
    y = torch.empty_like(x)
    lib = build.library()
    with build.on_device("tns_iir", x, coeffs) as stream:
        err = lib.frad_tns_iir(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(coeffs.data_ptr()),
            ctypes.c_void_p(y.data_ptr()), x.shape[0], x.shape[1],
            int(x.dtype == torch.float64),
            stream)
    build.check("frad_tns_iir", err)
    tns_iir.launches += 1
    return y


#: kernel launches since the last reset (CPU calls do not count)
tns_iir.launches = 0
