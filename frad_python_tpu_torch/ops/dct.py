"""Batched DCT-II / inverse DCT with scipy `norm='forward'` semantics,
as one GEMM against an [N, N] cosine matrix (float32, N <= 8192).

  forward:  X[k] = (1/N) * sum_t x[t] cos(pi k (2t+1) / (2N))
  inverse:  x[t] = X[0] + 2 * sum_{k>=1} X[k] cos(pi k (2t+1) / (2N))

The matrices are built on the host in float64 exactly as the JAX package
builds them, cast to float32 and uploaded once per (N, device): a 16 MB
copy over PCIe costs nothing next to a track. The GEMM is `torch.matmul`
at full float32 (no TF32, see `ops/policy.py`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

MATMUL_MAX_N = 8192


@functools.lru_cache(maxsize=16)
def _dct_matrices(n: int, dtype_name: str) -> tuple[np.ndarray, np.ndarray]:
    """(forward, inverse) DCT matrices. forward: X = x @ F; inverse: x = X @ G."""
    k = np.arange(n, dtype=np.float64)[:, None]
    t = np.arange(n, dtype=np.float64)[None, :]
    cos = np.cos(np.pi * k * (2.0 * t + 1.0) / (2.0 * n))
    fwd = (cos / n).T  # [t, k] so that x @ fwd -> X
    w = np.full((n, 1), 2.0)
    w[0, 0] = 1.0
    inv = w * cos  # [k, t] so that X @ inv -> x
    dt = np.dtype(dtype_name)
    return np.ascontiguousarray(fwd, dtype=dt), np.ascontiguousarray(inv, dtype=dt)


@functools.lru_cache(maxsize=16)
def device_matrices(n: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(forward, inverse) float32 DCT matrices on `device`, cached."""
    if n > MATMUL_MAX_N:
        raise NotImplementedError(
            f"frame size {n} > {MATMUL_MAX_N}: the FFT form of the DCT is "
            "not ported yet")
    fwd, inv = _dct_matrices(n, "float32")
    return (torch.from_numpy(fwd).to(device), torch.from_numpy(inv).to(device))


def matmul_rows(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, M] as ONE 2-D GEMM over all leading rows.

    torch.matmul runs a 3-D operand that is a transposed view (as the
    [B, C, N] view of [B, N, C] frames is) as a batched GEMM of B tiny
    [C, K] products; measured on an H100 at [689, 2, 2048] @ [2048, 2048]:
    4.5 ms, 2.5 TFLOP/s. Copying to contiguous rows first gives one GEMM."""
    return torch.matmul(x.reshape(-1, x.shape[-1]), w).reshape(*x.shape[:-1], w.shape[-1])


def dct2(x: torch.Tensor) -> torch.Tensor:
    """Forward-normalised DCT-II over the last axis of a float32 tensor."""
    fwd, _ = device_matrices(x.shape[-1], x.device)
    return matmul_rows(x, fwd)


def idct2(y: torch.Tensor) -> torch.Tensor:
    """Inverse of `dct2` over the last axis."""
    _, inv = device_matrices(y.shape[-1], y.device)
    return matmul_rows(y, inv)
