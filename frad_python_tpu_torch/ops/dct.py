"""Batched DCT-II / inverse DCT with scipy `norm='forward'` semantics over
the last axis, in two forms:

  forward:  X[k] = (1/N) * sum_t x[t] cos(pi k (2t+1) / (2N))
  inverse:  x[t] = X[0] + 2 * sum_{k>=1} X[k] cos(pi k (2t+1) / (2N))

* **GEMM** (float32, N <= 8192): one `torch.matmul` against an [N, N]
  cosine matrix at full float32 (no TF32, see `ops/policy.py`), cut
  along the contraction above N = 2048 (see K_SPLIT_ABOVE). The
  matrices are built on the host in float64 exactly as the JAX package
  builds them, cast to float32 and uploaded once per (N, device): a 16 MB
  copy over PCIe costs nothing next to a track.
* **FFT** (all float64, and float32 above N = 8192): Makhoul's N-point
  algorithm, an even/odd reorder, one complex FFT (`torch.fft`, cuFFT on
  the card) and a twiddle; complex128 for float64, complex64 for float32.
  At float64 it is the archival transform of the 48- and 64-bit
  containers. The operations run in the JAX package's order
  (`_fft_dct2(x) / (2n)`, `_fft_idct2(y * 2n)`), so float64 results agree
  with it to the last bits of the FFT.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import policy

MATMUL_MAX_N = 8192

#: cuBLAS's float32 GEMM sums a contraction in one pass, and its error
#: grows with the length: on an H100 the DCT GEMM at N = 8192 costs a
#: 24-bit lossless decode ~0.1 dB of SNR against the CPU's GEMM (PERF.md).
#: A DCT longer than K_SPLIT_ABOVE runs as K_CHUNK-long GEMMs accumulated
#: in float32 (`matmul_rows_chunked`), on every device.
K_SPLIT_ABOVE, K_CHUNK = 2048, 1024


def use_matmul(n: int, dtype: torch.dtype) -> bool:
    """The GEMM form for float32 up to the matrix cap, the FFT form otherwise."""
    return n <= MATMUL_MAX_N and dtype != torch.float64


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


def device_matrices(n: int, device: str | torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(forward, inverse) float32 DCT matrices on `device`, cached once per
    (N, card): 'cuda' and 'cuda:k' of the current card share an entry."""
    return _device_matrices(n, policy.device_key(device))


#: room for every transform length a run uses, on four cards
@functools.lru_cache(maxsize=64)
def _device_matrices(n: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    fwd, inv = _dct_matrices(n, "float32")
    return (torch.from_numpy(fwd).to(device), torch.from_numpy(inv).to(device))


def _twiddle(n: int, dtype: torch.dtype, sign: float, device: torch.device) -> torch.Tensor:
    """exp(sign * i*pi*k/(2n)), built in complex128 on the host and cast
    to the complex type of `dtype` (complex64 for float32); cached per
    card as `device_matrices` is."""
    return _twiddle_on(n, dtype, sign, policy.device_key(device))


@functools.lru_cache(maxsize=128)
def _twiddle_on(n: int, dtype: torch.dtype, sign: float, device: torch.device) -> torch.Tensor:
    cdt = torch.complex64 if dtype == torch.float32 else torch.complex128
    k = np.arange(n, dtype=np.float64)
    return torch.from_numpy(np.exp(sign * 1j * np.pi * k / (2.0 * n))).to(device=device,
                                                                           dtype=cdt)


def _fft_dct2(x: torch.Tensor) -> torch.Tensor:
    """Unnormalised DCT-II (factor-2 convention) of the last axis via FFT."""
    n = x.shape[-1]
    v = torch.cat([x[..., ::2], x[..., 1::2].flip(-1)], dim=-1)
    big = torch.fft.fft(v, dim=-1)
    tw = _twiddle(n, x.dtype, -1.0, x.device)
    return 2.0 * torch.real(big * tw).to(x.dtype)


def _fft_idct2(yu: torch.Tensor) -> torch.Tensor:
    """Exact inverse of `_fft_dct2` (input: unnormalised DCT-II coefficients):
    W = (X - i X_rev) / 2, V = e^{+i pi k/(2N)} W, x = unreorder(ifft(V))."""
    n = yu.shape[-1]
    y_rev = torch.cat([torch.zeros_like(yu[..., :1]), yu[..., 1:].flip(-1)], dim=-1)
    tw = _twiddle(n, yu.dtype, 1.0, yu.device)
    big = (0.5 * torch.complex(yu, -y_rev)) * tw
    v = torch.real(torch.fft.ifft(big, dim=-1)).to(yu.dtype)
    half = (n + 1) // 2
    x = torch.empty_like(yu)
    x[..., ::2] = v[..., :half]
    x[..., 1::2] = v[..., half:].flip(-1)
    return x


def matmul_rows(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, M] as ONE 2-D GEMM over all leading rows.

    torch.matmul runs a 3-D operand that is a transposed view (as the
    [B, C, N] view of [B, N, C] frames is) as a batched GEMM of B tiny
    [C, K] products; measured on an H100 at [689, 2, 2048] @ [2048, 2048]:
    4.5 ms, 2.5 TFLOP/s. Copying to contiguous rows first gives one GEMM."""
    return torch.matmul(x.reshape(-1, x.shape[-1]), w).reshape(*x.shape[:-1], w.shape[-1])


def matmul_rows_chunked(x: torch.Tensor, w: torch.Tensor, chunk: int) -> torch.Tensor:
    """`matmul_rows` with the contraction cut into `chunk`-long GEMMs whose
    products are accumulated in order (addmm into one output)."""
    rows = x.reshape(-1, x.shape[-1])
    out = rows[:, :chunk] @ w[:chunk]
    for s in range(chunk, rows.shape[1], chunk):
        out.addmm_(rows[:, s:s + chunk], w[s:s + chunk])
    return out.reshape(*x.shape[:-1], w.shape[-1])


def _dct_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.shape[-1] > K_SPLIT_ABOVE:
        return matmul_rows_chunked(x, w, K_CHUNK)
    return matmul_rows(x, w)


def dct2(x: torch.Tensor) -> torch.Tensor:
    """Forward-normalised DCT-II over the last axis (float32 or float64)."""
    n = x.shape[-1]
    if use_matmul(n, x.dtype):
        fwd, _ = device_matrices(n, x.device)
        return _dct_gemm(x, fwd)
    return _fft_dct2(x) / (2.0 * n)


def idct2(y: torch.Tensor) -> torch.Tensor:
    """Inverse of `dct2` over the last axis."""
    n = y.shape[-1]
    if use_matmul(n, y.dtype):
        _, inv = device_matrices(n, y.device)
        return _dct_gemm(y, inv)
    return _fft_idct2(y * (2.0 * n))
