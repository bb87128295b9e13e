"""Psychoacoustic masking for the lossy profiles, as torch ops on the device.

* 27 modified-Opus subband edges
* per-subband masking threshold: RMS(|X|)^0.8 against the absolute
  hearing threshold, times loss_level; bands from the first empty one
  on stay 0
* threshold -> per-bin divisor by per-band linear interpolation, as one
  [.., 27] @ [27, N] GEMM (lo*(1-frac) + hi*frac, the JAX package's
  product form)
* alpha=0.75 power-law compand, in the sqrt form sqrt(|x|*sqrt(|x|))

The numpy constant builders are verbatim copies of the JAX package's, so
the tables are bit-identical; `device_consts` turns them into float32 or
float64 tensors on the device, cached per (N, srate, device, dtype).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .dct import matmul_rows

MODIFIED_OPUS_SUBBANDS = (
    0, 200, 400, 600, 800, 1000, 1200, 1400,
    1600, 2000, 2400, 2800, 3200, 4000, 4800, 5600,
    6800, 8000, 9600, 12000, 15600, 20000, 24000, 28800,
    34400, 40800, 48000, (1 << 32) - 1,
)
SUBBANDS = len(MODIFIED_OPUS_SUBBANDS) - 1
SPREAD_ALPHA = 0.8
QUANT_ALPHA = 0.75


@functools.lru_cache(maxsize=256)
def band_edges(dlen: int, srate: int) -> np.ndarray:
    """Bin index of each subband edge: round-half-even of
    dlen/(srate/2)*edge, unclipped."""
    e = np.asarray(MODIFIED_OPUS_SUBBANDS, dtype=np.float64)
    return np.rint(dlen / (srate / 2) * e).astype(np.int64)


@functools.lru_cache(maxsize=256)
def _mask_consts(dlen: int, srate: int) -> tuple[np.ndarray, int, np.ndarray]:
    """(clipped band starts, number of active bands, AHT floor per band).

    Active bands = bands before the first empty bin range.
    """
    edges = band_edges(dlen, srate)
    starts = np.clip(edges, 0, dlen)
    widths = starts[1:] - starts[:-1]
    empty = np.flatnonzero(widths <= 0)
    nb = int(empty[0]) if empty.size else SUBBANDS

    mid = (np.asarray(MODIFIED_OPUS_SUBBANDS[:-1], dtype=np.float64)
           + np.asarray(MODIFIED_OPUS_SUBBANDS[1:], dtype=np.float64)) / 2.0
    f = mid / 1000.0
    with np.errstate(over="ignore"):
        aht = 10.0 ** (
            (3.64 * f ** -0.8 - 6.5 * np.exp(-0.6 * (f - 3.3) ** 2) + 1e-3 * f ** 4) / 20.0
        )
    aht_floor = np.minimum(aht, 1.0)
    return starts, nb, aht_floor


@functools.lru_cache(maxsize=256)
def _mask_consts_jnp(dlen: int, srate: int):
    """Masking constants: a [dlen, nb] band-indicator matrix (subband sums
    become one GEMM), per-band 1/width, AHT floor, and the per-bin band
    index / interpolation fraction / validity of the mapping."""
    starts, nb, aht_floor = _mask_consts(dlen, srate)
    ind = np.zeros((dlen, max(nb, 1)), dtype=np.float64)
    for i in range(nb):
        ind[starts[i]:starts[i + 1], i] = 1.0
    inv_w = np.zeros(max(nb, 1))
    inv_w[:nb] = 1.0 / (starts[1:nb + 1] - starts[:nb])

    # mapping constants: per-bin band index / interp fraction
    edges = band_edges(dlen, srate)
    mstarts = np.minimum(np.maximum(edges[:SUBBANDS], 0), dlen)
    t = np.arange(dlen)
    band = np.searchsorted(mstarts[1:SUBBANDS], t, side="right")
    valid = t < mstarts[SUBBANDS - 1]
    b = np.where(valid, band, 0)
    c = (mstarts[b + 1] - mstarts[b]).astype(np.float64)
    c = np.where(c == 0, 1.0, c)
    frac = (t - mstarts[b]) / c
    return ind, inv_w, aht_floor, nb, b, frac, valid


@functools.lru_cache(maxsize=256)
def _interp_matrix(dlen: int, srate: int) -> np.ndarray:
    """[SUBBANDS, dlen] interpolation matrix: column t holds the two band
    weights (1-frac, frac) of bin t, zero for invalid bins."""
    _, _, _, _, b, frac, valid = _mask_consts_jnp(dlen, srate)
    t = np.arange(dlen)
    hi = np.minimum(b + 1, SUBBANDS - 1)
    w = np.zeros((SUBBANDS, dlen), dtype=np.float64)
    np.add.at(w, (b, t), np.where(valid, 1.0 - frac, 0.0))
    np.add.at(w, (hi, t), np.where(valid, frac, 0.0))
    return w


@functools.lru_cache(maxsize=32)
def device_consts(dlen: int, srate: int, device: torch.device,
                  dtype: torch.dtype = torch.float32) -> dict:
    """The masking and mapping tables as `dtype` (float32 or float64)
    tensors on `device`: `ind` [dlen, nb'], `inv_w` [nb'], `aht` [nb']
    (nb' = max(nb, 1)), `interp` [SUBBANDS, dlen], and the active band
    count `nb`."""
    ind, inv_w, aht_floor, nb, *_ = _mask_consts_jnp(dlen, srate)
    ft = np.float64 if dtype == torch.float64 else np.float32

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype=ft)).to(device)

    return {"ind": dev(ind), "inv_w": dev(inv_w),
            "aht": dev(aht_floor[:ind.shape[1]]),
            "interp": dev(_interp_matrix(dlen, srate)), "nb": nb}


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root on every backend, float32 or float64.

    Torch's vectorised CPU sqrt can be an ulp off (measured on an AVX-512
    host: 0.7% of results, float32 and float64 alike), while XLA, numpy
    and CUDA round correctly. float32: the square root taken in float64
    and rounded to float32 is the correctly rounded float32 result
    (53 >= 2*24 + 2 bits, so the double rounding is innocuous even with an
    f64 result an ulp off). float64 on the CPU: numpy's square root (the
    hardware instruction)."""
    if x.dtype == torch.float64:
        if x.device.type == "cpu":
            return torch.from_numpy(np.sqrt(x.numpy()))
        return torch.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def band_sums(freqs: torch.Tensor, consts: dict) -> torch.Tensor:
    """Sum of squares per active subband of [..., N] magnitude spectra ->
    [..., nb'], as one GEMM against the band-indicator matrix."""
    return matmul_rows(freqs * freqs, consts["ind"])


def thres_from_sums(sums: torch.Tensor, inv_w: torch.Tensor, aht: torch.Tensor, nb: int,
                    loss_level: float, alpha: float = SPREAD_ALPHA) -> torch.Tensor:
    """Band sums [..., nb'] -> masking thresholds [..., SUBBANDS]:
    RMS^alpha against the AHT floor, times `loss_level`, zeros from band
    `nb` on."""
    rms = sqrt_rn(sums * inv_w) ** alpha
    th = torch.maximum(rms, aht) * loss_level
    th = th[..., :nb]
    pad = SUBBANDS - nb
    if pad > 0:
        th = torch.cat([th, th.new_zeros(th.shape[:-1] + (pad,))], dim=-1)
    return th


def mask_thres_mos(freqs: torch.Tensor, srate: int, loss_level: float,
                   alpha: float = SPREAD_ALPHA) -> torch.Tensor:
    """Masking thresholds for [..., N] magnitude spectra -> [..., SUBBANDS]."""
    c = device_consts(freqs.shape[-1], srate, freqs.device, freqs.dtype)
    return thres_from_sums(band_sums(freqs, c), c["inv_w"], c["aht"], c["nb"], loss_level,
                           alpha)


def mapping_from_opus(mapped_thres: torch.Tensor, freqs_len: int, srate: int) -> torch.Tensor:
    """Per-bin divisors [..., freqs_len] from [..., SUBBANDS] thresholds,
    as one GEMM against the interpolation matrix."""
    w = device_consts(freqs_len, srate, mapped_thres.device, mapped_thres.dtype)["interp"]
    return matmul_rows(mapped_thres[..., :SUBBANDS], w)


def quant(x: torch.Tensor) -> torch.Tensor:
    """sign(x)*|x|^0.75 as sign(x)*sqrt(|x|*sqrt(|x|)), the JAX package's
    product form, with correctly rounded square roots."""
    a = torch.abs(x)
    return torch.sign(x) * sqrt_rn(a * sqrt_rn(a))


def dequant(x: torch.Tensor) -> torch.Tensor:
    """Inverse compand: sign(x)*|x|^(4/3)."""
    return torch.sign(x) * torch.abs(x) ** (1.0 / QUANT_ALPHA)
