"""Psychoacoustic masking for the lossy profiles: the tables the masking
kernels (`kernels/mask_thres.py`, `kernels/thres_expand.py`) and their
plain versions read, and the elementwise pieces they share.

* 27 modified-Opus subband edges
* per-subband masking threshold: RMS(|X|)^0.8 against the absolute
  hearing threshold, times loss_level; bands from the first empty one
  on stay 0
* threshold -> per-bin divisor by per-band linear interpolation,
  lo*(1-frac) + hi*frac with the weights of the JAX package's
  interpolation matrix (its `_interp_matrix`), as two products and a sum
* alpha=0.75 power-law compand, in the sqrt form sqrt(|x|*sqrt(|x|))

The numpy constant builders are verbatim copies of the JAX package's, so
the tables are bit-identical; `kernel_tables` hands the per-band ones to
the kernels as host arrays (they go by value), `device_consts` the rest as
float32 or float64 tensors on the device to the plain versions and, for
the per-bin interpolation, to the kernels too, cached per (N, srate,
device, dtype).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import policy

MODIFIED_OPUS_SUBBANDS = (
    0, 200, 400, 600, 800, 1000, 1200, 1400,
    1600, 2000, 2400, 2800, 3200, 4000, 4800, 5600,
    6800, 8000, 9600, 12000, 15600, 20000, 24000, 28800,
    34400, 40800, 48000, (1 << 32) - 1,
)
SUBBANDS = len(MODIFIED_OPUS_SUBBANDS) - 1
SPREAD_ALPHA = 0.8
QUANT_ALPHA = 0.75
#: lanes of a band's running sums (a warp of the kernel)
SUM_LANES = 32


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
def band_consts(dlen: int, srate: int) -> tuple[np.ndarray, np.ndarray, int]:
    """(per-band 1/width [nb'], AHT floor [nb'], active bands nb), nb' =
    max(nb, 1): the JAX package's `_mask_consts_jnp` without its
    band-indicator matrix."""
    starts, nb, aht_floor = _mask_consts(dlen, srate)
    inv_w = np.zeros(max(nb, 1))
    inv_w[:nb] = 1.0 / (starts[1:nb + 1] - starts[:nb])
    return inv_w, aht_floor[:max(nb, 1)], nb


@functools.lru_cache(maxsize=256)
def mapping_consts(dlen: int, srate: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-bin band index b, interpolation fraction and validity of the
    mapping (the JAX package's `_mask_consts_jnp`): bin t of a valid band
    b gets lo = thres[b] at weight 1 - frac and hi = thres[b + 1] at frac;
    bins from the start of band 26 on are invalid (divisor 0)."""
    edges = band_edges(dlen, srate)
    mstarts = np.minimum(np.maximum(edges[:SUBBANDS], 0), dlen)
    t = np.arange(dlen)
    band = np.searchsorted(mstarts[1:SUBBANDS], t, side="right")
    valid = t < mstarts[SUBBANDS - 1]
    b = np.where(valid, band, 0)
    c = (mstarts[b + 1] - mstarts[b]).astype(np.float64)
    c = np.where(c == 0, 1.0, c)
    frac = (t - mstarts[b]) / c
    return b, frac, valid


@functools.lru_cache(maxsize=256)
def kernel_tables(dlen: int, srate: int) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """The host tables the masking kernels take by value: (the 28 clipped
    band starts, int32; 1/width and the AHT floor of the 27 bands,
    float64, zero from band nb' on; nb). The kernels round the float64
    entries to their compute dtype as `device_consts` does."""
    starts, _, _ = _mask_consts(dlen, srate)
    inv_w, aht, nb = band_consts(dlen, srate)
    pad = np.zeros(SUBBANDS)
    w, a = pad.copy(), pad.copy()
    w[:len(inv_w)], a[:len(aht)] = inv_w, aht
    return np.ascontiguousarray(starts, dtype=np.int32), w, a, nb


def device_consts(dlen: int, srate: int, device: str | torch.device,
                  dtype: torch.dtype = torch.float32) -> dict:
    """`_device_consts`, cached once per card (`policy.device_key`)."""
    return _device_consts(dlen, srate, policy.device_key(device), dtype)


#: room for the frame lengths, rates and dtypes of a run on four cards
@functools.lru_cache(maxsize=128)
def _device_consts(dlen: int, srate: int, device: torch.device, dtype: torch.dtype) -> dict:
    """The masking and mapping tables of the plain versions as tensors on
    `device`, floats in `dtype` (float32 or float64): `inv_w` and `aht`
    [nb'], the active band count `nb`; `sum_index` [nb, S, SUM_LANES], the
    bins each band's running sums add in step order (lane l of step s of
    band b: start_b + SUM_LANES * s + l, or dlen, a +0 pad, past the band);
    per bin the two bands `lo`, `hi` [dlen] and their weights `w_lo` =
    1 - frac, `w_hi` = frac [dlen] (0 on invalid bins: the entries of the
    JAX package's interpolation matrix rounded to `dtype`), `valid`, and
    `band8` [dlen], uint8: `lo`, or 255 on an invalid bin (the kernels read
    it with the weights)."""
    starts, _, _ = _mask_consts(dlen, srate)
    inv_w, aht, nb = band_consts(dlen, srate)
    b, frac, valid = mapping_consts(dlen, srate)
    ft = np.float64 if dtype == torch.float64 else np.float32
    widths = starts[1:nb + 1] - starts[:nb]
    steps = int(-(-widths.max() // SUM_LANES)) if nb else 0
    idx = starts[:nb, None, None] + SUM_LANES * np.arange(steps)[None, :, None] \
        + np.arange(SUM_LANES)[None, None, :]
    idx = np.where(idx < starts[1:nb + 1, None, None], idx, dlen)

    def dev(a: np.ndarray, dt=ft) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(device)

    return {"inv_w": dev(inv_w), "aht": dev(aht), "nb": nb,
            "sum_index": dev(idx, np.int64), "lo": dev(b, np.int64),
            "hi": dev(np.minimum(b + 1, SUBBANDS - 1), np.int64),
            "w_lo": dev(np.where(valid, 1.0 - frac, 0.0)),
            "w_hi": dev(np.where(valid, frac, 0.0)), "valid": dev(valid, np.bool_),
            "band8": dev(np.where(valid, b, 255), np.uint8)}


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


def quant(x: torch.Tensor) -> torch.Tensor:
    """sign(x)*|x|^0.75 as sign(x)*sqrt(|x|*sqrt(|x|)), the JAX package's
    product form, with correctly rounded square roots."""
    a = torch.abs(x)
    return torch.sign(x) * sqrt_rn(a * sqrt_rn(a))


def dequant(x: torch.Tensor) -> torch.Tensor:
    """Inverse compand: sign(x)*|x|^(4/3)."""
    return torch.sign(x) * torch.abs(x) ** (1.0 / QUANT_ALPHA)
