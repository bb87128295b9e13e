"""Plain reference of the FrAD transforms, Profile 1's psychoacoustic
quantiser and both profiles' decoders, in float64 from the format's
definitions, independent of the program.

Arrays are plain PyTorch tensors on any device. `Precision` names the
arithmetic: the reference itself is float64; the control computes the same
functions in float32 with its transform products in TF32 (the next
precision below the float32 with TF32 off that the configurations state).
On a CUDA device TF32 is the tensor cores' own; elsewhere the operands are
rounded to TF32's 10-bit mantissa before a float32 product, which is what
TF32 does to them.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

#: modified Opus subband edges in Hz; the last is open
SUBBAND_EDGES = (0, 200, 400, 600, 800, 1000, 1200, 1400, 1600, 2000, 2400, 2800, 3200, 4000,
                 4800, 5600, 6800, 8000, 9600, 12000, 15600, 20000, 24000, 28800, 34400, 40800,
                 48000, (1 << 32) - 1)
BANDS = len(SUBBAND_EDGES) - 1
SPREAD_ALPHA = 0.8
QUANT_ALPHA = 0.75
LOG_BASE = math.log(math.e / 2.0)


@dataclass(frozen=True)
class Precision:
    dtype: torch.dtype
    tf32: bool


REFERENCE = Precision(torch.float64, False)
CONTROL = Precision(torch.float32, True)


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with a 10-bit mantissa (ties away)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, prec: Precision) -> torch.Tensor:
    if not prec.tf32:
        return a @ b
    if a.device.type == "cuda":
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return a @ b
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
    return _round_tf32(a) @ _round_tf32(b)


@functools.lru_cache(maxsize=16)
def _cosines(n: int) -> np.ndarray:
    k = np.arange(n, dtype=np.float64)[:, None]
    t = np.arange(n, dtype=np.float64)[None, :]
    return np.cos(np.pi * k * (2.0 * t + 1.0) / (2.0 * n))         # [k, t]


def _matrix(n: int, inverse: bool, prec: Precision, device) -> torch.Tensor:
    cos = _cosines(n)
    if inverse:                                                     # X @ M -> x
        w = np.full((n, 1), 2.0)
        w[0, 0] = 1.0
        m = w * cos
    else:                                                           # x @ M -> X
        m = (cos / n).T
    return torch.from_numpy(np.ascontiguousarray(m)).to(device=device, dtype=prec.dtype)


def dct(x: torch.Tensor, prec: Precision = REFERENCE) -> torch.Tensor:
    """DCT-II over the last axis, scaled by 1/N (scipy's norm='forward'):
    X[k] = (1/N) sum_t x[t] cos(pi k (2t + 1) / 2N)."""
    n = x.shape[-1]
    return matmul(x.to(prec.dtype), _matrix(n, False, prec, x.device), prec)


def idct(x: torch.Tensor, prec: Precision = REFERENCE) -> torch.Tensor:
    """Inverse of `dct`: x[t] = X[0] + 2 sum_{k>=1} X[k] cos(pi k (2t + 1) / 2N)."""
    n = x.shape[-1]
    return matmul(x.to(prec.dtype), _matrix(n, True, prec, x.device), prec)


@functools.lru_cache(maxsize=16)
def band_tables(n: int, srate: int):
    """For an N-bin frame at `srate`: (band starts [28] clipped to [0, N],
    active bands nb (those before the first empty one), the absolute
    hearing threshold per band capped at 1 [27], per bin the lower band,
    the upper band and the interpolation fraction, and whether the bin
    lies before the start of the last band)."""
    hz = np.asarray(SUBBAND_EDGES, dtype=np.float64)
    edges = np.rint(n / (srate / 2) * hz).astype(np.int64)
    starts = np.clip(edges, 0, n)
    widths = starts[1:] - starts[:-1]
    empty = np.flatnonzero(widths <= 0)
    nb = int(empty[0]) if empty.size else BANDS
    mid_khz = (hz[:-1] + hz[1:]) / 2.0 / 1000.0
    with np.errstate(over="ignore"):
        aht = 10.0 ** ((3.64 * mid_khz ** -0.8 - 6.5 * np.exp(-0.6 * (mid_khz - 3.3) ** 2)
                        + 1e-3 * mid_khz ** 4) / 20.0)
    aht = np.minimum(aht, 1.0)
    mstarts = np.minimum(np.maximum(edges[:BANDS], 0), n)
    t = np.arange(n)
    band = np.searchsorted(mstarts[1:BANDS], t, side="right")
    valid = t < mstarts[BANDS - 1]
    lo = np.where(valid, band, 0)
    span = (mstarts[lo + 1] - mstarts[lo]).astype(np.float64)
    frac = (t - mstarts[lo]) / np.where(span == 0, 1.0, span)
    hi = np.minimum(lo + 1, BANDS - 1)
    return starts, nb, aht, lo, hi, frac, valid


def _interpolate(th: torch.Tensor, n: int, srate: int) -> torch.Tensor:
    """Band thresholds [..., 27] -> per-bin divisors [..., N], linear
    between a band's threshold and the next one's; 0 past the valid bins."""
    _, _, _, lo, hi, frac, valid = band_tables(n, srate)
    dev, dt = th.device, th.dtype
    lo_t, hi_t = torch.from_numpy(lo).to(dev), torch.from_numpy(hi).to(dev)
    f = torch.from_numpy(frac).to(dev, dt)
    v = torch.from_numpy(valid).to(dev)
    div = th[..., lo_t] * (1 - f) + th[..., hi_t] * f
    return torch.where(v, div, torch.zeros_like(div))


def compand(x: torch.Tensor) -> torch.Tensor:
    """sign(x) |x|^(3/4)."""
    return torch.sign(x) * torch.abs(x) ** QUANT_ALPHA


def expand(x: torch.Tensor) -> torch.Tensor:
    """sign(x) |x|^(4/3)."""
    return torch.sign(x) * torch.abs(x) ** (1.0 / QUANT_ALPHA)


def p1_analysis(frames: torch.Tensor, srate: int, loss_level: float, bits: int,
                prec: Precision = REFERENCE) -> tuple[torch.Tensor, torch.Tensor]:
    """Profile 1's quantiser before its rounding. frames [F, N, C] PCM ->
    (coefficient values [F, N, C], threshold values [F, 27, C]): the
    symbols a sound encoder writes are these values rounded to integers.

    Per channel-frame: X = dct(x); per band b, the threshold th_b =
    max(RMS(|X| 2^(bits-1))^0.8, AHT_b) x loss_level over the active
    bands, 0 past them; the threshold value |ln(max(th_b, 1)) / ln(e/2)|^(4/3);
    the per-bin divisor, th linearly interpolated between bands; the
    coefficient value compand(X / divisor x 2^(bits-1)), 0 where the
    divisor is 0."""
    f, n, c = frames.shape
    factor = float(2 ** (bits - 1))
    starts, nb, aht, *_ = band_tables(n, srate)
    x = dct(frames.transpose(1, 2).reshape(f * c, n), prec)              # [R, N]
    a = (torch.abs(x) * factor) ** 2
    sums = torch.stack([a[:, starts[b]:starts[b + 1]].sum(dim=1) for b in range(nb)], dim=1)
    widths = torch.from_numpy(starts[1:nb + 1] - starts[:nb]).to(x.device, x.dtype)
    rms = torch.sqrt(sums / widths)
    th = torch.maximum(rms ** SPREAD_ALPHA, torch.from_numpy(aht[:nb]).to(x.device, x.dtype)) \
        * loss_level
    th = torch.nn.functional.pad(th, (0, BANDS - nb))                    # [R, 27]
    tval = torch.abs(torch.log(torch.clamp(th, min=1.0)) / LOG_BASE) ** (1.0 / QUANT_ALPHA)
    div = _interpolate(th, n, srate)
    safe = torch.where(div == 0, torch.ones_like(div), div)
    v = torch.where(div == 0, torch.zeros_like(x), compand(x / safe * factor))
    return (v.reshape(f, c, n).transpose(1, 2),
            tval.reshape(f, c, BANDS).transpose(1, 2))


def p1_synthesis(freqs: torch.Tensor, thres: torch.Tensor, srate: int, bits: int,
                 prec: Precision = REFERENCE) -> torch.Tensor:
    """Profile 1's decoder of one frame size: symbols freqs [F, N, C] and
    thres [F, 27, C] -> frames [F, N, C] PCM: thresholds (e/2)^compand(t),
    interpolated to the bins, times expand(s) / 2^(bits-1), then the
    inverse transform."""
    f, n, c = freqs.shape
    factor = float(2 ** (bits - 1))
    t = thres.to(prec.dtype).transpose(1, 2)                             # [F, C, 27]
    th = torch.exp(compand(t) * LOG_BASE)
    div = _interpolate(th, n, srate)                                     # [F, C, N]
    coef = expand(freqs.to(prec.dtype).transpose(1, 2)) / factor * div
    return idct(coef.reshape(f * c, n), prec).reshape(f, c, n).transpose(1, 2)


def lossless_synthesis(values: torch.Tensor, prec: Precision = REFERENCE) -> torch.Tensor:
    """Profile 0's decoder of one frame size: coefficients [F, N, C] -> PCM."""
    f, n, c = values.shape
    return idct(values.transpose(1, 2).reshape(f * c, n), prec).reshape(f, c, n).transpose(1, 2)


def fade_in(n: int) -> np.ndarray:
    """The crossfade's fade-in window w[i] = (1 - cos(pi (i + 1) / (n + 1))) / 2."""
    return 0.5 * (1.0 - np.cos(np.pi * np.arange(1, n + 1) / (n + 1)))


def overlap_add(frames: list[np.ndarray], olaps: list[int]) -> np.ndarray:
    """Decoded frames [N_i, C] in stream order, frame i leaving an overlap
    of olaps[i] samples to frame i + 1, -> the emitted PCM: each frame's
    first olaps[i - 1] samples fade in over the last olaps[i - 1] samples of
    frame i - 1, which fade out; the last frame's tail is emitted as it is."""
    c = frames[0].shape[1]
    starts, pos = [], 0
    for i, fr in enumerate(frames):
        starts.append(pos)
        pos += fr.shape[0] - olaps[i]
    total = starts[-1] + frames[-1].shape[0]
    out = np.zeros((total, c))
    for i, fr in enumerate(frames):
        fr = fr.copy()
        if i and olaps[i - 1]:
            w = fade_in(olaps[i - 1])[:, None]
            fr[:olaps[i - 1]] *= w
        if i + 1 < len(frames) and olaps[i]:
            w = fade_in(olaps[i])[::-1, None]
            fr[fr.shape[0] - olaps[i]:] *= w
        out[starts[i]:starts[i] + fr.shape[0]] += fr
    return out
