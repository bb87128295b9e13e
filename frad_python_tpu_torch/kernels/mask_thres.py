"""`mask_thres`: the lossy encoders' masking chain, from the spectrum to the
per-bin divisor and the threshold symbols, in one launch.

The port of the masking part of the JAX package's XLA device programs
(frad_python_tpu/models/batch.py:_p1_encode_jit and :_p2_encode_jit:
`mask_thres_mos_jnp(|freqs| * factor)` of frad_python_tpu/ops/psycho.py,
`mapping_from_opus_jnp` and the threshold symbols): spectra [R, N] (R =
frames * channels) -> (the per-bin divisor div [R, N], the threshold
symbols thres_q [R / channels, 27, channels]).

Per row, in this order, each operation rounded once:

1. a = |x| * factor, then a * a (the factor rounded to the row's dtype);
2. the band sums of those squares in the order `band_sums_plain` states
   (per band 32 running sums, lane l adding the band's bins l, l + 32, ...
   in ascending order from +0, then a shuffle tree over the 32);
3. th = max(sqrt(sum / width)^0.8, AHT floor) * loss level for the nb
   active bands, 0 from band nb on (`psycho.thres_from_sums`), and the
   symbols rint(sign * |log(max(th, 1)) / log(e/2)|^(4/3))
   (`thres_quant_plain`);
4. div[t] = th[lo] * w_lo + th[hi] * w_hi (two products, one sum), lo and
   hi bin t's two bands and w_lo = 1 - frac, w_hi = frac the JAX
   package's interpolation weights rounded to the row's dtype; 0 on the
   bins past band 25 (`interpolate_plain`), which `power_quant` and
   `tns_autocorr` read as infinity.

The band sums' order and the two-term interpolation are the port's own:
the JAX package sums with a GEMM against a band-indicator matrix and
interpolates with a GEMM against the [27, N] interpolation matrix, each in
its library's order. So float32 symbols may flip by 1 at rint boundaries
against the JAX package (and against the port before this form); float64
streams stay byte-equal in practice (a flip has a probability of ~1e-13 a
symbol). A non-finite threshold spreads only to the bins whose two terms
read it (the GEMM spread a NaN to every bin of the row); PCM in [-1, 1]
gives finite thresholds.

`mask_thres` launches the CUDA kernel (csrc/mask_thres.cu) for CUDA
tensors and runs `mask_thres_plain` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import psycho
from . import build

E_HALF = np.e / 2.0
_EXPONENT = 1.0 / psycho.QUANT_ALPHA
#: threads a block of the kernel past a few rows
THREADS = 256
#: rows * 1024 threads up to which a row gets a block of 1024 (two such
#: blocks fill an SM's 2048 threads on the card's 132 SMs)
_FEW_ROWS_THREADS = 132 * 2048


def band_sums_plain(sq: torch.Tensor, k: dict) -> torch.Tensor:
    """Sums of sq [R, N] over each active band -> [R, nb'] (nb' =
    max(nb, 1); zeros when nb is 0), in the kernel's order: band b has 32
    running sums, sum l adding the band's bins start_b + l, start_b + l +
    32, ... in ascending order from +0 (the band padded with +0 to whole
    steps of 32), then p[l] += p[l + s] for s = 16, 8, 4, 2, 1 (a warp's
    shuffle tree); the result is p[0]."""
    if k["nb"] == 0:
        return sq.new_zeros(sq.shape[:-1] + (1,))
    g = F.pad(sq, (0, 1))[..., k["sum_index"]]                   # [R, nb, S, 32]
    acc = torch.zeros_like(g[..., 0, :])
    for s in range(g.shape[-2]):
        acc = acc + g[..., s, :]
    s = psycho.SUM_LANES // 2
    while s:
        acc = acc[..., :s] + acc[..., s:2 * s]
        s //= 2
    return acc[..., 0]


def interpolate_plain(th: torch.Tensor, k: dict) -> torch.Tensor:
    """Thresholds [..., 27] -> per-bin divisors [..., N]: th[lo] * w_lo +
    th[hi] * w_hi on the valid bins, two IEEE products and one IEEE sum,
    and 0 past them."""
    div = th[..., k["lo"]] * k["w_lo"] + th[..., k["hi"]] * k["w_hi"]
    return torch.where(k["valid"], div, torch.zeros_like(div))


def thres_quant_plain(thres: torch.Tensor) -> torch.Tensor:
    """Masking thresholds -> log-companded integer symbols (int64 at
    float64, else int32): the clamp at 1, the logarithm, an IEEE division
    by log(e/2) taken in the thresholds' dtype on their device, the
    4/3-power compand, the half-even rounding."""
    log_base = torch.log(torch.tensor(E_HALF, dtype=thres.dtype, device=thres.device))
    return torch.round(
        psycho.dequant(torch.log(torch.clamp(thres, min=1.0)) / log_base)
    ).to(torch.int64 if thres.dtype == torch.float64 else torch.int32)


def mask_thres_plain(freqs: torch.Tensor, factor: float, loss_level: float, srate: int,
                     channels: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Spectra [R, N] (R = frames * channels, float32 or float64) -> (div
    [R, N] in their dtype, thres_q [R / channels, 27, channels], int64 at
    float64, else int32); see the module's docstring for the steps."""
    rows, n = freqs.shape
    k = psycho.device_consts(n, srate, freqs.device, freqs.dtype)
    a = torch.abs(freqs) * factor
    th = psycho.thres_from_sums(band_sums_plain(a * a, k), k["inv_w"], k["aht"], k["nb"],
                                float(loss_level))
    tq = thres_quant_plain(th).reshape(-1, channels, psycho.SUBBANDS)
    return interpolate_plain(th, k), tq.transpose(1, 2).contiguous()


def geometry(rows: int) -> int:
    """Threads a block (a row) of the kernel: a warp a band (32 warps)
    while few rows leave the card idle, so that a row costs one round trip
    to memory; else THREADS, a few bands a warp and many blocks an SM."""
    return 1024 if rows * 1024 <= _FEW_ROWS_THREADS else THREADS


def mask_thres(freqs: torch.Tensor, factor: float, loss_level: float, srate: int,
               channels: int) -> tuple[torch.Tensor, torch.Tensor]:
    """See `mask_thres_plain`; one kernel launch for a CUDA tensor."""
    if freqs.device.type == "cpu":
        return mask_thres_plain(freqs, factor, loss_level, srate, channels)
    if freqs.device.type != "cuda":
        raise ValueError(f"mask_thres: tensor on {freqs.device}")
    if freqs.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"mask_thres: float32 or float64 required, got {freqs.dtype}")
    if freqs.dim() != 2 or not freqs.is_contiguous() or freqs.shape[1] < 1:
        raise ValueError(f"mask_thres: contiguous [R, N] spectra required, got "
                         f"{tuple(freqs.shape)}")
    rows, n = freqs.shape
    if channels < 1 or rows % channels:
        raise ValueError(f"mask_thres: {rows} rows of {channels} channels")
    f64 = freqs.dtype == torch.float64
    starts, inv_w, aht, nb = psycho.kernel_tables(n, srate)
    k = psycho.device_consts(n, srate, freqs.device, freqs.dtype)
    div = torch.empty_like(freqs)
    tq = torch.empty((rows // channels, psycho.SUBBANDS, channels),
                     dtype=torch.int64 if f64 else torch.int32, device=freqs.device)
    lib = build.library()
    with build.on_device("mask_thres", freqs) as stream:
        err = lib.frad_mask_thres(
            ctypes.c_void_p(freqs.data_ptr()), ctypes.c_void_p(div.data_ptr()),
            ctypes.c_void_p(tq.data_ptr()), rows, n, channels,
            starts.ctypes.data_as(ctypes.c_void_p), inv_w.ctypes.data_as(ctypes.c_void_p),
            aht.ctypes.data_as(ctypes.c_void_p), nb, *(ctypes.c_void_p(k[t].data_ptr())
                                                       for t in ("band8", "w_lo", "w_hi")),
            float(factor), float(loss_level), psycho.SPREAD_ALPHA, _EXPONENT, E_HALF, int(f64),
            geometry(rows),
            stream)
    build.check("frad_mask_thres", err)
    mask_thres.launches += 1
    return div, tq


#: kernel launches since the last reset (CPU calls do not count)
mask_thres.launches = 0
