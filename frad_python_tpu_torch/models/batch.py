"""Batched Profile 0, 1 and 2 cores over a frame batch [B, N, C], as torch
ops on one device.

Profile 0: the DCT-II / IDCT of `ops/dct.py` (the float32 GEMM, or the
FFT form at float64 and above N = 8192), and the fast path's fused
pairs: DCT GEMM -> `trunc_pack` kernel (payload words and each frame's
max|x|), and `trunc_unpack` kernel -> IDCT GEMM; with the int24 transfer
forms the `i24_unpack` kernel comes before the first and the `i24_pack`
kernel after the second.

Encode: PCM -> DCT-II GEMM -> `mask_thres` kernel (band sums of
(|X| * factor)^2, RMS^0.8, AHT floor, x loss, the log-companded threshold
symbols and the per-bin divisor) -> `power_quant` kernel. Decode:
`dequant` kernel (the symbols' powers times the per-bin divisor that it
expands from the threshold symbols in the same launch) -> IDCT GEMM
(`p1_decode_core`) -> `overlap_add` kernel (`p1_decode_oa_core`). The GEMMs are `torch.matmul` at full float32; the
stages between them are the hand-written CUDA kernels of `kernels/`.

Profile 2 is Profile 1's chain with Temporal Noise Shaping (`ops/tns.py`)
between the masking divide and the quantiser: the encoder runs the TNS
analysis (`tns_autocorr`, which divides, and `tns_fir_gate`, which runs the
Levinson recursion, kernels) and quantises the residual with
the `power_quant` kernel's no-divisor form; the decoder dequantises
(`dequant` without thresholds), runs the TNS synthesis (`tns_iir`
kernel), multiplies by the divisors of the `thres_expand` kernel and
ends like Profile 1.

The lossy cores compute in the dtype of their input: float32 (int32
symbols), or float64 (int64 symbols, the FFT form of the DCT).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.dequant import dequant
from ..kernels.i24_pack import i24_pack
from ..kernels.i24_unpack import i24_unpack
from ..kernels.mask_thres import mask_thres
from ..kernels.overlap_add import crossfade_window, overlap_add
from ..kernels.power_quant import power_quant
from ..kernels.thres_expand import thres_expand
from ..kernels.trunc_pack import trunc_pack
from ..kernels.trunc_unpack import trunc_unpack
from ..ops import tns
from ..ops.dct import dct2, idct2


def p0_encode_core(frames: torch.Tensor) -> torch.Tensor:
    """[B, N, C] PCM -> [B, N, C] DCT-II 'forward' coefficients, in the
    dtype of `frames` (float32 or float64)."""
    return dct2(frames.transpose(1, 2)).transpose(1, 2)


def p0_decode_core(freqs: torch.Tensor) -> torch.Tensor:
    """[B, N, C] coefficients -> [B, N, C] PCM."""
    return idct2(freqs.transpose(1, 2)).transpose(1, 2)


def p0_encode_pack_core(frames: torch.Tensor, bits: int, little: bool):
    """[B, N, C] float32 PCM -> (payload words, maxabs [B] float32): the
    DCT GEMM, then the `trunc_pack` kernel on its [B, C, N] output, so
    the copy to the host carries the payload bytes. A frame whose maxabs
    exceeds the container float (or is NaN) must leave this path."""
    return trunc_pack(dct2(frames.transpose(1, 2)), bits, little)


def p0_encode_pack_core_i24(words: torch.Tensor, bits: int, little: bool, n: int, ch: int):
    """`p0_encode_pack_core` of int24 PCM words [B, n*ch*3//4] (the
    `i24_unpack` kernel first): the upload carries 3 bytes a sample."""
    frames = i24_unpack(words).reshape(words.shape[0], n, ch)
    return p0_encode_pack_core(frames, bits, little)


def p0_unpack_decode_core(words: torch.Tensor, bits: int, little: bool, n: int,
                          ch: int) -> torch.Tensor:
    """Payload words [B, W] -> [B, n, ch] float32 PCM: the `trunc_unpack`
    kernel, then the IDCT GEMM; the upload carries the payload bytes."""
    return idct2(trunc_unpack(words, bits, little, n, ch)).transpose(1, 2)


def p0_unpack_decode_i24_core(words: torch.Tensor, bits: int, little: bool, n: int,
                              ch: int) -> torch.Tensor:
    """`p0_unpack_decode_core` returning int24 PCM words [B, n*ch*3//4]
    (the `i24_pack` kernel on the IDCT's transposed output): the copy to
    the host carries 3 bytes a sample."""
    return i24_pack(p0_unpack_decode_core(words, bits, little, n, ch))


def p1_encode_core(frames: torch.Tensor, srate: int, loss_level: float, factor: float):
    """[B, N, C] PCM -> (freqs_q [B, N, C], thres_q [B, 27, C]): int32 for
    float32 frames, int64 for float64."""
    b, n, c = frames.shape
    freqs = dct2(frames.transpose(1, 2)).reshape(b * c, n).contiguous()
    div, thres_q = mask_thres(freqs, factor, loss_level, srate, c)
    freqs_q = power_quant(freqs, div, factor).reshape(b, c, n)
    return freqs_q.transpose(1, 2), thres_q


def p1_encode_core_i16(frames_i16: torch.Tensor, srate: int, loss_level: float, factor: float):
    """`p1_encode_core` on [B, N, C] int16 PCM (x * 32768): the upload
    carries 2 bytes per sample; the cast back is exact."""
    frames = frames_i16.to(torch.float32) * (1.0 / 32768.0)
    return p1_encode_core(frames, srate, loss_level, factor)


def p1_decode_core(freqs_flat: torch.Tensor, thres_flat: torch.Tensor,
                   srate: int, factor: float) -> torch.Tensor:
    """Profile 1 decode without overlap-add.

    freqs_flat [B, N, C] symbols (int16, or float32 / float64),
    thres_flat [B, 27, C] in the compute dtype -> [B, N, C] PCM in that
    dtype (a transposed view of the IDCT's [B, C, N] output)."""
    masked = dequant(freqs_flat.contiguous(), thres_flat.contiguous(), factor, srate)
    return idct2(masked).transpose(1, 2)


def _overlap_add_emit(pcm: torch.Tensor, olap: int, cut: int, i16: bool):
    """[B, N, C] decoded frames (a view of [B, C, N]) -> the `overlap_add`
    kernel's (out, frag)."""
    pcm = pcm.transpose(1, 2).contiguous()                           # [B, C, N]
    return overlap_add(pcm, crossfade_window(olap, pcm.device, pcm.dtype), cut, i16)


def p1_decode_oa_core(freqs_flat: torch.Tensor, thres_flat: torch.Tensor,
                      srate: int, factor: float, olap: int, cut: int, i16: bool):
    """`p1_decode_core` + overlap-add of one uniform run -> (pcm_out
    [B, cut, C], int16 x32768 when `i16` else the compute dtype; fragment
    [olap, C], the raw tail of the last frame that the next run crossfades
    in)."""
    return _overlap_add_emit(p1_decode_core(freqs_flat, thres_flat, srate, factor),
                             olap, cut, i16)


def p2_encode_core(frames: torch.Tensor, srate: int, loss_level: float, factor: float):
    """[B, N, C] PCM -> (freqs_q [B, N, C], thres_q [B, 27, C], lpc_q
    [B, 13, C]): Profile 1's chain with the TNS analysis between the
    masking divide and the quantiser. int32 for float32 frames, int64 for
    float64."""
    b, n, c = frames.shape
    freqs = dct2(frames.transpose(1, 2)).reshape(b * c, n).contiguous()
    div, thres_q = mask_thres(freqs, factor, loss_level, srate, c)
    masked, lpc_q = tns.tns_analysis(freqs, div)
    freqs_q = power_quant(masked, None, factor).reshape(b, c, n)
    return (freqs_q.transpose(1, 2), thres_q,
            lpc_q.reshape(b, c, -1).to(freqs_q.dtype).transpose(1, 2))


def p2_decode_core(freqs_flat: torch.Tensor, thres_flat: torch.Tensor,
                   lpc_flat: torch.Tensor, srate: int, factor: float) -> torch.Tensor:
    """Inverse of `p2_encode_core` without overlap-add: freqs_flat
    [B, N, C] symbols (int16, or the compute dtype), thres_flat [B, 27, C]
    and lpc_flat [B, 13, C] in the compute dtype -> [B, N, C] PCM."""
    masked = dequant(freqs_flat.contiguous(), None, factor)          # [B, C, N]
    freqs = tns.tns_synthesis(masked, lpc_flat.transpose(1, 2)) \
        * thres_expand(thres_flat.contiguous(), freqs_flat.shape[1], srate)
    return idct2(freqs).transpose(1, 2)


def p2_decode_oa_core(freqs_flat: torch.Tensor, thres_flat: torch.Tensor,
                      lpc_flat: torch.Tensor, srate: int, factor: float,
                      olap: int, cut: int, i16: bool):
    """`p2_decode_core` + overlap-add of one uniform run; returns as
    `p1_decode_oa_core` does."""
    return _overlap_add_emit(p2_decode_core(freqs_flat, thres_flat, lpc_flat, srate, factor),
                             olap, cut, i16)


def overlap_add_core(frames: torch.Tensor, olap: int, cut: int) -> torch.Tensor:
    """[B, N, C] decoded frames -> [B, cut, C] overlap-added PCM
    (frame 0's head fade-free; the stream tail is frames[-1, cut:])."""
    return _overlap_add_emit(frames, olap, cut, False)[0]


def overlap_frame_starts(total: int, fsize: int, overlap_ratio: int) -> tuple[np.ndarray, int]:
    """Frame start offsets and overlap length for a uniformly-framed
    stream: each frame after the first re-reads the trailing
    `fsize - fsize*(r-1)//r` samples of its predecessor."""
    if overlap_ratio > 1:
        olap = fsize - fsize * (overlap_ratio - 1) // overlap_ratio
    else:
        olap = 0
    hop = fsize - olap
    if total <= fsize:
        return np.array([0], dtype=np.int64), olap
    n_extra = -(-(total - fsize) // hop)
    starts = np.concatenate([[0], fsize - olap + hop * np.arange(n_extra)])
    return starts.astype(np.int64), olap
