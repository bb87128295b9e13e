"""Batched Profile 0 and Profile 1 cores over a frame batch [B, N, C], as
torch ops on one device.

Profile 0: the DCT-II / IDCT of `ops/dct.py` (the float32 GEMM, or the
FFT form at float64 and above N = 8192), and the fast path's fused
pairs: DCT GEMM -> `trunc_pack` kernel (payload words and each frame's
max|x|), and `trunc_unpack` kernel -> IDCT GEMM.

Encode: PCM -> DCT-II GEMM -> masking thresholds (band-sum GEMM, RMS^0.8,
AHT floor, x loss) -> interpolation GEMM -> `power_quant` kernel ->
threshold log-compand. Decode: dequant + threshold expansion ->
interpolation GEMM -> IDCT GEMM (`p1_decode_core`) -> `overlap_add`
kernel (`p1_decode_oa_core`). The GEMMs are
`torch.matmul` at full float32; the two elementwise stages that the JAX
package wrote as Pallas kernels are the hand-written CUDA kernels of
`kernels/`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.overlap_add import crossfade_window, overlap_add
from ..kernels.power_quant import power_quant
from ..kernels.trunc_pack import trunc_pack
from ..kernels.trunc_unpack import trunc_unpack
from ..ops import bitpack, psycho
from ..ops.dct import dct2, idct2

_E_HALF = np.e / 2.0


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
    """`p0_encode_pack_core` of int24 PCM words [B, n*ch*3//4]: the upload
    carries 3 bytes a sample."""
    frames = bitpack.i24_words_to_pcm_device(words).reshape(words.shape[0], n, ch)
    return p0_encode_pack_core(frames, bits, little)


def p0_unpack_decode_core(words: torch.Tensor, bits: int, little: bool, n: int,
                          ch: int) -> torch.Tensor:
    """Payload words [B, W] -> [B, n, ch] float32 PCM: the `trunc_unpack`
    kernel, then the IDCT GEMM; the upload carries the payload bytes."""
    return idct2(trunc_unpack(words, bits, little, n, ch)).transpose(1, 2)


def p0_unpack_decode_i24_core(words: torch.Tensor, bits: int, little: bool, n: int,
                              ch: int) -> torch.Tensor:
    """`p0_unpack_decode_core` returning int24 PCM words [B, n*ch*3//4]:
    the copy to the host carries 3 bytes a sample."""
    return bitpack.pcm_to_i24_words(p0_unpack_decode_core(words, bits, little, n, ch))


def p1_encode_core(frames: torch.Tensor, srate: int, loss_level: float, factor: float):
    """[B, N, C] float32 PCM -> (freqs_q [B, N, C] int32, thres_q [B, 27, C] int32)."""
    b, n, c = frames.shape
    x = frames.transpose(1, 2)                                  # [B, C, N]
    freqs = dct2(x)
    thres = psycho.mask_thres_mos(torch.abs(freqs) * factor, srate, loss_level)
    div = psycho.mapping_from_opus(thres, n, srate)
    freqs_q = power_quant(freqs.reshape(b * c, n), div.reshape(b * c, n),
                          factor).reshape(b, c, n)
    log_base = torch.log(torch.tensor(_E_HALF, dtype=torch.float32, device=frames.device))
    thres_q = torch.round(
        psycho.dequant(torch.log(torch.clamp(thres, min=1.0)) / log_base)
    ).to(torch.int32)
    return freqs_q.transpose(1, 2), thres_q.transpose(1, 2)


def p1_encode_core_i16(frames_i16: torch.Tensor, srate: int, loss_level: float, factor: float):
    """`p1_encode_core` on [B, N, C] int16 PCM (x * 32768): the upload
    carries 2 bytes per sample; the cast back is exact."""
    frames = frames_i16.to(torch.float32) * (1.0 / 32768.0)
    return p1_encode_core(frames, srate, loss_level, factor)


def p1_decode_core(freqs_flat: torch.Tensor, thres_flat: torch.Tensor,
                   srate: int, factor: float) -> torch.Tensor:
    """Profile 1 decode without overlap-add.

    freqs_flat [B, N, C] symbols (int16 — exact for EGR symbols — or
    float32), thres_flat [B, 27, C] float32 -> [B, N, C] float32 PCM (a
    transposed view of the IDCT's [B, C, N] output)."""
    if freqs_flat.dtype == torch.int16:
        freqs_flat = freqs_flat.to(torch.float32)
    n = freqs_flat.shape[1]
    masked = psycho.dequant(freqs_flat.transpose(1, 2)) / factor     # [B, C, N]
    e_half = torch.tensor(_E_HALF, dtype=torch.float32, device=freqs_flat.device)
    thres = torch.pow(e_half, psycho.quant(thres_flat.transpose(1, 2)))
    div = psycho.mapping_from_opus(thres, n, srate)
    return idct2(masked * div).transpose(1, 2)


def p1_decode_oa_core(freqs_flat: torch.Tensor, thres_flat: torch.Tensor,
                      srate: int, factor: float, olap: int, cut: int, i16: bool):
    """`p1_decode_core` + overlap-add of one uniform run -> (pcm_out
    [B, cut, C], int16 x32768 when `i16` else float32; fragment [olap, C]
    float32, the raw tail of the last frame that the next run crossfades
    in)."""
    pcm = p1_decode_core(freqs_flat, thres_flat, srate, factor).transpose(1, 2)  # [B, C, N]
    return overlap_add(pcm.contiguous(), crossfade_window(olap, pcm.device), cut, i16)


def overlap_add_core(frames: torch.Tensor, olap: int, cut: int) -> torch.Tensor:
    """[B, N, C] decoded float32 frames -> [B, cut, C] overlap-added PCM
    (frame 0's head fade-free; the stream tail is frames[-1, cut:])."""
    out, _ = overlap_add(frames.transpose(1, 2).contiguous(),
                         crossfade_window(olap, frames.device), cut, False)
    return out


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
