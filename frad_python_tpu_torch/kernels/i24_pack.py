"""`i24_pack`: float32 PCM -> int24 fixed-point words, the form in which
the Profile 0 decoder's PCM is copied back to the host at 3 bytes a sample.

The port of the XLA device program `pcm_to_i24_words` (frad_python_tpu/
ops/bitpack.py). `i24_pack` launches the CUDA kernel (csrc/i24_pack.cu)
for CUDA tensors and runs `i24_pack_plain` for CPU tensors. Words are
int32 tensors holding the uint32 bit pattern (the host views them as
'<u4').
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import bitpack
from . import build


def i24_pack_plain(pcm: torch.Tensor) -> torch.Tensor:
    """[B, N, C] float PCM -> int24 fixed-point words [B, N*C*3//4] int32:
    clamp(round(x * 2^23), -2^23, 2^23 - 1) & 0xFFFFFF in float32 (round to
    nearest, ties to even), four samples as three little-endian words: 3
    bytes a sample over the link, a -138 dB quantisation floor.

    +-Inf and values past +-1 clamp to -2^23 / 2^23 - 1. A NaN passes
    `round` and `clamp` and becomes 0 in the integer cast: the CPU's
    conversion gives the int64 minimum, whose low 24 bits are 0, and the
    GPU's gives 0. N * C must be a multiple of 4."""
    b = pcm.shape[0]
    v = torch.clamp(torch.round(pcm.to(torch.float32) * float(1 << 23)),
                    -(1 << 23), (1 << 23) - 1)
    t = v.to(torch.int64) & 0xFFFFFF
    return bitpack._pack_byte_triples(t.reshape(b, -1), msb_first=False)


def i24_pack(pcm: torch.Tensor) -> torch.Tensor:
    """See `i24_pack_plain`; one kernel launch for a CUDA tensor, float32
    [B, N, C] of any strides (the decoder hands over a transposed view of
    the IDCT's [B, C, N] output; the kernel reads through the strides)."""
    if pcm.device.type == "cpu":
        return i24_pack_plain(pcm)
    if pcm.device.type != "cuda":
        raise ValueError(f"i24_pack: tensor on {pcm.device}")
    if pcm.dtype != torch.float32 or pcm.dim() != 3 or pcm.shape[0] < 1 \
            or pcm.shape[1] * pcm.shape[2] < 4 or (pcm.shape[1] * pcm.shape[2]) % 4:
        raise ValueError(f"i24_pack: float32 [B >= 1, N, C] with N * C a positive multiple of 4 "
                         f"required, got {tuple(pcm.shape)} {pcm.dtype}")
    b, n, ch = pcm.shape
    m = n * ch
    words = torch.empty((b, m * 3 // 4), dtype=torch.int32, device=pcm.device)
    sb, sn, sc = pcm.stride()
    lib = build.library()
    with build.on_device("i24_pack", pcm) as stream:
        err = lib.frad_i24_pack(
            ctypes.c_void_p(pcm.data_ptr()), ctypes.c_void_p(words.data_ptr()), b, m, ch,
            sb, sn, sc, stream)
    build.check("frad_i24_pack", err)
    i24_pack.launches += 1
    return words


#: kernel launches since the last reset (CPU calls do not count)
i24_pack.launches = 0
