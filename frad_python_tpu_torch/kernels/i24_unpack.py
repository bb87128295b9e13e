"""`i24_unpack`: int24 fixed-point words -> float32 PCM, the form in which
the Profile 0 encoder's PCM is uploaded at 3 bytes a sample.

The port of the XLA device program `i24_words_to_pcm_device`
(frad_python_tpu/ops/bitpack.py). `i24_unpack` launches the CUDA kernel
(csrc/i24_unpack.cu) for CUDA tensors and runs `i24_unpack_plain` for CPU
tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import bitpack
from . import build


def i24_unpack_plain(words: torch.Tensor) -> torch.Tensor:
    """Inverse of `i24_pack_plain`: [B, W] int32 words (W % 3 == 0) ->
    [B, W*4//3] float32 PCM, each 24-bit value sign-extended and
    multiplied by 2^-23 (exact)."""
    c = bitpack._word_bytes(words)
    t = c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16)
    v = (t ^ 0x800000) - 0x800000
    return v.to(torch.float32) * (1.0 / (1 << 23))


def i24_unpack(words: torch.Tensor) -> torch.Tensor:
    """See `i24_unpack_plain`; one kernel launch for a CUDA tensor
    (contiguous int32 [B, W], W a positive multiple of 3)."""
    if words.device.type == "cpu":
        return i24_unpack_plain(words)
    if words.device.type != "cuda":
        raise ValueError(f"i24_unpack: tensor on {words.device}")
    if words.dtype != torch.int32 or words.dim() != 2 or not words.is_contiguous() \
            or words.shape[0] < 1 or words.shape[1] < 3 or words.shape[1] % 3:
        raise ValueError(f"i24_unpack: contiguous int32 [B >= 1, W] with W a positive multiple "
                         f"of 3 required, got {tuple(words.shape)} {words.dtype}")
    b, w = words.shape
    pcm = torch.empty((b, w * 4 // 3), dtype=torch.float32, device=words.device)
    lib = build.library()
    with build.on_device("i24_unpack", words) as stream:
        err = lib.frad_i24_unpack(
            ctypes.c_void_p(words.data_ptr()), ctypes.c_void_p(pcm.data_ptr()), b * w,
            stream)
    build.check("frad_i24_unpack", err)
    i24_unpack.launches += 1
    return pcm


#: kernel launches since the last reset (CPU calls do not count)
i24_unpack.launches = 0
