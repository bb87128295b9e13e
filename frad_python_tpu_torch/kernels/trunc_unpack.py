"""`trunc_unpack`: the Profile 0 decoder's truncated-float unpacking into
the inverse DCT's layout.

The port of the JAX package's fused XLA program (frad_python_tpu/ops/
bitpack.py:trunc_unpack before the IDCT in models/batch.py:
_p0_unpack_decode_jit). `trunc_unpack` launches the CUDA kernel
(csrc/trunc_unpack.cu) for CUDA tensors and runs `trunc_unpack_plain` for
CPU tensors.

The kernel gives each thread one group of `bins(C)` bins of every channel
(G*C consecutive payload values) and each frame a row of chunks of at most
`BLOCK` threads; `geometry` picks the chunks and threads.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import bitpack
from . import build

#: threads a block at most
BLOCK = 128


def bins(c: int) -> int:
    """Bins of every channel a thread of the kernel owns at c channels (the
    kernel's `group_bins`): 2 at C = 8, else 4, so that each channel's bins
    are one 8- or 16-byte store."""
    return 2 if c == 8 else 4


def geometry(c: int, n: int) -> tuple[int, int]:
    """(chunks a frame, threads a block) of the kernel for frames of c
    channels of n bins: one group a thread, in as few blocks of at most
    BLOCK threads as hold them, threads a whole number of warps."""
    groups = -(-n // bins(c))
    chunks = -(-groups // BLOCK)
    threads = (-(-groups // chunks) + 31) // 32 * 32
    return chunks, threads


def trunc_unpack_plain(words: torch.Tensor, bits: int, little: bool, n: int,
                       ch: int) -> torch.Tensor:
    """Payload words [B, W] (int16 at 16 bits, int32 at 24 and 32) ->
    float32 [B, ch, n] coefficients, NaN and Inf scrubbed to 0."""
    b = words.shape[0]
    flat = bitpack.trunc_unpack_plain(words, bits, little)
    return flat.reshape(b, n, ch).transpose(1, 2).contiguous()


def trunc_unpack(words: torch.Tensor, bits: int, little: bool, n: int,
                 ch: int) -> torch.Tensor:
    """See `trunc_unpack_plain`; one kernel launch for CUDA tensors."""
    if words.device.type == "cpu":
        return trunc_unpack_plain(words, bits, little, n, ch)
    if words.device.type != "cuda":
        raise ValueError(f"trunc_unpack: tensor on {words.device}")
    want = torch.int16 if bits == 16 else torch.int32
    if bits not in bitpack.TRUNC_DEVICE_BITS or words.dtype != want:
        raise ValueError(f"trunc_unpack: bits {bits} with {words.dtype} words")
    if words.dim() != 2 or not words.is_contiguous() \
            or words.shape[1] * words.element_size() != n * ch * bits // 8:
        raise ValueError(f"trunc_unpack: contiguous [B, {n * ch * bits // 8} bytes] "
                         f"words required, got {tuple(words.shape)} {words.dtype}")
    b = words.shape[0]
    out = torch.empty((b, ch, n), dtype=torch.float32, device=words.device)
    chunks, threads = geometry(ch, n)
    lib = build.library()
    with build.on_device("trunc_unpack", words) as stream:
        err = lib.frad_trunc_unpack(
            ctypes.c_void_p(words.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            b, ch, n, bits, int(bool(little)), chunks, threads,
            stream)
    build.check("frad_trunc_unpack", err)
    trunc_unpack.launches += 1
    return out


#: kernel launches since the last reset (CPU calls do not count)
trunc_unpack.launches = 0
