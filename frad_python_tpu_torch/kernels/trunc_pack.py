"""`trunc_pack`: the Profile 0 encoder's truncated-float packing of the DCT
output, with the per-frame max|x| of the bit-depth escalation check.

The port of the JAX package's fused XLA program (frad_python_tpu/ops/
bitpack.py:trunc_pack after the DCT in models/batch.py:_p0_encode_pack_jit).
`trunc_pack` launches the CUDA kernel (csrc/trunc_pack.cu) for CUDA
tensors and runs `trunc_pack_plain` for CPU tensors.

The kernel gives each thread one group of `GROUP` consecutive values of a
frame's interleaved row and each frame one cluster of at most
`MAX_CLUSTER` blocks; `geometry` picks the blocks and threads.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import bitpack
from . import build


#: values a thread of the kernel packs (one group: four 16-byte loads)
GROUP = 16
#: most blocks a frame's cluster holds (the portable cluster size)
MAX_CLUSTER = 8
#: threads a block while a frame fits in MAX_CLUSTER such blocks
BLOCK = 256


def geometry(c: int, n: int) -> tuple[int, int]:
    """(blocks a frame, threads a block) of the kernel for frames of c
    channels of n values: enough threads that each holds one group of
    GROUP values (a frame of up to MAX_CLUSTER * 1024 groups), in blocks of
    BLOCK threads or, past MAX_CLUSTER such blocks, in MAX_CLUSTER larger
    ones; threads a whole number of warps. Larger frames loop."""
    groups = -(-c * n // GROUP)
    blocks = max(1, min(MAX_CLUSTER, -(-groups // BLOCK)))
    threads = min(1024, (-(-groups // blocks) + 31) // 32 * 32)
    return blocks, threads


def _words_shape(b: int, m: int, bits: int) -> tuple[tuple[int, int], torch.dtype]:
    if bits == 16:
        return (b, m), torch.int16
    return (b, m * 3 // 4 if bits == 24 else m), torch.int32


def trunc_pack_plain(y: torch.Tensor, bits: int, little: bool):
    """y [B, C, N] float32 DCT output -> (words, maxabs [B] float32).

    words: the payloads of the frame-major interleaved rows (value t*C + c
    is y[b, c, t]), int16 [B, N*C] at 16 bits and int32 [B, N*C*3//4] or
    [B, N*C] at 24 or 32 bits, whose little-endian bytes are
    `packing.pack_floats` of the row. maxabs is NaN for a frame holding a
    NaN."""
    b = y.shape[0]
    flat = y.transpose(1, 2).reshape(b, -1)
    return bitpack.trunc_pack_plain(flat, bits, little), flat.abs().amax(dim=1)


def trunc_pack(y: torch.Tensor, bits: int, little: bool):
    """See `trunc_pack_plain`; one kernel launch for CUDA tensors."""
    if y.device.type == "cpu":
        return trunc_pack_plain(y, bits, little)
    if y.device.type != "cuda":
        raise ValueError(f"trunc_pack: tensor on {y.device}")
    if y.dtype != torch.float32 or y.dim() != 3 or not y.is_contiguous():
        raise ValueError(f"trunc_pack: contiguous float32 [B, C, N] required, got "
                         f"{y.dtype} {tuple(y.shape)}")
    b, c, n = y.shape
    if bits not in bitpack.TRUNC_DEVICE_BITS or (bits == 24 and (c * n) % 4):
        raise ValueError(f"trunc_pack: bits {bits} with N*C = {c * n}")
    shape, dtype = _words_shape(b, c * n, bits)
    words = torch.empty(shape, dtype=dtype, device=y.device)
    maxabs = torch.empty(b, dtype=torch.float32, device=y.device)
    blocks, threads = geometry(c, n)
    lib = build.library()
    with build.on_device("trunc_pack", y) as stream:
        err = lib.frad_trunc_pack(
            ctypes.c_void_p(y.data_ptr()), ctypes.c_void_p(words.data_ptr()),
            ctypes.c_void_p(maxabs.data_ptr()), b, c, n, bits, int(bool(little)), blocks, threads,
            stream)
    build.check("frad_trunc_pack", err)
    trunc_pack.launches += 1
    return words, maxabs


#: kernel launches since the last reset (CPU calls do not count)
trunc_pack.launches = 0
