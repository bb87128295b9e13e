"""`egr_pack`: Profile 1's Exp-Golomb-Rice bit-packer with the compaction
of each frame's used words.

The port of the JAX package's XLA device programs (frad_python_tpu/ops/
bitpack.py:egr_pack_frames and the word compaction of frad_python_tpu/
parallel/pipeline.py:_egr_compact_packer). `egr_pack` launches the CUDA
kernels (csrc/egr_pack.cu) for CUDA tensors and runs `egr_pack_plain`
for CPU tensors. Words are int32 tensors holding the uint32 bit pattern
(the host views them as '<u4'), so a copy to the host carries four bytes
a word.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import bitpack
from . import build


def egr_pack_plain(symbols: torch.Tensor, max_words: int, padded: bool = False):
    """[B, M] integer symbol frames -> (flat, used, total_bits, k, overflow),
    all int32: `flat` [sum(used)] is every row's used words in row order,
    big-endian bit order inside each word; `used` [B] is
    ceil(total_bits / 32), 0 for a row flagged `overflow` (1 where
    total_bits > 32 * max_words: its words are not valid and the caller
    codes it on the host); `k` [B] the Rice parameter. With `padded` the
    zero-padded words [B, max_words] follow as a sixth tensor."""
    words, total_bits, k, overflow = bitpack.egr_pack_frames(symbols, max_words)
    flat, used = bitpack.compact_words(words, total_bits, overflow)
    out = (bitpack._wrap(flat, 32, torch.int32), used.to(torch.int32),
           total_bits.to(torch.int32), k.to(torch.int32), overflow.to(torch.int32))
    return out + (bitpack._wrap(words, 32, torch.int32),) if padded else out


def egr_pack(symbols: torch.Tensor, max_words: int, padded: bool = False):
    """See `egr_pack_plain`; one call of the kernels' C entry (pack, scan
    of `used`, copy) for CUDA tensors.

    `flat` is a slice of a [B * max_words] buffer whose length, the sum of
    `used`, is read back from the device: one synchronisation, which the
    plain version's mask indexing pays too, and the copy to the host then
    carries the stream's words only."""
    if symbols.device.type == "cpu":
        return egr_pack_plain(symbols, max_words, padded)
    if symbols.device.type != "cuda":
        raise ValueError(f"egr_pack: tensor on {symbols.device}")
    if symbols.dtype != torch.int32 or symbols.dim() != 2 or not symbols.is_contiguous() \
            or min(symbols.shape) < 1 or max_words < 1:
        raise ValueError(f"egr_pack: contiguous [B >= 1, M >= 1] int32 symbols and max_words >= 1 "
                         f"required, got {tuple(symbols.shape)} {symbols.dtype}, {max_words}")
    b, m = symbols.shape
    dev = symbols.device
    words = torch.empty((b, max_words), dtype=torch.int32, device=dev)
    flat = torch.empty(b * max_words, dtype=torch.int32, device=dev)
    meta = torch.empty((4, b), dtype=torch.int32, device=dev)
    offs = torch.empty(b + 1, dtype=torch.int64, device=dev)
    lib = build.library()
    err = lib.frad_egr_pack(
        ctypes.c_void_p(symbols.data_ptr()), ctypes.c_void_p(words.data_ptr()),
        ctypes.c_void_p(meta.data_ptr()), ctypes.c_void_p(offs.data_ptr()),
        ctypes.c_void_p(flat.data_ptr()), b, m, int(max_words),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    build.check("frad_egr_pack", err)
    egr_pack.launches += 1
    out = (flat[: int(offs[b])], meta[0], meta[1], meta[2], meta[3])
    return out + (words,) if padded else out


#: calls of the kernels' C entry since the last reset (CPU calls do not count)
egr_pack.launches = 0
