"""Exp-Golomb-Rice bit-packing on the device, as plain torch ops.

The emitted words reproduce the host EGR codec (`ops/golomb.py`) bit for
bit: same k, same signed mapping, same unary+binary codes, zero padding.
Bit work runs in int64 and is masked to 32 bits, because torch's uint32
lacks shifts and scatter-add on some devices; words are returned as
int64 holding uint32 values.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF


def _bitlen(v: torch.Tensor) -> torch.Tensor:
    """Exact bit length of non-negative int64 values < 2^53 (frexp of f64)."""
    _, e = torch.frexp(v.to(torch.float64))
    return e.to(torch.int64)


def egr_pack_frames(symbols: torch.Tensor, max_words: int):
    """Pack [B, M] integer symbol frames into EGR bitstreams.

    Returns (words [B, max_words] int64 holding uint32 — big-endian bit
    order within each word —, total_bits [B] int64, k [B] int64, overflow
    [B] bool). Frames flagged `overflow` exceeded max_words*32 bits; their
    words are not valid and they are re-encoded on the host.
    """
    b, m = symbols.shape
    s = symbols.to(torch.int64)

    dmax = s.abs().amax(dim=1)                                   # [B]
    k = _bitlen(torch.clamp(dmax - 1, min=0))                    # ceil(log2(dmax))
    mapped = torch.where(s > 0, 2 * s - 1, -2 * s)
    v = mapped + torch.bitwise_left_shift(torch.ones_like(k), k)[:, None]

    blen = _bitlen(v)
    code_len = 2 * blen - k[:, None] - 1

    end = torch.cumsum(code_len, dim=1)                          # inclusive ends
    total_bits = end[:, -1]
    overflow = total_bits > max_words * 32

    # value v occupies stream bits [end-blen, end); split across <= 2 words
    start = end - blen
    w0 = start >> 5
    w1 = (end - 1) >> 5

    def word_contrib(w: torch.Tensor) -> torch.Tensor:
        # bits [blo, bhi) of the value that land in word w, placed
        # big-endian at their offset inside the word
        blo = torch.maximum(start, w << 5)
        bhi = torch.minimum(end, (w << 5) + 32)
        chunk = (v >> (end - bhi)) & ((torch.ones_like(v) << (bhi - blo)) - 1)
        return (chunk << ((w << 5) + 32 - bhi)) & _MASK32

    c0 = word_contrib(w0)
    two = w1 > w0
    c1 = torch.where(two, word_contrib(w1), torch.zeros_like(v))
    base = (torch.arange(b, device=s.device, dtype=torch.int64) * max_words)[:, None]
    flat = torch.zeros(b * max_words, dtype=torch.int64, device=s.device)
    flat.index_add_(0, (base + torch.clamp(w0, max=max_words - 1)).reshape(-1),
                    c0.reshape(-1))
    flat.index_add_(0, (base + torch.clamp(w1, max=max_words - 1)).reshape(-1),
                    c1.reshape(-1))
    words = (flat & _MASK32).reshape(b, max_words)
    return words, total_bits, k, overflow


def compact_words(words: torch.Tensor, total_bits: torch.Tensor,
                  overflow: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row's used words (ceil(total_bits/32), none for overflow rows),
    gathered in row order into one flat tensor. Returns (flat, used [B])."""
    used = torch.where(overflow, torch.zeros_like(total_bits), (total_bits + 31) // 32)
    j = torch.arange(words.shape[1], device=words.device)
    return words[j[None, :] < used[:, None]], used


def words_to_stream(words: np.ndarray, total_bits: int, k: int) -> bytes:
    """Host finisher: one frame's packed words -> EGR byte stream
    (k header byte + ceil(total_bits/8) big-endian bytes)."""
    nbytes = (int(total_bits) + 7) // 8
    raw = words.astype(">u4").tobytes()[:nbytes]
    return bytes([int(k)]) + raw
