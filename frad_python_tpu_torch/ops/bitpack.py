"""Bit-packing on the device, as plain torch ops: the Exp-Golomb-Rice
packer of Profile 1, and the truncated-float packing of the lossless
profiles (below) with the host forms of their int24 transfer.

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


# ---------------------------------------------------------------------------
# Truncated-float packing of the lossless profiles on the device, and the
# int24 fixed-point PCM transfer forms. The plain versions below run as
# torch ops on any device; `kernels/trunc_pack.py` and
# `kernels/trunc_unpack.py` fuse the packing with the DCT's layout as
# CUDA kernels, and `kernels/i24_pack.py` / `kernels/i24_unpack.py` hold
# the int24 forms' kernels with their plain versions. Words are int16
# (16 bits) or int32 (24 and 32 bits)
# tensors whose little-endian byte stream is the payload: the host views
# them as '<u2' / '<u4'. torch has no shifts on uint16 / uint32, so the
# bit work runs on int32 / int64 values with explicit masks.
# ---------------------------------------------------------------------------

#: depths whose truncated-float packing runs on the device
TRUNC_DEVICE_BITS = (16, 24, 32)


def _wrap(v: torch.Tensor, bits: int, dtype: torch.dtype) -> torch.Tensor:
    """Non-negative int64 values < 2**bits -> the signed `dtype` with the
    same low `bits` bits."""
    return torch.where(v >= 1 << (bits - 1), v - (1 << bits), v).to(dtype)


def _bswap32(u: torch.Tensor) -> torch.Tensor:
    """Byte swap of int64 values holding uint32."""
    return (((u >> 24) & 0xFF) | ((u >> 8) & 0xFF00) | ((u << 8) & 0xFF0000)
            | ((u << 24) & 0xFF000000))


def _pack_byte_triples(t: torch.Tensor, msb_first: bool) -> torch.Tensor:
    """[B, M] int64 24-bit values (M % 4 == 0) -> int32 words [B, M*3//4]
    whose little-endian byte stream is the values' 3-byte serialisation."""
    b, m = t.shape
    if msb_first:
        s = torch.stack([t >> 16, (t >> 8) & 0xFF, t & 0xFF], dim=-1)
    else:
        s = torch.stack([t & 0xFF, (t >> 8) & 0xFF, t >> 16], dim=-1)
    s = s.reshape(b, m * 3 // 4, 4)
    w = s[..., 0] | (s[..., 1] << 8) | (s[..., 2] << 16) | (s[..., 3] << 24)
    return _wrap(w, 32, torch.int32)


def _word_bytes(words: torch.Tensor) -> torch.Tensor:
    """[B, W] int32 words -> [B, W*4//3, 3] int64 bytes of their
    little-endian stream, cut into triples."""
    b, w = words.shape
    u = words.to(torch.int64) & _MASK32
    c = torch.stack([u & 0xFF, (u >> 8) & 0xFF, (u >> 16) & 0xFF, u >> 24], dim=-1)
    return c.reshape(b, w * 4 // 3, 3)


def trunc_pack_plain(x: torch.Tensor, bits: int, little: bool) -> torch.Tensor:
    """[B, M] float32 -> packed words whose little-endian byte stream equals
    `packing.pack_floats(x, bits, little)`: int16 [B, M] at 16 bits (f16,
    round to nearest even), int32 [B, M*3//4] at 24 bits (the top three
    bytes of each f32; M % 4 == 0), int32 [B, M] at 32 bits."""
    x = x.to(torch.float32)
    if bits == 16:
        h = x.to(torch.float16).view(torch.int16)
        if little:
            return h
        u = h.to(torch.int64) & 0xFFFF
        return _wrap(((u >> 8) | (u << 8)) & 0xFFFF, 16, torch.int16)
    u = x.view(torch.int32).to(torch.int64) & _MASK32
    if bits == 32:
        return x.view(torch.int32) if little else _wrap(_bswap32(u), 32, torch.int32)
    if bits != 24:
        raise ValueError(f"trunc_pack: bits must be one of {TRUNC_DEVICE_BITS}, not {bits}")
    return _pack_byte_triples(u >> 8, msb_first=not little)


def trunc_unpack_plain(words: torch.Tensor, bits: int, little: bool) -> torch.Tensor:
    """Inverse of `trunc_pack_plain`: packed words -> [B, M] float32 with
    NaN and Inf scrubbed to 0."""
    if bits == 16:
        u = words.to(torch.int64) & 0xFFFF
        if not little:
            u = ((u >> 8) | (u << 8)) & 0xFFFF
        x = _wrap(u, 16, torch.int16).view(torch.float16).to(torch.float32)
    elif bits == 32:
        u = words.to(torch.int64) & _MASK32
        if not little:
            u = _bswap32(u)
        x = _wrap(u, 32, torch.int32).view(torch.float32)
    elif bits == 24:
        c = _word_bytes(words)
        if little:
            t = c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16)
        else:
            t = (c[..., 0] << 16) | (c[..., 1] << 8) | c[..., 2]
        x = _wrap(t << 8, 32, torch.int32).view(torch.float32)
    else:
        raise ValueError(f"trunc_unpack: bits must be one of {TRUNC_DEVICE_BITS}, not {bits}")
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def pcm_to_i24_words(pcm: torch.Tensor) -> torch.Tensor:
    """[B, N, C] float PCM -> int24 fixed-point words [B, N*C*3//4] int32
    (rint(x * 2^23) clamped, little-endian triples): 3 bytes a sample over
    the link, a -138 dB quantisation floor. The `i24_pack` kernel for a
    CUDA tensor, its plain version for a CPU tensor."""
    from ..kernels.i24_pack import i24_pack      # (that module imports this one)

    return i24_pack(pcm)


def i24_words_to_pcm_device(words: torch.Tensor) -> torch.Tensor:
    """Inverse of `pcm_to_i24_words` on the device: [B, W] int32 words ->
    [B, W*4//3] float32 PCM. The `i24_unpack` kernel for a CUDA tensor,
    its plain version for a CPU tensor."""
    from ..kernels.i24_unpack import i24_unpack

    return i24_unpack(words)


def pcm_to_i24_words_host(pcm: np.ndarray) -> np.ndarray:
    """Host form of `pcm_to_i24_words`: f64 PCM (size % 4 == 0) -> '<u4'
    words of rint(x * 2^23) in float64, for the encode upload."""
    from .. import native

    flat = np.ascontiguousarray(pcm, dtype=np.float64).reshape(-1)
    if native.enabled():
        tri = native.f64_to_i24(flat)
    else:
        v = np.clip(np.rint(flat * (1 << 23)), -(1 << 23), (1 << 23) - 1)
        u = v.astype(np.int64).astype(np.uint32) & np.uint32(0xFFFFFF)
        tri = np.empty(flat.size * 3, dtype=np.uint8)
        tri[0::3] = u & 0xFF
        tri[1::3] = (u >> 8) & 0xFF
        tri[2::3] = u >> 16
    return tri.view("<u4")


def i24_words_to_pcm(words: np.ndarray) -> np.ndarray:
    """Host inverse of `pcm_to_i24_words`: [B, W] words -> [B, W*4//3]
    float64 PCM."""
    from .. import native

    raw = np.ascontiguousarray(words).view("<u4").tobytes()
    if native.enabled():
        return native.i24_to_f64(raw).reshape(words.shape[0], -1)
    u8 = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
    v = (u8[:, 0].astype(np.int32) | (u8[:, 1].astype(np.int32) << 8)
         | (u8[:, 2].astype(np.int32) << 16))
    v = (v ^ 0x800000) - 0x800000
    return (v.astype(np.float64) * (1.0 / (1 << 23))).reshape(words.shape[0], -1)
