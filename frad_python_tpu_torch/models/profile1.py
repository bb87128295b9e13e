"""Profile 1 — lossy DCT codec with psychoacoustic quantisation: the host
helpers of the batch pipeline.

Payload layout: raw DEFLATE (wbits=-15) of
`[u32be thres_len][thres EGR][freqs EGR]`. The tensor chain lives in
`models/batch.py`.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ..ops import golomb
from .profiles import compact

DEPTHS = (8, 12, 16, 24, 32, 48, 64)


def _scale_factor(bits: int) -> float:
    """2^(bits-1)."""
    return float(2.0 ** (bits - 1))


def _untrim(arr: np.ndarray, fsize: int, channels: int) -> np.ndarray:
    """Zero-pad a flat array up to fsize*channels."""
    need = fsize * channels - len(arr)
    return np.pad(arr, (0, max(0, need))) if need > 0 else arr


def pack_streams(freqs_flat: np.ndarray, thres_flat: np.ndarray) -> bytes:
    """EGR-encode + frame layout + DEFLATE."""
    thres_gol = golomb.encode(thres_flat)
    freqs_gol = golomb.encode(freqs_flat)
    frad = struct.pack(">I", len(thres_gol)) + thres_gol + freqs_gol
    return zlib.compress(frad, wbits=-15)


def unpack_streams(frad: bytes) -> tuple[np.ndarray, np.ndarray] | None:
    """Inverse of `pack_streams`; None on a corrupt payload."""
    try:
        frad = zlib.decompress(frad, wbits=-15)
    except zlib.error:
        return None
    if len(frad) < 4:
        return None
    (thres_len,) = struct.unpack(">I", frad[:4])
    thres_gol = frad[4:4 + thres_len]
    freqs_gol = frad[4 + thres_len:]
    return golomb.decode(freqs_gol), golomb.decode(thres_gol)


def prepare_frame(pcm: np.ndarray, srate: int, loss_level: float):
    """Pad to the compact frame grid, coerce srate and loss level."""
    pcm = np.asarray(pcm, dtype=np.float64)
    dlen = compact.get_samples_min_ge(max(len(pcm), 1))
    if dlen > len(pcm):
        pcm = np.pad(pcm, ((0, dlen - len(pcm)), (0, 0)))
    return pcm, compact.get_valid_srate(srate), max(abs(loss_level), 0.125)
