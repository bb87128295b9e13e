"""Profile 4 — lossless raw-PCM storage: Profile 0 without the transform.
The f64 PCM is cast to the stream depth's container float and stored with
the same truncated-float packings (`ops/packing.py`); all of it is host
work.
"""

from __future__ import annotations

import numpy as np

from ..ops import packing

DEPTHS = packing.DEPTHS


def analogue(pcm: np.ndarray, bits: int, srate: int,
             little_endian: bool) -> tuple[bytes, int, int, int]:
    """Encode one frame: [fsize, channels] f64 PCM -> (payload, depth index,
    channels, srate)."""
    if bits not in DEPTHS:
        bits = 16
    channels = pcm.shape[1] if pcm.ndim > 1 else 1
    pcm = np.asarray(pcm, dtype=np.float64).reshape(-1, channels)
    max_abs = float(np.max(np.abs(pcm))) if pcm.size else 0.0
    bits = packing.needed_depth(max_abs, bits)
    return packing.pack_floats(pcm.ravel(), bits, little_endian), DEPTHS.index(bits), \
        channels, srate


def digital(frad: bytes, bit_depth_index: int, channels: int, little_endian: bool,
            fsize: int) -> np.ndarray:
    """Decode one frame payload -> [len(values) // channels, channels] f64
    PCM; a depth index past the table or a 16/32/64-bit payload of a
    partial value decodes, as in the JAX package's decoder, to a zero
    frame of `fsize` rows."""
    if bit_depth_index >= len(DEPTHS) or not packing.whole_values(
            len(frad), DEPTHS[bit_depth_index]):
        return np.zeros((fsize, max(channels, 1)))
    flat = packing.unpack_floats(frad, DEPTHS[bit_depth_index], little_endian)
    n = (len(flat) // channels) * channels
    return flat[:n].reshape(-1, channels)
