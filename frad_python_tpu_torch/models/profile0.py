"""Profile 0 — lossless DCT archival codec: the streaming engines'
per-frame encode (`analogue`) and decode (`digital`).

Encode: forward DCT-II (norm='forward') over each channel -> bit-depth
escalation when a coefficient leaves the container float's range ->
truncated-float packing at 12..64 bits (`ops/packing.py`). Decode: unpack,
NaN/Inf scrub, inverse DCT. The transform runs on `device` as a batch of
one frame (`models/batch.py`) at `policy.transform_dtype(bits)`: float32
(the GEMM) or float64 (the FFT form, always for the 48- and 64-bit
containers).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import packing, policy
from . import batch

DEPTHS = packing.DEPTHS


def _forward(pcm: np.ndarray, dt: str, device: torch.device) -> np.ndarray:
    """[N, C] f64 PCM -> [N, C] f64 DCT coefficients computed at `dt`."""
    (out,) = policy.to_host(batch.p0_encode_core(policy.to_device(pcm[None].astype(dt), device)))
    return out[0].astype(np.float64)


def _escalates_deep(max_abs: float, bits: int) -> bool:
    """True when depth escalation from `bits` would land in a container
    deeper than float32 precision (an f32 overflow shows as inf)."""
    if not np.isfinite(max_abs):
        return True
    try:
        return packing.needed_depth(max_abs, bits) >= policy.DEEP_BITS
    except OverflowError:
        return True


def analogue(pcm: np.ndarray, bits: int, srate: int, little_endian: bool,
             device: torch.device) -> tuple[bytes, int, int, int]:
    """Encode one frame: [fsize, channels] f64 PCM -> (payload, depth index,
    channels, srate)."""
    if bits not in DEPTHS:
        bits = 16
    channels = pcm.shape[1] if pcm.ndim > 1 else 1
    pcm = np.asarray(pcm, dtype=np.float64).reshape(-1, channels)

    dt = policy.transform_dtype(bits)
    freqs = _forward(pcm, dt, device)
    max_abs = float(np.max(np.abs(freqs))) if freqs.size else 0.0
    if dt != "float64" and _escalates_deep(max_abs, bits):
        # the escalation reaches a container deeper than float32 (perhaps
        # through an f32 overflow to inf): redo at float64, whose exponent
        # range the 48-bit container shares, so escalation stops there
        freqs = _forward(pcm, "float64", device)
        max_abs = float(np.max(np.abs(freqs))) if freqs.size else 0.0
    bits = packing.needed_depth(max_abs, bits)
    return packing.pack_floats(freqs.ravel(), bits, little_endian), DEPTHS.index(bits), \
        channels, srate


def digital(frad: bytes, bit_depth_index: int, channels: int, little_endian: bool,
            fsize: int, device: torch.device, compute_dtype: str | None = None) -> np.ndarray:
    """Decode one frame payload -> [len(values) // channels, channels] f64
    PCM. A payload the JAX package's decoder cannot decode (a depth index
    past the table, a 16/32/64-bit payload of a partial value, no whole
    row for the float32 GEMM) decodes, as there, to a zero frame of
    `fsize` rows; no whole row at float64 decodes to no rows. Below 48
    bits the transform runs at `compute_dtype` (None: the environment's,
    `policy.compute_dtype()`)."""
    if bit_depth_index >= len(DEPTHS) or not packing.whole_values(
            len(frad), DEPTHS[bit_depth_index]):
        return np.zeros((fsize, max(channels, 1)))
    bits = DEPTHS[bit_depth_index]
    dt = policy.transform_dtype(bits, compute_dtype)
    flat = packing.unpack_floats(frad, bits, little_endian)
    n = (len(flat) // channels) * channels
    if n == 0:
        return np.zeros((0, channels) if dt == "float64" else (fsize, max(channels, 1)))
    freqs = flat[:n].reshape(1, -1, channels).astype(dt)
    (out,) = policy.to_host(batch.p0_decode_core(policy.to_device(freqs, device)))
    return out[0].astype(np.float64)
