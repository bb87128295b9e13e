"""Profile 1 — lossy DCT codec with psychoacoustic quantisation: the host
helpers of the batch pipeline and the streaming engines' per-frame
encode (`analogue`) and decode (`digital`).

Payload layout: raw DEFLATE (wbits=-15) of
`[u32be thres_len][thres EGR][freqs EGR]`. The tensor chain lives in
`models/batch.py`; a single frame runs it as a batch of one.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from ..ops import golomb, policy, psycho
from . import batch
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


def frame_params(n: int, srate: int, loss_level: float) -> tuple[int, int, float]:
    """(length on the compact frame grid, srate, loss level) of an
    n-sample frame, as `prepare_frame` pads and coerces them."""
    return (compact.get_samples_min_ge(max(n, 1)), compact.get_valid_srate(srate),
            max(abs(loss_level), 0.125))


def prepare_frame(pcm: np.ndarray, srate: int, loss_level: float):
    """Pad to the compact frame grid, coerce srate and loss level."""
    pcm = np.asarray(pcm, dtype=np.float64)
    dlen, srate, loss_level = frame_params(len(pcm), srate, loss_level)
    if dlen > len(pcm):
        pcm = np.pad(pcm, ((0, dlen - len(pcm)), (0, 0)))
    return pcm, srate, loss_level


def analogue(pcm: np.ndarray, bits: int, srate: int, loss_level: float,
             device: torch.device) -> tuple[bytes, int, int, int]:
    """Encode one frame: [fsize, channels] f64 PCM -> (payload, depth index,
    channels, srate). The tensor chain runs on `device` at
    `policy.compute_dtype()`."""
    if bits not in DEPTHS:
        bits = 16
    factor = _scale_factor(bits)
    pcm, srate, loss_level = prepare_frame(pcm, srate, loss_level)
    channels = pcm.shape[1]

    fq, tq = batch.p1_encode_core(
        policy.to_device(pcm[None].astype(policy.compute_dtype()), device), srate,
        loss_level, factor)
    fqh, tqh = policy.to_host(fq, tq)
    # [1, N, C] -> channel-interleaved symbols
    return pack_streams(fqh[0].ravel(), tqh[0].ravel()), DEPTHS.index(bits), channels, srate


def digital(frad: bytes, bit_depth_index: int, channels: int, srate: int, fsize: int,
            device: torch.device, compute_dtype: str | None = None) -> np.ndarray:
    """Decode one frame payload -> [fsize, channels] f64 PCM at
    `compute_dtype` (None: `policy.compute_dtype()`); a corrupt payload, or
    a depth index past the table, decodes to a zero frame."""
    if bit_depth_index >= len(DEPTHS):
        return np.zeros((fsize, channels))
    factor = _scale_factor(DEPTHS[bit_depth_index])

    streams = unpack_streams(frad)
    if streams is None:
        return np.zeros((fsize, channels))
    freqs_ints, thres_ints = streams

    # pad up to / trim down to the frame grid (a corrupt payload may
    # decode to a ragged length)
    freqs = _untrim(freqs_ints.astype(np.float64), fsize, channels)[: fsize * channels]
    thres = _untrim(thres_ints.astype(np.float64), psycho.SUBBANDS,
                    channels)[: psycho.SUBBANDS * channels]
    dt = policy.check_compute_dtype(compute_dtype)
    pcm = batch.p1_decode_core(
        policy.to_device(freqs.reshape(1, fsize, channels).astype(dt), device),
        policy.to_device(thres.reshape(1, psycho.SUBBANDS, channels).astype(dt), device),
        srate, factor)
    (out,) = policy.to_host(pcm[0])
    return out.astype(np.float64)
