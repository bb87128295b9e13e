"""Profile 2 — lossy DCT codec with Temporal Noise Shaping (experimental):
the host helpers of the batch pipeline and the per-frame encode
(`analogue`) and decode (`digital`).

Profile 1's chain with the TNS analysis between masking and quantisation.
Payload layout: raw DEFLATE (wbits=-15) of
`[u16be lpc_len][lpc EGR][u32be thres_len][thres EGR][freqs EGR]`. Kept
out of AVAILABLE, as in the JAX package and the reference, but
implemented; its depth table differs from Profile 1's. The tensor chain
(DCT, masking, order-12 LPC, FIR analysis / IIR synthesis, quantisation)
lives in `models/batch.py`; a single frame runs it as a batch of one.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from ..ops import golomb, policy, psycho, tns
from . import batch
from .profile1 import _scale_factor, _untrim, prepare_frame

DEPTHS = (8, 10, 12, 14, 16, 20, 24)

ORDER1 = tns.MAX_ORDER + 1


def pack_streams(freqs_flat: np.ndarray, thres_flat: np.ndarray,
                 lpc_flat: np.ndarray) -> bytes:
    """EGR-encode + frame layout + DEFLATE."""
    lpc_gol = golomb.encode(lpc_flat)
    thres_gol = golomb.encode(thres_flat)
    freqs_gol = golomb.encode(freqs_flat)
    frad = (struct.pack(">H", len(lpc_gol)) + lpc_gol
            + struct.pack(">I", len(thres_gol)) + thres_gol + freqs_gol)
    return zlib.compress(frad, wbits=-15)


def unpack_streams(frad: bytes) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Inverse of `pack_streams` -> (freqs, thres, lpc) symbols; None on a
    corrupt payload."""
    try:
        frad = zlib.decompress(frad, wbits=-15)
    except zlib.error:
        return None
    if len(frad) < 6:
        return None
    (lpc_len,) = struct.unpack(">H", frad[:2])
    lpc_gol = frad[2:2 + lpc_len]
    frad = frad[2 + lpc_len:]
    if len(frad) < 4:
        return None
    (thres_len,) = struct.unpack(">I", frad[:4])
    thres_gol = frad[4:4 + thres_len]
    freqs_gol = frad[4 + thres_len:]
    return golomb.decode(freqs_gol), golomb.decode(thres_gol), golomb.decode(lpc_gol)


def untrim_streams(streams: tuple[np.ndarray, np.ndarray, np.ndarray] | None,
                   fsize: int, channels: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Unpacked symbol streams padded up to / trimmed down to the frame
    grid (a corrupt payload may decode to a ragged length) -> float64
    (freqs [fsize*channels], thres [27*channels], lpc [13*channels]);
    zeros for a payload that did not unpack."""
    sizes = (fsize, psycho.SUBBANDS, ORDER1)
    if streams is None:
        return tuple(np.zeros(n * channels) for n in sizes)
    return tuple(_untrim(s.astype(np.float64), n, channels)[: n * channels]
                 for s, n in zip(streams, sizes))


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

    fq, tq, lq = batch.p2_encode_core(
        policy.to_device(pcm[None].astype(policy.compute_dtype()), device), srate,
        loss_level, factor)
    fqh, tqh, lqh = policy.to_host(fq, tq, lq)
    return (pack_streams(fqh[0].ravel(), tqh[0].ravel(), lqh[0].ravel()),
            DEPTHS.index(bits), channels, srate)


def digital(frad: bytes, bit_depth_index: int, channels: int, srate: int, fsize: int,
            device: torch.device) -> np.ndarray:
    """Decode one frame payload -> [fsize, channels] f64 PCM; a corrupt
    payload, or a depth index past the table, decodes to a zero frame."""
    if bit_depth_index >= len(DEPTHS):
        return np.zeros((fsize, channels))
    factor = _scale_factor(DEPTHS[bit_depth_index])

    streams = unpack_streams(frad)
    if streams is None:
        return np.zeros((fsize, channels))
    freqs, thres, lpc = untrim_streams(streams, fsize, channels)

    dt = policy.compute_dtype()
    pcm = batch.p2_decode_core(
        policy.to_device(freqs.reshape(1, fsize, channels).astype(dt), device),
        policy.to_device(thres.reshape(1, psycho.SUBBANDS, channels).astype(dt), device),
        policy.to_device(lpc.reshape(1, ORDER1, channels).astype(dt), device),
        srate, factor)
    (out,) = policy.to_host(pcm[0])
    return out.astype(np.float64)
