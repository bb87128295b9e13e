"""A plain reader of FrAD byte streams, written from the format and
independent of the program: frame headers (ASFH), payload containers,
the Exp-Golomb-Rice symbol streams and the truncated-float payloads.

The reader is strict: a stream must be a run of well-formed frames from
its first byte to its last, with no resync. Anything else is a fault of
the stream under judgement, reported as a `StreamError`.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np

FRM_SIGN = b"\xff\xd0\xd2\x98"
COMPACT = (1, 2)
#: compact sample-rate table, in the order of its 4-bit index
SRATES = (96000, 88200, 64000, 48000, 44100, 32000, 24000, 22050, 16000, 12000, 11025, 8000)
#: compact frame sizes, {128, 160, 192, 224} x 2^n in the order of the 5-bit index
SAMPLES = tuple(base << sh for sh in range(8) for base in (128, 160, 192, 224))
#: bit depths by the 3-bit index, compact and lossless profiles
COMPACT_DEPTHS = (8, 12, 16, 24, 32, 48, 64)
LOSSLESS_DEPTHS = (12, 16, 24, 32, 48, 64)
#: Exp-Golomb-Rice codewords are read through a 64-bit window
_EGR_MAX_BITS = 57


class StreamError(ValueError):
    """The stream under judgement breaks the format."""


@dataclass
class Frame:
    profile: int
    little_endian: bool
    bits: int
    channels: int
    srate: int
    fsize: int
    overlap_ratio: int
    payload: bytes


def compact_size(n: int) -> int:
    """Smallest compact frame size >= n."""
    for s in SAMPLES:
        if s >= n:
            return s
    raise ValueError(f"no compact frame size holds {n} samples")


def parse(stream: bytes) -> tuple[list[Frame], list[int]]:
    """(payload frames, terminators): `terminators[j]` is the number of
    payload frames that came before terminator j."""
    mv = memoryview(stream)
    frames: list[Frame] = []
    terms: list[int] = []
    pos, end = 0, len(stream)
    while pos < end:
        if bytes(mv[pos:pos + 4]) != FRM_SIGN:
            raise StreamError(f"no frame sign at byte {pos}")
        if pos + 9 > end:
            raise StreamError(f"header cut short at byte {pos}")
        (length,) = struct.unpack(">I", mv[pos + 4:pos + 8])
        pfb = mv[pos + 8]
        profile, ecc, little, depth_idx = pfb >> 5, (pfb >> 4) & 1, (pfb >> 3) & 1, pfb & 7
        if ecc:
            raise StreamError("ECC armor is not stated by any configuration judged here")
        if profile in COMPACT:
            if pos + 12 > end:
                raise StreamError(f"compact header cut short at byte {pos}")
            (css,) = struct.unpack(">H", mv[pos + 9:pos + 11])
            srate_idx, fsize_idx = (css >> 6) & 0xF, (css >> 1) & 0x1F
            if srate_idx >= len(SRATES) or fsize_idx >= len(SAMPLES):
                raise StreamError(f"compact table index past its table at byte {pos}")
            channels, srate, fsize = (css >> 10) + 1, SRATES[srate_idx], SAMPLES[fsize_idx]
            olap_byte = mv[pos + 11]
            if css & 1:
                if length != 0:
                    raise StreamError(f"terminator with a payload at byte {pos}")
                terms.append(len(frames))
                pos += 12
                continue
            head = 12
            bits = COMPACT_DEPTHS[depth_idx]
            overlap = olap_byte + 1 if olap_byte else 0
            crc = None
        else:
            if pos + 32 > end:
                raise StreamError(f"lossless header cut short at byte {pos}")
            channels = mv[pos + 9] + 1
            (srate,) = struct.unpack(">I", mv[pos + 12:pos + 16])
            (fsize,) = struct.unpack(">I", mv[pos + 24:pos + 28])
            (crc,) = struct.unpack(">I", mv[pos + 28:pos + 32])
            head = 32
            if depth_idx >= len(LOSSLESS_DEPTHS):
                raise StreamError(f"lossless depth index {depth_idx} at byte {pos}")
            bits = LOSSLESS_DEPTHS[depth_idx]
            overlap = 0
        if length == 0xFFFFFFFF:
            raise StreamError("64-bit frame lengths are not expected at these sizes")
        start = pos + head
        if start + length > end:
            raise StreamError(f"payload cut short at byte {pos}")
        payload = bytes(mv[start:start + length])
        if crc is not None and (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            raise StreamError(f"CRC-32 mismatch in the frame at byte {pos}")
        frames.append(Frame(profile, bool(little), bits, channels, srate, fsize, overlap, payload))
        pos = start + length
    return frames, terms


def egr_decode(blobs: list[bytes], count: int) -> np.ndarray:
    """Exp-Golomb-Rice streams (a k byte, then per value m zero bits and the
    m + k + 1 binary digits of v = map(x) + 2^k, map(x) = 2x - 1 for x > 0,
    -2x otherwise; zero bits pad the last byte) -> [len(blobs), count]
    int64, exactly `count` values each. Vectorised over the streams: one
    step per codeword index, every stream's codeword read through a 64-bit
    window at its bit position."""
    nstreams = len(blobs)
    if nstreams == 0:
        return np.zeros((0, count), dtype=np.int64)
    lens = np.fromiter((len(b) for b in blobs), dtype=np.int64, count=nstreams)
    if (lens < 1).any():
        raise StreamError("an empty symbol stream")
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    buf = np.frombuffer(b"".join(blobs) + bytes(8), dtype=np.uint8)
    window = np.ndarray((len(buf) - 7,), dtype=">u8", buffer=buf, strides=(1,))
    k = buf[offs].astype(np.int64)
    pos = (offs + 1) * 8
    end = (offs + lens) * 8
    out = np.empty((nstreams, count), dtype=np.int64)
    bad = np.zeros(nstreams, dtype=bool)
    one = np.int64(1)
    last = len(window) - 1
    for i in range(count):
        w = window[np.minimum(pos >> 3, last)].astype(np.uint64) << (pos & 7).astype(np.uint64)
        top = (w >> np.uint64(11)).astype(np.float64)
        _, e = np.frexp(top)
        m = 53 - e.astype(np.int64)
        length = 2 * m + k + 1
        bad |= (top == 0) | (length > _EGR_MAX_BITS) | (pos + length > end)
        length = np.clip(length, 1, _EGR_MAX_BITS)
        v = (w >> (64 - length).astype(np.uint64)).astype(np.int64)
        n = v - (one << k)
        out[:, i] = np.where(n & 1, (n + 1) >> 1, -(n >> 1))
        pos = pos + length
    rest = end - pos
    tail = (window[np.minimum(np.minimum(pos, end - 1) >> 3, last)].astype(np.uint64)
            << (pos & 7).astype(np.uint64)) >> (64 - np.clip(rest, 1, 8)).astype(np.uint64)
    bad |= (rest < 0) | (rest >= 8) | ((rest > 0) & (tail != 0))
    if bad.any():
        raise StreamError(f"{int(bad.sum())} of {nstreams} symbol streams do not hold "
                          f"exactly {count} codewords")
    return out


def p1_symbols(frames: list[Frame]) -> tuple[np.ndarray, np.ndarray]:
    """Profile 1 payloads of frames of one size and channel count -> (freqs
    [F, N, C], thres [F, 27, C]) int64. A payload is raw DEFLATE of
    [u32be thres length][thres EGR][freqs EGR], both channel-interleaved."""
    n, c = frames[0].fsize, frames[0].channels
    thres_blobs, freq_blobs = [], []
    for f in frames:
        try:
            raw = zlib.decompress(f.payload, wbits=-15)
        except zlib.error as exc:
            raise StreamError(f"a payload does not inflate: {exc}") from None
        if len(raw) < 4:
            raise StreamError("a payload shorter than its length field")
        (tl,) = struct.unpack(">I", raw[:4])
        if 4 + tl > len(raw):
            raise StreamError("a threshold stream longer than its payload")
        thres_blobs.append(raw[4:4 + tl])
        freq_blobs.append(raw[4 + tl:])
    thres = egr_decode(thres_blobs, 27 * c).reshape(-1, 27, c)
    freqs = egr_decode(freq_blobs, n * c).reshape(-1, n, c)
    return freqs, thres


def lossless_values(frames: list[Frame]) -> np.ndarray:
    """Profile 0 payloads of frames of one size, depth and byte order ->
    [F, N, C] float64: IEEE floats truncated to the depth (16/32/64: whole
    f16/f32/f64; 24/48: the top 3/6 bytes of an f32/f64)."""
    f0 = frames[0]
    n, c, bits = f0.fsize, f0.channels, f0.bits
    endian = "<" if f0.little_endian else ">"
    blob = b"".join(f.payload for f in frames)
    keep = bits // 8
    if len(blob) != len(frames) * n * c * keep:
        raise StreamError(f"lossless payloads of {len(blob)} bytes for {len(frames)} frames "
                          f"of {n} x {c} values at {bits} bits")
    if bits in (16, 32, 64):
        vals = np.frombuffer(blob, dtype=f"{endian}f{keep}")
    elif bits in (24, 48):
        width = 4 if bits == 24 else 8
        data = np.frombuffer(blob, dtype=np.uint8).reshape(-1, keep)
        full = np.zeros((data.shape[0], width), dtype=np.uint8)
        if endian == ">":
            full[:, :keep] = data
        else:
            full[:, width - keep:] = data
        vals = full.reshape(-1).view(f"{endian}f{width}")
    else:
        raise StreamError(f"lossless depth {bits} is not judged here")
    return vals.astype(np.float64).reshape(len(frames), n, c)
