"""Truncated-float packings of the lossless profiles 0 and 4 (a port of
`frad_python_tpu.ops.packing`).

Each value is stored as an IEEE float truncated to the stream depth:

  depth 64/32/16 -> raw f64/f32/f16 bytes
  depth 48/24    -> top 6/3 bytes of each f64/f32 (big-endian) or the same
                    bytes in little-endian order
  depth 12       -> top 3 nibbles (12 bits) of each f16; always big-endian

The byte-aligned depths run in the C++ host module (`native`) above a
size threshold, numpy below it and under FRAD_TORCH_NO_NATIVE=1; the
12-bit nibble packing is numpy. Both give the same bytes.
"""

from __future__ import annotations

import numpy as np

from .. import native

DEPTHS = (12, 16, 24, 32, 48, 64)

#: stream depth -> IEEE container dtype (without byte order)
CONTAINER = {12: "f2", 16: "f2", 24: "f4", 32: "f4", 48: "f8", 64: "f8"}

#: largest magnitude the container float of each DEPTHS entry holds; a
#: frame beyond it escalates to a deeper depth
FLOAT_MAX = tuple(float(np.finfo(np.dtype(CONTAINER[d])).max) for d in DEPTHS)

_ESCALATE = {12: 16, 16: 24, 24: 32, 32: 48, 48: 64}


def needed_depth(max_abs: float, bits: int) -> int:
    """Escalate `bits` until the container float holds `max_abs`; raises
    OverflowError past 64 bits."""
    while max_abs > FLOAT_MAX[DEPTHS.index(bits)]:
        if bits not in _ESCALATE:
            raise OverflowError("Overflow with reaching the max bit depth.")
        bits = _ESCALATE[bits]
    return bits


def pack_floats(values: np.ndarray, bits: int, little_endian: bool) -> bytes:
    """Serialise a flat float array (frame-major, channel-interleaved) at
    the stream depth. The byte order applies to the byte-aligned depths;
    12 bits is always big-endian."""
    if bits not in DEPTHS:
        raise ValueError(f"Illegal bits value {bits}")
    if bits == 12:
        v12 = values.astype(np.float16).view(np.uint16) >> 4
        return _pack_nibble_triples(v12)
    if native.enabled() and values.size >= 4096:
        return native.pack_floats(values, bits, little_endian)

    endian = "<" if little_endian else ">"
    raw = np.ascontiguousarray(values.astype(endian + CONTAINER[bits]))
    if bits in (16, 32, 64):
        return raw.tobytes()
    group = bits // 6          # container bytes per value (4 or 8)
    keep = bits // 8           # stored bytes per value (3 or 6)
    cols = raw.view(np.uint8).reshape(-1, group)
    out = cols[:, :keep] if endian == ">" else cols[:, group - keep:]
    return np.ascontiguousarray(out).tobytes()


def unpack_floats(frad: bytes, bits: int, little_endian: bool) -> np.ndarray:
    """Inverse of `pack_floats`: stored bytes -> float64 flat array with
    NaN and Inf scrubbed to 0. At 16, 32 and 64 bits a length that is not
    a whole number of values raises ValueError (numpy's), as in the JAX
    package; at 12, 24 and 48 bits a partial trailing value is dropped."""
    if bits not in DEPTHS:
        raise ValueError(f"Illegal bits value {bits}")
    if bits == 12:
        v12 = _unpack_nibble_triples(np.frombuffer(frad, dtype=np.uint8))
        raw = (v12.astype(np.uint16) << 4).view(np.float16)
    elif native.enabled() and len(frad) >= 16384 and len(frad) % (bits // 8) == 0:
        return native.unpack_floats(frad, bits, little_endian)
    elif bits in (16, 32, 64):
        endian = "<" if little_endian else ">"
        raw = np.frombuffer(frad, dtype=endian + CONTAINER[bits])
    else:
        endian = "<" if little_endian else ">"
        group = bits // 6
        keep = bits // 8
        data = np.frombuffer(frad, dtype=np.uint8)
        data = data[: (len(data) // keep) * keep].reshape(-1, keep)
        full = np.zeros((data.shape[0], group), dtype=np.uint8)
        if endian == ">":
            full[:, :keep] = data
        else:
            full[:, group - keep:] = data
        raw = full.reshape(-1).view(endian + CONTAINER[bits])
    vals = np.asarray(raw, dtype=np.float64)
    return np.where(np.isfinite(vals), vals, 0.0)


def whole_values(nbytes: int, bits: int) -> bool:
    """True when `nbytes` of payload unpack without error at `bits`: the
    depths stored in whole bytes per value (16, 32, 64) need a multiple of
    their width; 12, 24 and 48 bits drop a partial value."""
    return bits not in (16, 32, 64) or nbytes % (bits // 8) == 0


def _pack_nibble_triples(v12: np.ndarray) -> bytes:
    """12-bit values -> nibble stream, zero-padded to a whole byte."""
    n = len(v12)
    nib = np.empty(n * 3 + (n * 3) % 2, dtype=np.uint8)
    nib[n * 3:] = 0
    nib[0:n * 3:3] = (v12 >> 8) & 0xF
    nib[1:n * 3:3] = (v12 >> 4) & 0xF
    nib[2:n * 3:3] = v12 & 0xF
    pairs = nib.reshape(-1, 2)
    return ((pairs[:, 0] << 4) | pairs[:, 1]).astype(np.uint8).tobytes()


def _unpack_nibble_triples(buf: np.ndarray) -> np.ndarray:
    """Byte stream -> 12-bit values (a trailing partial triple is dropped)."""
    nib = np.empty(len(buf) * 2, dtype=np.uint8)
    nib[0::2] = buf >> 4
    nib[1::2] = buf & 0xF
    n = (len(nib) // 3) * 3
    tri = nib[:n].reshape(-1, 3).astype(np.uint16)
    return (tri[:, 0] << 8) | (tri[:, 1] << 4) | tri[:, 2]
