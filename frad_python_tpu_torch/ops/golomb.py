"""Exp-Golomb-Rice entropy codec for signed integers (numpy).

Stream format:

* 1 header byte: Rice parameter k = ceil(log2(max|x|)) (0 if all zero)
* per value: signed map n>0 -> 2n-1, n<=0 -> -2n; then v = mapped + 2^k
  written as (bitlen(v) - k - 1) zero bits followed by v's binary digits;
  the stream is zero-padded to a whole byte.
* empty input encodes as the single byte 0x00.

Both directions run in the C++ host module (`native`) unless
FRAD_TORCH_NO_NATIVE selects the numpy paths: encode is vectorised
numpy; decode walks codeword boundaries with a Python jump chase over
the 1-bit positions, one step per codeword.
"""

from __future__ import annotations

import numpy as np


def _rice_k(data: np.ndarray) -> int:
    """k = ceil(log2(max|x|)), 0 when max is 0 (float log2, as the spec's
    reference computes it, so exact powers of two agree)."""
    dmax = int(np.abs(data).max()) if data.size else 0
    return int(np.ceil(np.log2(dmax))) if dmax else 0


def encode(data: np.ndarray) -> bytes:
    """Encode a flat int array -> EGR byte stream (incl. k header byte)."""
    if data.size == 0:
        return b"\x00"
    data = np.asarray(data, dtype=np.int64)
    from .. import native
    if native.enabled():
        return native.egr_encode(data)
    k = _rice_k(data)

    mapped = np.where(data > 0, (data << 1) - 1, -data << 1).astype(np.uint64)
    v = mapped + (np.uint64(1) << np.uint64(k))

    # bit length of v (v >= 2^k >= 1, v < 2^53 so frexp exponents are exact)
    _, exp = np.frexp(v.astype(np.float64))
    bitlen = exp.astype(np.int64)
    code_len = 2 * bitlen - (k + 1)          # m zeros + bitlen digits

    ends = np.cumsum(code_len)
    total = int(ends[-1])
    bits = np.zeros(total, dtype=np.uint8)
    # scatter v's binary digits so they END at `ends` (leading zeros implicit)
    for j in range(int(bitlen.max())):
        sel = bitlen > j
        pos = ends[sel] - 1 - j
        bits[pos] = ((v[sel] >> np.uint64(j)) & np.uint64(1)).astype(np.uint8)
    return bytes([k]) + np.packbits(bits).tobytes()


def decode(dbytes: bytes) -> np.ndarray:
    """Decode an EGR byte stream -> flat int64 array."""
    if len(dbytes) < 1:
        return np.array([], dtype=np.int64)
    from .. import native
    if native.enabled():
        return native.egr_decode(dbytes)
    k = dbytes[0]
    bits = np.unpackbits(np.frombuffer(dbytes, dtype=np.uint8, offset=1))
    nbits = len(bits)
    ones_list = np.flatnonzero(bits).tolist()
    n_ones = len(ones_list)

    # codeword at `pos` has its unary terminator at the first 1-bit >= pos;
    # length = 2*(one-pos) + k + 1
    starts: list[int] = []
    lens: list[int] = []
    pos = 0
    oi = 0
    while True:
        while oi < n_ones and ones_list[oi] < pos:
            oi += 1
        if oi >= n_ones:
            break  # only trailing zero padding left
        length = 2 * (ones_list[oi] - pos) + k + 1
        starts.append(pos)
        lens.append(min(length, nbits - pos))  # tolerate a truncated tail
        pos += length
        if pos >= nbits:
            break

    if not starts:
        return np.array([], dtype=np.int64)

    starts_a = np.asarray(starts, dtype=np.int64)
    lens_a = np.asarray(lens, dtype=np.int64)
    vals = np.zeros(len(starts), dtype=np.uint64)
    for j in range(int(lens_a.max())):
        sel = lens_a > j
        pos_a = starts_a[sel] + lens_a[sel] - 1 - j
        vals[sel] |= bits[pos_a].astype(np.uint64) << np.uint64(j)

    n = vals.astype(np.int64) - (np.int64(1) << np.int64(k))
    return np.where(n & 1 == 1, (n + 1) >> 1, -(n >> 1))
