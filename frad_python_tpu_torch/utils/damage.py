"""Deterministic frame-payload corruption for repair checks.

Walks a FrAD stream frame by frame (ASFH parse) and XOR-flips a few
payload bytes in every `nth`-th frame, spread evenly across the frame so
each Reed-Solomon block sees at most a couple of errors, well within the
correction capacity of the default (96, 24) ratio. Frame headers are
never touched, so the damage exercises the CRC-mismatch -> RS-correct
path, not the resync path. The same bytes as the JAX package's
`utils/damage.damage_stream`.
"""

from __future__ import annotations

import numpy as np

from ..common import FRM_SIGN
from ..container.asfh import ASFH, COMPLETE


def damage_stream(stream: bytes, *, nth: int = 2, bytes_per_frame: int = 6,
                  seed: int = 0) -> bytes:
    """Return a copy of `stream` with payload bytes deterministically
    corrupted in every `nth`-th complete frame."""
    buf = bytearray(stream)
    rng = np.random.default_rng(seed)
    pos = 0
    frame_index = 0
    n = len(stream)
    while pos < n:
        idx = stream.find(FRM_SIGN, pos)
        if idx < 0:
            break
        a = ASFH()
        status, _rest = a.read(stream[idx:])
        if status != COMPLETE:
            pos = idx + len(FRM_SIGN)
            continue
        payload_at = idx + a.header_bytes
        plen = a.frmbytes
        if payload_at + plen > n:          # trailing partial frame
            break
        k = min(bytes_per_frame, max(plen, 1))
        if frame_index % nth == 0 and plen > 0:
            stride = max(plen // k, 1)
            offs = (np.arange(k) * stride
                    + rng.integers(0, stride, size=k)) % plen
            for off in np.unique(offs):
                buf[payload_at + int(off)] ^= 0xA5
        frame_index += 1
        pos = payload_at + plen
    return bytes(buf)
