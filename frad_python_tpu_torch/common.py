"""FrAD stream constants and CRC primitives.

Format parity with `frad_python_tpu.common`: the frame sync word, the
file signature, the CRC-16/ANSI of compact frame headers (poly 0xA001
reflected, init 0) and the zlib CRC-32 of lossless frame headers. The port
carries its own copy so that importing it never imports the JAX package.
"""

from __future__ import annotations

import zlib

import numpy as np

FRM_SIGN = b"\xff\xd0\xd2\x98"
#: first bytes of a FrAD file's metadata header (`container/head.py`)
SIGNATURE = b"fRad"

#: The streaming engines (Encoder._micro_batch, Decoder._drain_pending)
#: hand buffered frames to the batch cores in power-of-two groups of at
#: most this many. The port groups frames exactly as the JAX package does,
#: so the two can be compared at equal symbols and equal bytes, and the
#: GEMMs that reach cuBLAS come in a bounded set of shapes (M = 2k rows
#: for stereo, k = 2, 4, ..., 256).
MICRO_BATCH_MAX = 256


def _build_crc16_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0xA001 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC16_TABLE = _build_crc16_table()


def crc16_ansi(data: bytes | bytearray | memoryview | np.ndarray) -> int:
    """CRC-16/ANSI (CRC-16/ARC): poly 0xA001 reflected, init 0, xorout 0.
    Runs in the C++ host module unless FRAD_TORCH_NO_NATIVE is set."""
    if isinstance(data, np.ndarray):
        data = data.tobytes()
    data = bytes(data)
    from . import native
    if native.enabled():
        return native.crc16_ansi(data)
    tbl = _CRC16_TABLE
    crc = 0
    for b in data:
        crc = (crc >> 8) ^ tbl[(crc ^ b) & 0xFF]
    return crc


def crc32(data: bytes | bytearray | memoryview) -> int:
    """CRC-32 (IEEE 802.3) as used for lossless ASFH headers."""
    return zlib.crc32(bytes(data)) & 0xFFFFFFFF
