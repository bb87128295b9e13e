"""Frame-payload ECC armor: chunked Reed-Solomon RS(dsize+codesize, dsize).

Byte-identical to the JAX package's `container/ecc.py`: the payload is
split into dsize-byte chunks, each extended with `codesize` RS parity
bytes; decode strips the parity, or in repair mode corrects each block
and zero-fills blocks beyond the code's correction capability. All
chunks of a frame go through `ops/rs.py` in one call.
"""

from __future__ import annotations

import numpy as np

from ..ops import rs


def encode(data: bytes, ecc_dsize: int, ecc_codesize: int) -> bytes:
    """data -> data armored as [dsize bytes | codesize parity] blocks."""
    if not data or ecc_codesize <= 0:
        return data
    buf = np.frombuffer(data, dtype=np.uint8)
    n_full = len(buf) // ecc_dsize
    out_parts = []
    if n_full:
        blocks = buf[: n_full * ecc_dsize].reshape(n_full, ecc_dsize)
        parity = rs.encode_blocks(blocks, ecc_codesize)
        out_parts.append(np.concatenate([blocks, parity], axis=1).reshape(-1).tobytes())
    rem = buf[n_full * ecc_dsize:]
    if rem.size:
        parity = rs.encode_blocks(rem[None, :], ecc_codesize)
        out_parts.append(rem.tobytes() + parity[0].tobytes())
    return b"".join(out_parts)


def decode(data: bytes, ecc_dsize: int, ecc_codesize: int, repair: bool) -> bytes:
    """Strip (or verify-and-repair) ECC blocks back to the raw payload."""
    if not data or ecc_codesize <= 0:
        return data
    blocksize = ecc_dsize + ecc_codesize
    if (blocksize > 255 or ecc_dsize < 1) and repair:
        # a hand-crafted or corrupt header can claim a ratio GF(256)
        # cannot honor (each field is a byte, so the sum may reach 510,
        # or dsize may be 0); no conforming encoder writes one, so strip
        # the parity best-effort instead of raising mid-stream
        repair = False
    buf = np.frombuffer(data, dtype=np.uint8)
    n_full = len(buf) // blocksize
    parts = []
    if n_full:
        blocks = buf[: n_full * blocksize].reshape(n_full, blocksize)
        if repair:
            fixed, _ok = rs.decode_blocks(blocks, ecc_codesize)
            parts.append(fixed.reshape(-1).tobytes())
        else:
            parts.append(np.ascontiguousarray(blocks[:, :ecc_dsize]).reshape(-1).tobytes())
    rem = buf[n_full * blocksize:]
    if rem.size:
        keep = max(len(rem) - ecc_codesize, 0)
        if repair and keep > 0:
            fixed, _ok = rs.decode_blocks(rem[None, :], ecc_codesize)
            parts.append(fixed[0].tobytes())
        else:
            # a truncated tail block cannot carry a full code: pass its data bytes
            parts.append(rem[:keep].tobytes())
    return b"".join(parts)
