"""Judge of Profile 1 streams under Reed-Solomon armor, named by a
configuration's `judge`: compact frames with the 16-byte ECC header
(the 12 bytes of a compact header, then the data and parity sizes of a
block and the CRC-16 of the armored payload), whose payloads are armored
Profile 1 payloads.

`parse` reads the stream strictly, as `stream.parse` does, and holds the
armor to the reference (`ecc.py`): every frame's CRC-16 over its armored
payload, every block's parity, and the ratio the configuration states
(`ECC_RATIO`). It strips the parity and hands back the raw payloads as
`stream.Frame`s, so the rest of the judgement is Profile 1's
(`profile1.py`). An armor that departs from the reference is a
`StreamError`: the stream is refused."""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from . import ecc, profile1, stream
from .stream import StreamError

COMPACT = profile1.COMPACT
EXCESS = profile1.EXCESS
symbols, excess, synthesis, control = (profile1.symbols, profile1.excess, profile1.synthesis,
                                       profile1.control)

#: (data, parity) bytes of a block: the CLI's `--ecc` default, which the
#: configuration states as its `ecc_ratio`
ECC_RATIO = (96, 24)
HEAD = 16
TERM_HEAD = 12


@dataclass
class Header:
    """One frame's header as the stream holds it; a terminator has no
    payload (`start` = `length` = 0 past its header)."""
    pos: int
    start: int
    length: int
    pfb: int
    css: int
    olap: int
    dsize: int
    csize: int
    crc: int

    @property
    def terminator(self) -> bool:
        return bool(self.css & 1)


def headers(data: bytes) -> list[Header]:
    """Every frame header of an armored compact stream, from its first byte
    to its last."""
    mv = memoryview(data)
    out: list[Header] = []
    pos, end = 0, len(data)
    while pos < end:
        if bytes(mv[pos:pos + 4]) != stream.FRM_SIGN:
            raise StreamError(f"no frame sign at byte {pos}")
        if pos + TERM_HEAD > end:
            raise StreamError(f"header cut short at byte {pos}")
        (length,) = struct.unpack(">I", mv[pos + 4:pos + 8])
        pfb = mv[pos + 8]
        (css,) = struct.unpack(">H", mv[pos + 9:pos + 11])
        if pfb >> 5 not in stream.COMPACT:
            raise StreamError(f"a frame of profile {pfb >> 5} at byte {pos}")
        if css & 1:
            if length != 0:
                raise StreamError(f"terminator with a payload at byte {pos}")
            out.append(Header(pos, pos + TERM_HEAD, 0, pfb, css, mv[pos + 11], 0, 0, 0))
            pos += TERM_HEAD
            continue
        if not (pfb >> 4) & 1:
            raise StreamError(f"a frame without ECC armor at byte {pos}")
        if length == 0xFFFFFFFF:
            raise StreamError("64-bit frame lengths are not expected at these sizes")
        if pos + HEAD + length > end:
            raise StreamError(f"frame cut short at byte {pos}")
        (crc,) = struct.unpack(">H", mv[pos + 14:pos + 16])
        out.append(Header(pos, pos + HEAD, length, pfb, css, mv[pos + 11], mv[pos + 12],
                          mv[pos + 13], crc))
        pos += HEAD + length
    return out


def _strip(data: bytes, heads: list[Header]) -> list[bytes]:
    """The raw payloads of the payload frames, after every block's parity
    is checked against the reference's."""
    dsize, nsym = ECC_RATIO
    bs = dsize + nsym
    buf = np.frombuffer(data, dtype=np.uint8)
    blocks, stored, raws = [], [], []
    for h in heads:
        nfull, rem = divmod(h.length, bs)
        if (h.dsize, h.csize) != ECC_RATIO:
            raise StreamError(f"ECC ratio ({h.dsize}, {h.csize}) at byte {h.pos}, "
                              f"not {ECC_RATIO}")
        if h.length == 0 or 0 < rem <= nsym:
            raise StreamError(f"an armored payload of {h.length} bytes at byte {h.pos}")
        body = buf[h.start:h.start + h.length]
        full = body[:nfull * bs].reshape(nfull, bs)
        parts = [full[:, :dsize]]
        blocks.append(full[:, :dsize])
        stored.append(full[:, dsize:])
        if rem:
            tail = body[nfull * bs:]
            short = np.zeros((1, dsize), dtype=np.uint8)
            short[0, bs - rem:] = tail[:rem - nsym]
            blocks.append(short)
            stored.append(tail[None, rem - nsym:])
            parts.append(tail[None, :rem - nsym])
        raws.append(b"".join(p.tobytes() for p in parts))
    if blocks:
        want = ecc.parity(np.concatenate(blocks), nsym)
        bad = np.flatnonzero((want != np.concatenate(stored)).any(axis=1))
        if len(bad):
            raise StreamError(f"{len(bad)} blocks whose parity departs from the reference's")
    return raws


def parse(data: bytes) -> tuple[list[stream.Frame], list[int]]:
    """(payload frames with the armor stripped, terminators), as
    `stream.parse` gives them."""
    heads = headers(data)
    payload = [h for h in heads if not h.terminator]
    armored = [data[h.start:h.start + h.length] for h in payload]
    crcs = ecc.crc16(armored)
    for h, c in zip(payload, crcs.tolist()):
        if c != h.crc:
            raise StreamError(f"CRC-16 mismatch in the frame at byte {h.pos}")
    raws = iter(_strip(data, payload))
    frames: list[stream.Frame] = []
    terms: list[int] = []
    for h in heads:
        if h.terminator:
            terms.append(len(frames))
            continue
        srate_idx, fsize_idx = (h.css >> 6) & 0xF, (h.css >> 1) & 0x1F
        if srate_idx >= len(stream.SRATES) or fsize_idx >= len(stream.SAMPLES) \
                or h.pfb & 7 >= len(stream.COMPACT_DEPTHS):
            raise StreamError(f"a table index past its table at byte {h.pos}")
        frames.append(stream.Frame(
            h.pfb >> 5, bool((h.pfb >> 3) & 1), stream.COMPACT_DEPTHS[h.pfb & 7],
            (h.css >> 10) + 1, stream.SRATES[srate_idx], stream.SAMPLES[fsize_idx],
            h.olap + 1 if h.olap else 0, next(raws)))
    return frames, terms
