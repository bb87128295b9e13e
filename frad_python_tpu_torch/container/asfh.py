"""ASFH — Audio Stream Frame Header codec (copy of the JAX package's).

Byte layout:

* PFB byte — profile(3b) | ecc(1b) | endian(1b) | bit-depth-index(3b)
* CSS u16 (compact profiles) — channels-1(6b) | srate-idx(4b) |
  fsize-idx(5b) | force-flush(1b)
* Compact header: FRM_SIGN + u32 length + PFB + CSS + overlap byte
  [+ ecc dsize/codesize + CRC16] = 12 or 16 bytes
* Lossless header: 32 bytes with u32 srate, 8 reserved bytes, u32 fsize,
  CRC32
* 64-bit extended frame size escape when the u32 length field is
  0xFFFFFFFF
* Incremental parse returning Complete/Incomplete/ForceFlush
"""

from __future__ import annotations

import struct

from ..common import FRM_SIGN, crc16_ansi, crc32
from ..models.profiles import COMPACT
from ..models.profiles import compact as compact_tables

COMPLETE = "Complete"
INCOMPLETE = "Incomplete"
FORCE_FLUSH = "ForceFlush"


def encode_pfb(profile: int, ecc: bool, little_endian: bool, bit_depth_index: int) -> int:
    return ((profile & 0b111) << 5) | (int(bool(ecc)) << 4) | (int(bool(little_endian)) << 3) | (bit_depth_index & 0b111)


def decode_pfb(pfb: int) -> tuple[int, bool, bool, int]:
    return (pfb >> 5) & 0b111, bool((pfb >> 4) & 1), bool((pfb >> 3) & 1), pfb & 0b111


def encode_css(channels: int, srate: int, fsize: int, force_flush: bool) -> int:
    return (
        ((channels - 1) & 0b111111) << 10
        | compact_tables.get_srate_index(srate) << 6
        | compact_tables.get_samples_index(fsize) << 1
        | int(bool(force_flush))
    )


def decode_css(css: int) -> tuple[int, int, int, bool]:
    channels = (css >> 10) + 1
    srate = compact_tables.SRATES[(css >> 6) & 0b1111]
    fsize = compact_tables.SAMPLES[(css >> 1) & 0b11111]
    return channels, srate, fsize, bool(css & 1)


class ASFH:
    """Mutable frame-header state with incremental parse and serialisation."""

    __slots__ = (
        "frmbytes", "buffer", "all_set", "header_bytes",
        "endian", "bit_depth_index", "channels", "srate", "fsize",
        "ecc", "ecc_dsize", "ecc_codesize", "profile", "overlap_ratio", "crc",
    )

    def __init__(self) -> None:
        self.frmbytes = 0
        self.buffer = b""
        self.all_set = False
        self.header_bytes = 0

        self.endian = False
        self.bit_depth_index = 0
        self.channels = 0
        self.srate = 0
        self.fsize = 0

        self.ecc = False
        self.ecc_dsize = 0
        self.ecc_codesize = 0
        self.profile = 0
        self.overlap_ratio = 0
        self.crc = 0

    def criteq(self, other: "ASFH | tuple[int, int]") -> bool:
        """True when channel layout and sample rate match `other`."""
        if isinstance(other, tuple):
            return (self.channels, self.srate) == other
        return self.channels == other.channels and self.srate == other.srate

    def snapshot(self) -> tuple[int, int]:
        """Value copy of the fields `criteq` compares: (channels, srate)."""
        return (self.channels, self.srate)

    def copy(self) -> "ASFH":
        """Value copy of every field (the decoder keeps one per deferred frame)."""
        c = ASFH()
        for name in self.__slots__:
            setattr(c, name, getattr(self, name))
        return c

    def write(self, frad: bytes) -> bytes:
        """Serialise a full frame: header + payload bytes."""
        n = len(frad)
        ext = b""
        if n >= 0xFFFFFFFF:
            ext = struct.pack(">Q", n)
            n = 0xFFFFFFFF

        parts = [FRM_SIGN, struct.pack(">I", n),
                 bytes([encode_pfb(self.profile, self.ecc, self.endian, self.bit_depth_index)])]

        if self.profile in COMPACT:
            parts.append(struct.pack(">H", encode_css(self.channels, self.srate, self.fsize, False)))
            parts.append(bytes([max(self.overlap_ratio - 1, 0)]))
            if self.ecc:
                parts.append(bytes([self.ecc_dsize, self.ecc_codesize]))
                parts.append(struct.pack(">H", crc16_ansi(frad)))
        else:
            parts.append(bytes([self.channels - 1]))
            parts.append(bytes([self.ecc_dsize, self.ecc_codesize]))
            parts.append(struct.pack(">I", self.srate))
            parts.append(b"\x00" * 8)
            parts.append(struct.pack(">I", self.fsize))
            parts.append(struct.pack(">I", crc32(frad)))

        parts.append(ext)
        parts.append(frad)
        return b"".join(parts)

    def force_flush(self) -> bytes:
        """Terminator frame marking a safe stream end (compact only)."""
        if self.profile not in COMPACT:
            return b""
        return b"".join([
            FRM_SIGN,
            b"\x00" * 4,
            bytes([encode_pfb(self.profile, self.ecc, self.endian, self.bit_depth_index)]),
            struct.pack(">H", encode_css(max(self.channels, 1), self.srate, self.fsize, True)),
            b"\x00",
        ])

    def _fill(self, buffer: bytes, target: int) -> tuple[bool, bytes]:
        """Accumulate header bytes into self.buffer up to `target` bytes."""
        need = target - len(self.buffer)
        if need > 0:
            self.buffer += buffer[:need]
            buffer = buffer[need:]
            if len(self.buffer) < target:
                return False, buffer
        self.header_bytes = target
        return True, buffer

    def read(self, buffer: bytes) -> tuple[str, bytes]:
        """Incrementally parse a header; self.buffer must start at FRM_SIGN.

        Returns (status, remaining_buffer). `Complete` sets all fields and
        `all_set`; `ForceFlush` signals a terminator frame.
        """
        ok, buffer = self._fill(buffer, 9)
        if not ok:
            return INCOMPLETE, buffer
        self.frmbytes = struct.unpack(">I", self.buffer[4:8])[0]
        self.profile, self.ecc, self.endian, self.bit_depth_index = decode_pfb(self.buffer[8])

        if self.profile in COMPACT:
            ok, buffer = self._fill(buffer, 12)
            if not ok:
                return INCOMPLETE, buffer
            css = struct.unpack(">H", self.buffer[9:11])[0]
            self.channels, self.srate, self.fsize, force_flush = decode_css(css)
            if force_flush:
                return FORCE_FLUSH, buffer

            self.overlap_ratio = self.buffer[11]
            if self.overlap_ratio != 0:
                self.overlap_ratio += 1

            if self.ecc:
                ok, buffer = self._fill(buffer, 16)
                if not ok:
                    return INCOMPLETE, buffer
                self.ecc_dsize = self.buffer[12]
                self.ecc_codesize = self.buffer[13]
                self.crc = struct.unpack(">H", self.buffer[14:16])[0]
        else:
            ok, buffer = self._fill(buffer, 32)
            if not ok:
                return INCOMPLETE, buffer
            self.channels = self.buffer[9] + 1
            self.ecc_dsize = self.buffer[10]
            self.ecc_codesize = self.buffer[11]
            self.srate = struct.unpack(">I", self.buffer[12:16])[0]
            self.fsize = struct.unpack(">I", self.buffer[24:28])[0]
            self.crc = struct.unpack(">I", self.buffer[28:32])[0]

        if self.frmbytes == 0xFFFFFFFF:
            ok, buffer = self._fill(buffer, self.header_bytes + 8)
            if not ok:
                return INCOMPLETE, buffer
            self.frmbytes = struct.unpack(">Q", self.buffer[-8:])[0]

        self.all_set = True
        return COMPLETE, buffer

    def clear(self) -> None:
        """Forget the parsed header, so the next parse starts afresh."""
        self.all_set = False
        self.buffer = b""

    def payload_crc_matches(self, frad: bytes) -> bool:
        """The payload against the header's CRC (CRC-16 compact, CRC-32
        lossless)."""
        if self.profile in COMPACT:
            return crc16_ansi(frad) == self.crc
        return crc32(frad) == self.crc
