"""Streaming FrAD re-armorer: fresh Reed-Solomon parity for every frame.

The port of `frad_python_tpu.repairer`, host only: each frame is
CRC-verified, RS-repaired if damaged, re-encoded at the requested parity
ratio and re-framed with a recomputed CRC. The payload is never decoded,
so the audio stays bit-identical, and streams of every profile pass.
Bytes outside frames (file header, junk) pass through verbatim.

The engine is an incremental two-state scanner: `_SEEK` hunts for the
next frame sign and drains passthrough bytes; `_PAYLOAD` waits for a
parsed header's payload and re-armors it. `process()` advances the
scanner until it starves, so the output does not depend on the push
size. `parallel.pipeline.batch_repair` gives the same bytes for a whole
stream in batched passes.
"""

from __future__ import annotations

from .common import FRM_SIGN
from .container import ecc
from .container.asfh import ASFH, COMPLETE, FORCE_FLUSH

DEFAULT_ECC_RATIO = (96, 24)

_SEEK, _PAYLOAD = 0, 1


def sanitize_ecc_ratio(ratio: tuple[int, int]) -> tuple[tuple[int, int], list[str]]:
    """Clamp an RS (data, parity) request to a representable one.

    GF(256) RS codewords cap at 255 bytes and need a non-empty data part;
    invalid requests fall back to the default with a warning.
    """
    dsize, csize = ratio
    if dsize == 0:
        return DEFAULT_ECC_RATIO, [
            "ECC data size must not be zero; falling back to (96, 24)"]
    if dsize + csize > 255:
        return DEFAULT_ECC_RATIO, [
            f"ECC data+check size must not exceed 255, given: {dsize} and "
            f"{csize}; falling back to (96, 24)"]
    return (dsize, csize), []


class Repairer:
    """Push-based byte-stream re-coder: `process(chunk) -> bytes`."""

    def __init__(self, ecc_ratio: tuple[int, int] = DEFAULT_ECC_RATIO):
        self.ecc_ratio, self.warnings = sanitize_ecc_ratio(ecc_ratio)
        self.fix_error = True
        self.asfh = ASFH()
        self.buffer = b""
        self.broken_frame = False
        self._state = _SEEK

    def is_empty(self) -> bool:
        """True when no complete frame can be pending in the buffer."""
        return len(self.buffer) < len(FRM_SIGN) or self.broken_frame

    def process(self, stream: bytes) -> bytes:
        self.buffer += stream
        out: list[bytes] = []
        at_eof = len(stream) == 0
        while (self._advance_payload(out, at_eof) if self._state == _PAYLOAD
               else self._advance_seek(out)):
            pass
        return b"".join(out)

    def flush(self) -> bytes:
        """Drain whatever is buffered (end of stream: pass the tail through,
        with the header bytes of a truncated last frame, as
        `batch_repair` does)."""
        tail = self.asfh.buffer + self.buffer
        self.asfh.clear()
        self.buffer = b""
        self._state = _SEEK
        return tail

    def _advance_seek(self, out: list[bytes]) -> bool:
        """Hunt for FRM_SIGN, drain passthrough bytes, parse the header."""
        if self.asfh.buffer[: len(FRM_SIGN)] != FRM_SIGN:
            keep = len(FRM_SIGN) - 1
            at = self.buffer.find(FRM_SIGN)
            if at < 0:
                # not found: everything but a possible sign prefix passes
                if len(self.buffer) > keep:
                    out.append(self.buffer[:-keep])
                    self.buffer = self.buffer[-keep:]
                return False
            out.append(self.buffer[:at])
            self.asfh.buffer = self.buffer[at: at + len(FRM_SIGN)]
            self.buffer = self.buffer[at + len(FRM_SIGN):]

        status, self.buffer = self.asfh.read(self.buffer)
        if status == COMPLETE:
            self._state = _PAYLOAD
            return True
        if status == FORCE_FLUSH:
            # a terminator carries no payload: re-emit it and keep
            # scanning, since the stream may continue after it
            out.append(self.asfh.force_flush())
            self.asfh.clear()
            return True
        return False        # INCOMPLETE: wait for more header bytes

    def _advance_payload(self, out: list[bytes], at_eof: bool) -> bool:
        """Re-armor the pending header's payload once it is buffered."""
        need = self.asfh.frmbytes
        if len(self.buffer) < need:
            self.broken_frame = at_eof
            return False
        self.broken_frame = False
        payload, self.buffer = self.buffer[:need], self.buffer[need:]
        out.append(self._rearmor(payload))
        self.asfh.clear()
        self._state = _SEEK
        return True

    def _rearmor(self, payload: bytes) -> bytes:
        """Strip/repair the old parity shell, wrap in the new one."""
        if self.asfh.ecc:
            damaged = self.fix_error and not self.asfh.payload_crc_matches(payload)
            payload = ecc.decode(payload, self.asfh.ecc_dsize,
                                 self.asfh.ecc_codesize, damaged)
        armored = ecc.encode(payload, *self.ecc_ratio)
        self.asfh.ecc = True
        self.asfh.ecc_dsize, self.asfh.ecc_codesize = self.ecc_ratio
        return self.asfh.write(armored)
