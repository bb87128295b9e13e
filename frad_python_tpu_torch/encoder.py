"""Streaming FrAD encoder engine (profiles 0, 1 and 4; profile 2 through
a loaded state).

The port of `frad_python_tpu.encoder`: push PCM bytes in, get framed FrAD
bytes out. Incremental buffering, compact read-size rounding (the lossy
profiles), the overlap fragment carry, per-frame profile dispatch, optional
Reed-Solomon armor, ASFH framing, force-flush terminators (the lossy
profiles),
mid-stream reconfiguration with the validation gauntlet and a flush when
the channel layout or sample rate changes, and suspend / resume through
`state_dict`.

Each frame's tensor chain runs on `device` (`None` means CUDA, and raises
without one). When the buffer holds two or more whole frames on the
steady overlap grid, `_micro_batch` hands them to
`parallel.batch_encode(final=False)` in power-of-two groups, the same
cores and packers as the batch path; otherwise a frame goes alone through
`profile0/1/2/4.analogue`. The transforms compute at
FRAD_TORCH_COMPUTE_DTYPE (`policy.compute_dtype`, `policy.transform_dtype`).
The API boundary is numpy and bytes.

The gauntlet answers for every profile with the JAX package's messages;
the experimental profile 2 is not available there, as in the JAX
package, but an engine whose loaded state dict names profile 2 encodes it.
"""

from __future__ import annotations

import numpy as np
import torch

from . import models
from .common import MICRO_BATCH_MAX
from .container import ecc
from .container.asfh import ASFH
from .models import AVAILABLE, BIT_DEPTHS, COMPACT, SEGMAX, compact
from .ops import policy
from .ops.pcm import ff_format_to_numpy_type, to_f64
from .repairer import DEFAULT_ECC_RATIO, sanitize_ecc_ratio


class EncodeResult:
    __slots__ = ("buf", "samples")

    def __init__(self, buf: bytes, samples: int):
        self.buf = buf
        self.samples = samples


class Encoder:
    def __init__(self, profile: int, srate: int, channels: int,
                 bit_depth: int, frame_size: int, pcm_format: str = "f64be",
                 device: str | torch.device | None = None):
        self.asfh = ASFH()
        self.buffer = b""
        self.bit_depth = 0
        self.channels = 0
        self.fsize = 0
        self.srate = 0
        self.overlap_fragment = np.empty((0, 0), dtype=np.float64)
        self.pcm_format = ff_format_to_numpy_type(pcm_format)
        self.loss_level = 0.5
        self.init = False

        err = self.set_profile(profile, srate, channels, bit_depth, frame_size)
        if isinstance(err, str):
            raise ValueError(err)
        self.device = policy.resolve_device(device)

    # ------------------------------------------------------------------
    # validation gauntlet: the JAX package's checks and messages
    # ------------------------------------------------------------------
    @staticmethod
    def verify_profile(profile: int) -> str | None:
        if profile not in AVAILABLE:
            return f"Invalid profile! Available: {AVAILABLE}"
        return None

    @staticmethod
    def verify_srate(profile: int, srate: int) -> str | None:
        if srate == 0:
            return "Sample rate cannot be zero"
        if profile in COMPACT:
            try:
                valid = compact.get_valid_srate(srate)
            except ValueError:
                valid = -1
            if valid != srate:
                return (f"Invalid sample rate! Valid rates for profile "
                        f"{profile}: {compact.SRATES}")
        return None

    @staticmethod
    def verify_channels(profile: int, channels: int) -> str | None:
        if channels == 0:
            return "Channel count cannot be zero"
        return None

    @staticmethod
    def verify_bit_depth(profile: int, bit_depth: int) -> str | None:
        if bit_depth == 0:
            return "Bit depth cannot be zero"
        if bit_depth not in BIT_DEPTHS[profile]:
            return (f"Invalid bit depth! Valid depths for profile {profile}: "
                    f"{[d for d in BIT_DEPTHS[profile] if d]}")
        return None

    @staticmethod
    def verify_frame_size(profile: int, frame_size: int) -> str | None:
        if frame_size == 0:
            return "Frame size cannot be zero"
        if frame_size > SEGMAX[profile]:
            return f"Samples per frame cannot exceed {SEGMAX[profile]}"
        return None

    # ------------------------------------------------------------------
    # overlap-fragment carry
    # ------------------------------------------------------------------
    def _overlap(self, frame: np.ndarray, overlap_read: int, flush: bool) -> np.ndarray:
        if self.overlap_fragment.size:
            frame = np.concatenate(
                [self.overlap_fragment[:overlap_read], frame], axis=0)
            self.overlap_fragment = self.overlap_fragment[overlap_read:]

        next_overlap = np.empty((0, 0), dtype=np.float64)
        if (not flush
                and self.asfh.profile in COMPACT
                and self.asfh.overlap_ratio > 1
                and len(self.overlap_fragment) < 1):
            cut = len(frame) * (self.asfh.overlap_ratio - 1) // self.asfh.overlap_ratio
            next_overlap = frame[cut:]
        self.overlap_fragment = next_overlap
        return frame

    # ------------------------------------------------------------------
    # frame loop
    # ------------------------------------------------------------------
    def _encode_frame_payload(self, frame: np.ndarray) -> tuple[bytes, int, int, int]:
        profile = self.asfh.profile
        if profile in (1, 2):
            codec = models.profile1 if profile == 1 else models.profile2
            return codec.analogue(frame, self.bit_depth, self.srate, self.loss_level,
                                  self.device)
        if profile == 4:
            return models.profile4.analogue(frame, self.bit_depth, self.srate,
                                            self.asfh.endian)
        return models.profile0.analogue(frame, self.bit_depth, self.srate,
                                        self.asfh.endian, self.device)

    def _micro_batch(self, rlen: int) -> tuple[bytes, int] | None:
        """Encode a run of whole frames with one `batch_encode` call.

        Runs when the buffer holds >= 2 whole frames and the overlap
        fragment sits on the steady carry grid; takes the largest
        power-of-two count of frames up to MICRO_BATCH_MAX. Returns
        (stream bytes, fresh samples consumed), or None when the
        per-frame path must run (an off-grid fragment after a mid-stream
        reconfiguration, ECC ratio bytes in a lossless header with ECC
        off, or a shallow buffer). Nothing is caught here:
        the Encoder's gauntlet admits no configuration that
        `batch_encode` rejects and the per-frame path accepts, so an
        error is real and propagates.
        """
        profile = self.asfh.profile
        is_compact = profile in COMPACT
        ratio = self.asfh.overlap_ratio
        olap_active = is_compact and ratio > 1
        steady_frag = (rlen - rlen * (ratio - 1) // ratio) if olap_active else 0
        frag = self.overlap_fragment
        if len(frag) and (not olap_active or len(frag) != steady_frag
                          or frag.shape[1] != self.channels):
            return None        # off-grid fragment (mid-stream reconfiguration)
        if not is_compact and not self.asfh.ecc and (self.asfh.ecc_dsize
                                                     or self.asfh.ecc_codesize):
            # a lossless header carries the ratio bytes even with ECC off,
            # where the batch framer writes (0, 0): keep the per-frame path
            return None

        bps = self.pcm_format.itemsize
        row = self.channels * bps
        fresh0 = rlen - len(frag)
        steady_fresh = rlen - steady_frag
        avail = len(self.buffer) // row
        if avail < fresh0 + steady_fresh:
            return None        # fewer than 2 whole frames buffered
        k_avail = 1 + (avail - fresh0) // steady_fresh
        k = 1
        while k * 2 <= min(k_avail, MICRO_BATCH_MAX):
            k *= 2

        fresh_total = fresh0 + (k - 1) * steady_fresh
        consume = fresh_total * row
        pcm_bytes, self.buffer = self.buffer[:consume], self.buffer[consume:]
        fresh = to_f64(np.frombuffer(pcm_bytes, self.pcm_format)
                       .reshape(-1, self.channels), self.pcm_format)
        span = np.concatenate([frag, fresh]) if len(frag) else fresh

        from .parallel.pipeline import batch_encode
        stream = batch_encode(
            span, profile, self.srate, self.bit_depth, self.fsize,
            loss_level=self.loss_level, enable_ecc=self.asfh.ecc,
            ecc_ratio=(self.asfh.ecc_dsize, self.asfh.ecc_codesize),
            little_endian=self.asfh.endian, overlap_ratio=ratio if is_compact else 0,
            final=False, device=self.device)

        self.overlap_fragment = (span[len(span) - steady_frag:] if olap_active
                                 else np.empty((0, 0), dtype=np.float64))
        self.asfh.channels = self.channels
        self.asfh.fsize = rlen
        if is_compact:
            depths = BIT_DEPTHS[profile]
            bits = self.bit_depth if self.bit_depth in depths else 16
            self.asfh.bit_depth_index = depths.index(bits)
            self.asfh.srate = compact.get_valid_srate(self.srate)
        else:
            # a lossless depth index depends on the data (escalation); the
            # next per-frame write sets it
            self.asfh.srate = self.srate
        return stream, fresh_total

    def _inner(self, stream: bytes, flush: bool) -> EncodeResult:
        self.buffer += stream
        out: list[bytes] = []
        samples = 0
        if not self.init:
            return EncodeResult(b"", 0)

        while True:
            rlen = self.fsize
            if self.asfh.profile in COMPACT:
                rlen = compact.get_samples_min_ge(rlen)

            if not flush:
                mb = self._micro_batch(rlen)
                if mb is not None:
                    out.append(mb[0])
                    samples += mb[1]
                    continue

            overlap_read = min(len(self.overlap_fragment), rlen)
            rlen -= overlap_read

            bps = self.pcm_format.itemsize
            read_bytes = rlen * self.channels * bps
            if len(self.buffer) < read_bytes and not flush:
                break

            pcm_bytes, self.buffer = self.buffer[:read_bytes], self.buffer[read_bytes:]
            usable = (len(pcm_bytes) // (self.channels * bps)) * self.channels * bps
            frame = np.frombuffer(pcm_bytes[:usable], self.pcm_format).reshape(-1, self.channels)
            frame = to_f64(frame, self.pcm_format)
            samples_in = len(frame)

            frame = self._overlap(frame, overlap_read, flush)
            if frame.size == 0 and self.overlap_fragment.size == 0:
                out.append(self.asfh.force_flush())
                break
            samples += samples_in

            frad, bdi, channels, srate = self._encode_frame_payload(frame)
            if self.asfh.ecc:
                frad = ecc.encode(frad, self.asfh.ecc_dsize, self.asfh.ecc_codesize)

            self.asfh.bit_depth_index = bdi
            self.asfh.channels = channels
            self.asfh.fsize = len(frame)
            self.asfh.srate = srate
            out.append(self.asfh.write(frad))
            if flush:
                out.append(self.asfh.force_flush())

        return EncodeResult(b"".join(out), samples)

    def process(self, stream: bytes) -> EncodeResult:
        return self._inner(stream, False)

    def flush(self) -> EncodeResult:
        if self.init:
            return self._inner(b"", True)
        return EncodeResult(b"", 0)

    # ------------------------------------------------------------------
    # getters / setters
    # ------------------------------------------------------------------
    def get_profile(self) -> int:
        return self.asfh.profile

    def set_profile(self, profile: int, srate: int, channels: int,
                    bit_depth: int, frame_size: int) -> str | EncodeResult:
        # sequential short-circuit: later checks index tables by profile
        for check in (lambda: self.verify_profile(profile),
                      lambda: self.verify_srate(profile, srate),
                      lambda: self.verify_channels(profile, channels),
                      lambda: self.verify_bit_depth(profile, bit_depth),
                      lambda: self.verify_frame_size(profile, frame_size)):
            if (err := check()) is not None:
                return err

        res = EncodeResult(b"", 0)
        if ((self.channels and self.channels != channels)
                or (self.srate and self.srate != srate)):
            res = self.flush()
        self.asfh.profile = profile
        self.srate = srate
        self.channels = channels
        self.bit_depth = bit_depth
        self.fsize = frame_size
        self.init = True
        return res

    def get_channels(self) -> int:
        return self.channels

    def set_channels(self, channels: int) -> str | EncodeResult:
        if (err := self.verify_channels(self.get_profile(), channels)):
            return err
        res = EncodeResult(b"", 0)
        if self.channels and self.channels != channels:
            res = self.flush()
        self.channels = channels
        return res

    def get_srate(self) -> int:
        return self.srate

    def set_srate(self, srate: int) -> str | EncodeResult:
        if (err := self.verify_srate(self.get_profile(), srate)):
            return err
        res = EncodeResult(b"", 0)
        if self.srate and self.srate != srate:
            res = self.flush()
        self.srate = srate
        return res

    def get_frame_size(self) -> int:
        return self.fsize

    def set_frame_size(self, frame_size: int) -> str | None:
        if (err := self.verify_frame_size(self.get_profile(), frame_size)):
            return err
        self.fsize = frame_size
        return None

    def get_bit_depth(self) -> int:
        return self.bit_depth

    def set_bit_depth(self, bit_depth: int) -> str | None:
        if (err := self.verify_bit_depth(self.get_profile(), bit_depth)):
            return err
        self.bit_depth = bit_depth
        return None

    def set_ecc(self, enabled: bool, ecc_ratio: tuple[int, int] = DEFAULT_ECC_RATIO) -> str | None:
        """Enable RS armor. An invalid ratio falls back to (96, 24) and the
        message is returned for the caller to surface."""
        self.asfh.ecc = enabled
        ecc_ratio, warnings = sanitize_ecc_ratio(ecc_ratio)
        self.asfh.ecc_dsize, self.asfh.ecc_codesize = ecc_ratio
        return warnings[0] if warnings else None

    def set_little_endian(self, little_endian: bool) -> None:
        self.asfh.endian = little_endian

    def set_loss_level(self, loss_level: float) -> None:
        self.loss_level = max(abs(loss_level), 0.125)

    def set_overlap_ratio(self, overlap_ratio: int) -> None:
        if overlap_ratio != 0:
            overlap_ratio = max(2, min(256, overlap_ratio))
        self.asfh.overlap_ratio = overlap_ratio

    # ------------------------------------------------------------------
    # suspend / resume: engine state as a plain dict. The JAX engine's
    # keys, plus "last_frame": the (depth index, channels, frame size,
    # sample rate) of the last frame written, which a force-flush
    # terminator repeats. A dict without it (the JAX engine's) resumes as
    # the JAX engine does.
    # ------------------------------------------------------------------
    def state_dict(self) -> dict:
        return {
            "last_frame": (self.asfh.bit_depth_index, self.asfh.channels,
                           self.asfh.fsize, self.asfh.srate),
            "buffer": self.buffer,
            "overlap_fragment": np.asarray(self.overlap_fragment),
            "bit_depth": self.bit_depth,
            "channels": self.channels,
            "fsize": self.fsize,
            "srate": self.srate,
            "loss_level": self.loss_level,
            "profile": self.asfh.profile,
            "ecc": (self.asfh.ecc, self.asfh.ecc_dsize, self.asfh.ecc_codesize),
            "endian": self.asfh.endian,
            "overlap_ratio": self.asfh.overlap_ratio,
        }

    def load_state_dict(self, state: dict) -> None:
        self.buffer = state["buffer"]
        self.overlap_fragment = np.asarray(state["overlap_fragment"])
        self.bit_depth = state["bit_depth"]
        self.channels = state["channels"]
        self.fsize = state["fsize"]
        self.srate = state["srate"]
        self.loss_level = state["loss_level"]
        self.asfh.profile = state["profile"]
        self.asfh.ecc, self.asfh.ecc_dsize, self.asfh.ecc_codesize = state["ecc"]
        self.asfh.endian = state["endian"]
        self.asfh.overlap_ratio = state["overlap_ratio"]
        if "last_frame" in state:
            (self.asfh.bit_depth_index, self.asfh.channels,
             self.asfh.fsize, self.asfh.srate) = state["last_frame"]
        self.init = True
