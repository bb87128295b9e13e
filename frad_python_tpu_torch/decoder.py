"""Streaming FrAD decoder engine (profiles 0, 1, 2 and 4).

The port of `frad_python_tpu.decoder`: push FrAD bytes in, get PCM out.
FRM_SIGN resync, the incremental ASFH parse, CRC-gated Reed-Solomon
repair, the overlap-add crossfade, mid-stream format-change detection
with `crit`, force-flush handling, and suspend / resume through
`state_dict`.

`process` defers each whole frame and decodes the deferred frames at
drain points. Runs of >= 2 frames with one header configuration go to
`pipeline._decode_run` in power-of-two groups (the batch cores and
kernels on `device`, at `policy.compute_dtype()`);
a single frame, a fragment that needs a crossfade over several frames, a
frame of a reserved profile and a lossless run the batch cannot split
take the per-frame path (`profile0/1/2/4.digital`, crossfade on the host).
A reserved profile decodes as profile 0, as in the JAX package.
`exact=True` takes the per-frame path for every frame, so the output is
bit-identical across push sizes; FRAD_TORCH_EXACT_DECODE=1 makes that
the default. The API boundary is numpy: `DecodeResult.pcm` is [T, C]
float64.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import models
from .common import FRM_SIGN, MICRO_BATCH_MAX
from .container import ecc
from .container.asfh import ASFH, COMPLETE, FORCE_FLUSH, INVALID
from .models import COMPACT
from .ops import policy
from .ops.window import crossfade
from .parallel import pipeline


class DecodeResult:
    __slots__ = ("pcm", "srate", "frames", "crit")

    def __init__(self, pcm: list[np.ndarray], srate: int, frames: int, crit: bool):
        chunks = [p for p in pcm if p is not None and p.size]
        if chunks:
            self.pcm = np.concatenate(chunks)
        else:
            # channel-consistent empty: concatenates cleanly with any
            # non-empty [T, C] result of the same stream
            ch = next((p.shape[1] for p in pcm
                       if p is not None and p.ndim == 2), 0)
            self.pcm = np.empty((0, ch))
        self.srate = srate
        self.frames = frames
        self.crit = crit


class Decoder:
    def __init__(self, fix_error: bool = False, exact: bool | None = None,
                 device: str | torch.device | None = None):
        """`exact=True` decodes every frame on the per-frame path, so the
        PCM is bit-identical across push sizes, at one device call per
        frame. The default (None) reads FRAD_TORCH_EXACT_DECODE: "1"
        turns exact mode on, anything else leaves it off."""
        self.asfh = ASFH()
        self.info: tuple[int, int] = (0, 0)   # (channels, srate) snapshot
        self.buffer = b""
        self.overlap_fragment = np.empty((0, 0), dtype=np.float64)
        self.overlap_prog = 0
        self.fix_error = fix_error
        self.exact = (os.environ.get("FRAD_TORCH_EXACT_DECODE") == "1"
                      if exact is None else exact)
        self.broken_frame = False
        self.device = policy.resolve_device(device)

    def is_empty(self) -> bool:
        return len(self.buffer) < len(FRM_SIGN) or self.broken_frame

    def get_asfh(self) -> ASFH:
        return self.asfh

    # ------------------------------------------------------------------
    # overlap-add crossfade of the per-frame path
    # ------------------------------------------------------------------
    def _overlap(self, frame: np.ndarray, a: ASFH) -> np.ndarray:
        olap_len = len(self.overlap_fragment)
        if self.overlap_fragment.size:
            frame, consumed = crossfade(frame, self.overlap_fragment, self.overlap_prog)
            self.overlap_prog += consumed

        if olap_len <= self.overlap_prog:
            self.overlap_fragment = np.empty((0, 0), dtype=np.float64)
            self.overlap_prog = 0
            if a.profile in COMPACT and a.overlap_ratio != 0:
                cut = len(frame) * (a.overlap_ratio - 1) // a.overlap_ratio
                self.overlap_fragment, frame = frame[cut:], frame[:cut]
        return frame

    # ------------------------------------------------------------------
    def _decode_frame_payload(self, frad: bytes, a: ASFH) -> np.ndarray:
        if a.profile in (1, 2):
            codec = models.profile1 if a.profile == 1 else models.profile2
            return codec.digital(frad, a.bit_depth_index, a.channels, a.srate, a.fsize,
                                 self.device)
        if a.profile == 4:
            return models.profile4.digital(frad, a.bit_depth_index, a.channels, a.endian,
                                           a.fsize)
        return models.profile0.digital(frad, a.bit_depth_index, a.channels, a.endian,
                                       a.fsize, self.device)

    def _decode_one(self, a: ASFH, frad: bytes) -> np.ndarray:
        """Per-frame path: ECC strip/repair + decode + crossfade.

        Nothing is caught: on a corrupt payload the host byte layer does
        not raise (a payload that does not inflate unpacks to None and
        decodes to a zero frame; the EGR decoder reads any bytes; ECC
        with a ratio GF(256) cannot honor strips the parity without
        repair), and the lossless decoders check for the payloads the JAX
        package's decoder fails on and give its zero frame, so an
        exception here is a device, kernel or port fault.
        """
        if a.ecc:
            repair = self.fix_error and not a.payload_crc_matches(frad)
            frad = ecc.decode(frad, a.ecc_dsize, a.ecc_codesize, repair)
        return self._overlap(self._decode_frame_payload(frad, a), a)

    def _drain_pending(self, hs: list[ASFH], ps: list[bytes],
                       ret_pcm: list[np.ndarray]) -> None:
        """Decode the deferred frames collected by `process`.

        Runs of >= 2 frames with one header configuration go to the batch
        cores in power-of-two groups (`pipeline._decode_run`); the byte
        domain (ECC verify and repair, payload unpack) is the same on both
        paths, and the PCM agrees with the per-frame path to the float32
        IDCT's summation order. A fragment mid-crossfade, or one longer
        than the run's emit window, takes the per-frame path. The run
        split mirrors `pipeline.batch_decode`: change them together.
        """
        if not hs:
            return
        if self.exact:
            for h, p in zip(hs, ps):
                ret_pcm.append(self._decode_one(h, p))
            return

        idx = 0
        total = len(hs)
        while idx < total:
            key0 = pipeline._run_key(hs[idx])
            run = 1
            while idx + run < total and pipeline._run_key(hs[idx + run]) == key0:
                run += 1

            h0 = hs[idx]
            frag = self.overlap_fragment
            if (run < 2 or self.overlap_prog != 0 or h0.profile not in pipeline._BATCHABLE
                    or (frag.size and (len(frag) > pipeline._emit_cut(h0)
                                       or frag.shape[1] != h0.channels))):
                # a single frame, a crossfade over several frames, or a
                # reserved profile (decoded as profile 0)
                ret_pcm.append(self._decode_one(hs[idx], ps[idx]))
                idx += 1
                continue

            end = idx + run
            while idx < end:
                k = 1
                while k * 2 <= min(end - idx, MICRO_BATCH_MAX):
                    k *= 2
                if k < 2:
                    ret_pcm.append(self._decode_one(hs[idx], ps[idx]))
                    idx += 1
                    continue
                res = pipeline._decode_run(
                    hs[idx: idx + k], ps[idx: idx + k], i16_transfer=False,
                    device=self.device, fix_error=self.fix_error)
                if res is None:
                    # a lossless payload the batch cannot split: frame by
                    # frame, as the JAX Decoder falls back when its batch
                    # raises
                    for j in range(idx, idx + k):
                        ret_pcm.append(self._decode_one(hs[j], ps[j]))
                    idx += k
                    continue
                out, new_frag = res
                frag = self.overlap_fragment
                if frag.size and len(out):
                    ret_pcm.append(np.asarray(pipeline._frag_head(out, frag), dtype=np.float64))
                    ret_pcm.append(np.asarray(out[len(frag):], dtype=np.float64))
                else:
                    ret_pcm.append(np.asarray(out, dtype=np.float64))
                self.overlap_fragment = np.asarray(new_frag, dtype=np.float64)
                self.overlap_prog = 0
                idx += k

    def process(self, stream: bytes) -> DecodeResult:
        self.buffer += stream
        ret_pcm: list[np.ndarray] = []
        frames = 0
        pend_h: list[ASFH] = []
        pend_p: list[bytes] = []

        def drain() -> None:
            nonlocal frames
            frames += len(pend_h)
            self._drain_pending(pend_h, pend_p, ret_pcm)
            pend_h.clear()
            pend_p.clear()

        while True:
            if self.asfh.all_set:
                self.broken_frame = False
                if len(self.buffer) < self.asfh.frmbytes:
                    if len(stream) == 0:
                        self.broken_frame = True
                    break

                frad = self.buffer[:self.asfh.frmbytes]
                self.buffer = self.buffer[self.asfh.frmbytes:]
                pend_h.append(self.asfh.copy())
                pend_p.append(frad)
                self.asfh.clear()
            else:
                if self.asfh.buffer[:len(FRM_SIGN)] != FRM_SIGN:
                    i = self.buffer.find(FRM_SIGN)
                    if i != -1:
                        self.buffer = self.buffer[i:]
                        self.asfh.buffer = self.buffer[:len(FRM_SIGN)]
                        self.buffer = self.buffer[len(FRM_SIGN):]
                    else:
                        self.buffer = self.buffer[-len(FRM_SIGN) + 1:]
                        break
                status, self.buffer = self.asfh.read(self.buffer)
                if status == COMPLETE:
                    if not self.asfh.criteq(self.info):
                        chnl, srate = self.info
                        self.info = self.asfh.snapshot()
                        if srate or chnl:
                            # emit the old format's overlap tail, and keep the
                            # parsed header: its frame decodes on the next push
                            drain()
                            ret_pcm.append(self._flush_overlap())
                            return DecodeResult(ret_pcm, srate, frames, True)
                elif status == FORCE_FLUSH:
                    drain()
                    ret_pcm.append(self.flush().pcm)
                    break
                elif status == INVALID:
                    continue        # not a header: hunt for the next frame sign
                else:  # INCOMPLETE
                    break

        drain()
        return DecodeResult(ret_pcm, self.asfh.srate, frames, False)

    def _flush_overlap(self) -> np.ndarray:
        ret = self.overlap_fragment
        if not ret.size and self.info[0]:
            # channel-consistent empty, so process() and flush() results
            # concatenate unconditionally
            ret = np.empty((0, self.info[0]), dtype=np.float64)
        self.overlap_fragment = np.empty((0, 0), dtype=np.float64)
        self.overlap_prog = 0
        return ret

    def flush(self) -> DecodeResult:
        ret = self._flush_overlap()
        self.asfh.clear()
        return DecodeResult([ret], self.asfh.srate, 0, False)

    # suspend / resume: engine state as a plain dict. The JAX engine's keys,
    # plus "header": the bytes of a header parsed (or half parsed) but not
    # yet consumed with its payload, which a resumed engine parses again.
    # A dict without it (the JAX engine's) resumes as the JAX engine does,
    # resyncing on the next frame sign.
    def state_dict(self) -> dict:
        return {
            "buffer": self.buffer,
            "header": self.asfh.buffer,
            "overlap_fragment": np.asarray(self.overlap_fragment),
            "overlap_prog": self.overlap_prog,
            "info": self.info,
            "fix_error": self.fix_error,
            "exact": self.exact,
        }

    def load_state_dict(self, state: dict) -> None:
        self.asfh.clear()
        self.buffer = state.get("header", b"") + state["buffer"]
        self.overlap_fragment = np.asarray(state["overlap_fragment"])
        self.overlap_prog = state["overlap_prog"]
        self.info = tuple(state["info"])
        self.fix_error = state["fix_error"]
        self.exact = state.get("exact", self.exact)
