"""`batch`: a closed loop over an album of tracks: `batch_encode` of a
track (PCM to stream bytes on the host), then `batch_decode` of the
stream it just produced, then the next track, round and round. An attempt
is one call. Each call's wall ends on the host with its result, after a
synchronise of every card."""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np

from ..record import Call
from . import Driver


class Batch(Driver):
    def setup(self) -> None:
        for pcm in self.tracks:
            s = self.ft.batch_encode(pcm, device=self.device, **self.enc_kw)
            self.ft.batch_decode(s, device=self.device)
        self.sync()

    def window(self, seconds: float) -> tuple[list[Call], np.ndarray]:
        ft, sync, now = self.ft, self.sync, time.perf_counter
        enc_kw, dev = self.enc_kw, self.device
        stamps, count, kept = [], defaultdict(int), {}
        deadline = now() + seconds
        done = False
        while not done:
            for i, pcm in enumerate(self.tracks):
                t0 = now()
                s = ft.batch_encode(pcm, device=dev, **enc_kw)
                sync()
                t1 = now()
                out, _ = ft.batch_decode(s, device=dev)
                sync()
                t2 = now()
                stamps.append((i, t0, t1, t2))
                n = count[i]
                count[i] = n + 1
                if self.keep(i, 0, n):
                    kept[i, 0] = s
                if self.keep(i, 1, n):
                    kept[i, 1] = (s, out)
                done = t2 >= deadline
        self.kept = kept
        calls = []
        for i, t0, t1, t2 in stamps:
            calls.append(Call("encode", "batch_encode", t0, t1, self.frames[i], self.least[i]))
            calls.append(Call("decode", "batch_decode", t1, t2, self.frames[i], self.least[i]))
        return calls, np.zeros(0)

    def sampled(self):
        for (i, kind), item in sorted(self.kept.items()):
            yield (i, item, None) if kind == 0 else (i, *item)

    @staticmethod
    def rates(calls: list[Call]) -> dict[str, float]:
        """Frames of every call of a kind over the sum of those calls' walls."""
        out = {}
        for kind in ("encode", "decode"):
            cs = [c for c in calls if c.kind == kind]
            out[f"{kind}_frames_per_s"] = sum(c.frames for c in cs) / sum(c.t1 - c.t0 for c in cs)
        return out


DRIVER = Batch
