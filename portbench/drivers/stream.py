"""`stream`: one flow through the push engines: a track's PCM bytes
through an `Encoder` in pushes of `push_bytes`, then `flush()`; then the
track's stream through a `Decoder` in pushes of the same size, then
`flush()`. An attempt is one track's pass through one engine. The pushes
are memoryviews cut in set-up over bytes made in set-up; the streams the
decoders read are made there too."""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np

from ..record import Call
from . import Driver


class Stream(Driver):
    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        push = self.traffic["push_bytes"]
        self.fmt, scale, dt = (("s16le", 32768.0, "<i2") if self.cfg["bit_depth"] <= 16
                               else ("s32le", 2.0 ** 31, "<i4"))
        self.raw = [np.clip(np.rint(p * scale), -scale, scale - 1).astype(dt).tobytes()
                    for p in self.tracks]
        self.enc_pushes = [[memoryview(r)[j:j + push] for j in range(0, len(r), push)]
                           for r in self.raw]
        self.streams, self.dec_pushes = [], []

    def encoder(self):
        c = self.cfg
        enc = self.ft.Encoder(c["profile"], c["srate"], c["channels"], c["bit_depth"],
                              c["frame_size"], self.fmt, device=self.device)
        for key in c["encode_args"]:
            getattr(enc, f"set_{key}")(c[key])
        return enc

    def setup(self) -> None:
        push, warm = self.traffic["push_bytes"], self.traffic["warm_pushes"]
        for pcm in self.tracks:
            s = self.ft.batch_encode(pcm, device=self.device, **self.enc_kw)
            self.streams.append(s)
            self.dec_pushes.append([memoryview(s)[j:j + push] for j in range(0, len(s), push)])
        for i in range(len(self.tracks)):
            enc = self.encoder()
            for p in self.enc_pushes[i][:warm]:
                enc.process(p)
            enc.flush()
            dec = self.ft.Decoder(device=self.device)
            for p in self.dec_pushes[i][:warm]:
                dec.process(p)
            dec.flush()
        self.sync()
        per_album = sum(len(p) for p in self.enc_pushes) + sum(len(p) for p in self.dec_pushes)
        self.push_t = np.zeros(per_album * 64)

    def window(self, seconds: float) -> tuple[list[Call], np.ndarray]:
        ft, sync, now = self.ft, self.sync, time.perf_counter
        dev, push_t = self.device, self.push_t
        stamps, count, kept = [], defaultdict(int), {}
        j = 0
        deadline = now() + seconds
        done = False
        while not done:
            for i in range(len(self.tracks)):
                n = count[i]
                count[i] = n + 1
                keep_e, keep_d = self.keep(i, 0, n), self.keep(i, 1, n)
                bufs, pcms = [], []
                t0 = now()
                enc = self.encoder()
                for p in self.enc_pushes[i]:
                    a = now()
                    r = enc.process(p)
                    push_t[j] = now() - a
                    j += 1
                    if keep_e:
                        bufs.append(r.buf)
                r = enc.flush()
                sync()
                t1 = now()
                if keep_e:
                    bufs.append(r.buf)
                    kept[i, 0] = bufs
                dec = ft.Decoder(device=dev)
                for p in self.dec_pushes[i]:
                    a = now()
                    r = dec.process(p)
                    push_t[j] = now() - a
                    j += 1
                    if keep_d:
                        pcms.append(r.pcm)
                r = dec.flush()
                sync()
                t2 = now()
                if keep_d:
                    pcms.append(r.pcm)
                    kept[i, 1] = pcms
                stamps.append((i, t0, t1, t2))
            done = t2 >= deadline
        self.kept = kept
        calls = []
        for i, t0, t1, t2 in stamps:
            calls.append(Call("stream_encode", "Encoder", t0, t1, self.frames[i], self.least[i]))
            calls.append(Call("stream_decode", "Decoder", t1, t2, self.frames[i], self.least[i]))
        return calls, push_t[:j].copy()

    def sampled(self):
        for (i, kind), parts in sorted(self.kept.items()):
            if kind == 0:
                yield i, b"".join(parts), None
            else:
                yield i, self.streams[i], np.concatenate([x for x in parts if x.size])

    @staticmethod
    def rates(calls: list[Call]) -> dict[str, float]:
        """Frames out of both engines over the whole window."""
        return {"stream_frames_per_s": sum(c.frames for c in calls) / (calls[-1].t1 - calls[0].t0)}


DRIVER = Stream
