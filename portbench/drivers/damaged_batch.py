"""`damaged_batch`: the `batch` loop over copies read back with byte errors.
Set-up encodes each track once with the configuration's Reed-Solomon
armor and makes one damaged copy of that stream from the seed (`damage`).
The window is a closed loop: `batch_encode` of a track with the armor,
then `batch_decode(fix_error=True)` of the track's damaged copy, then the
next track, round and round. An encode keeps its stream for the
comparison; a decode keeps the clean stream and the program's PCM, so
`pcm_gap` holds the repaired decode against the reference's decode of the
undamaged stream: every error within the code's capacity must be repaired
exactly."""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np

from ..record import Call
from ..reference import ecc, profile1_ecc
from .batch import Batch

#: the seed enters the damage's generator as an unsigned 64-bit word
_SEED_MASK = (1 << 64) - 1


def _layout(data: bytes):
    """(payload frame headers, codeword starts, codeword ends, frame of each
    codeword) of an armored stream: each block of data and parity a
    codeword, the short last one included."""
    heads = [h for h in profile1_ecc.headers(data) if not h.terminator]
    starts = np.fromiter((h.start for h in heads), np.int64, len(heads))
    lens = np.fromiter((h.length for h in heads), np.int64, len(heads))
    bs = np.fromiter((h.dsize + h.csize for h in heads), np.int64, len(heads))
    count = -(-lens // bs)
    first = np.cumsum(count) - count
    frame = np.repeat(np.arange(len(heads)), count)
    begin = starts[frame] + (np.arange(int(count.sum())) - first[frame]) * bs[frame]
    return heads, begin, np.minimum(begin + bs[frame], starts[frame] + lens[frame]), frame


def codewords(data: bytes) -> tuple[np.ndarray, np.ndarray]:
    """(start, end) byte offsets of every codeword of an armored stream's
    payloads. Headers and terminators lie outside them all."""
    _, begin, end, _ = _layout(data)
    return begin, end


def _draw(rng, begin: np.ndarray, end: np.ndarray, one_in: int, cap: int) -> np.ndarray:
    """Sorted offsets of the damaged bytes of the codewords [begin, end)
    (sorted, disjoint): each byte with probability 1 / `one_in`; a codeword
    drawn with more than `cap` is drawn again."""
    lo = int(begin[0])
    hits = lo + np.flatnonzero(rng.integers(0, one_in, int(end[-1]) - lo, dtype=np.uint16) == 0)
    cw = np.searchsorted(begin, hits, side="right") - 1
    hits, cw = hits[hits < end[cw]], cw[hits < end[cw]]
    over = np.flatnonzero(np.bincount(cw, minlength=len(begin)) > cap)
    if not len(over):
        return hits
    redrawn = [hits[~np.isin(cw, over)]]
    for k in over:
        while True:
            h = np.flatnonzero(rng.integers(0, one_in, end[k] - begin[k], dtype=np.uint16) == 0)
            if len(h) <= cap:
                break
        redrawn.append(begin[k] + h)
    return np.sort(np.concatenate(redrawn))


def damage(data: bytes, seed: int, track: int, one_in: int, cap: int) -> bytes:
    """A copy of an armored stream with byte errors from (seed, track):
    every payload byte is replaced, independently with probability
    1 / `one_in`, by itself XOR a nonzero byte; a codeword drawn with more
    than `cap` errors is drawn again, and so is a damaged frame whose
    CRC-16 still matches (the format repairs only frames whose CRC fails:
    1 damaged frame in 65,536 passes it). Headers and terminators are never
    touched."""
    heads, begin, end, frame = _layout(data)
    rng = np.random.default_rng([int(seed) & _SEED_MASK, int(track)])
    clean = np.frombuffer(data, dtype=np.uint8)
    out = clean.copy()
    hits = _draw(rng, begin, end, one_in, cap)
    out[hits] ^= rng.integers(1, 256, len(hits), dtype=np.uint8)
    todo = np.unique(frame[np.searchsorted(begin, hits, side="right") - 1])
    while len(todo):
        crcs = ecc.crc16([out[heads[f].start:heads[f].start + heads[f].length].tobytes()
                          for f in todo])
        todo = [f for f, c in zip(todo.tolist(), crcs.tolist()) if c == heads[f].crc]
        for f in todo:
            h, cws = heads[f], np.flatnonzero(frame == f)
            out[h.start:h.start + h.length] = clean[h.start:h.start + h.length]
            hits = _draw(rng, begin[cws], end[cws], one_in, cap)
            out[hits] ^= rng.integers(1, 256, len(hits), dtype=np.uint8)
        todo = np.array(todo, dtype=np.int64)
    return out.tobytes()


class DamagedBatch(Batch):
    def __init__(self, ft, torch, cfg, traffic, seed, device, seconds_override=None):
        super().__init__(ft, torch, cfg, traffic, seed, device, seconds_override)
        self.seed = int(seed)
        self.clean: list[bytes] = []
        self.damaged: list[bytes] = []

    def setup(self) -> None:
        ft, dev, dmg = self.ft, self.device, self.traffic["damage"]
        for i, pcm in enumerate(self.tracks):
            s = ft.batch_encode(pcm, device=dev, **self.enc_kw)
            if ft.batch_encode(pcm, device=dev, **self.enc_kw) != s:
                raise RuntimeError(f"two encodes of track {i} gave different bytes")
            self.clean.append(s)
            self.damaged.append(damage(s, self.seed, i, dmg["one_byte_in"],
                                       dmg["most_a_codeword"]))
            ft.batch_decode(self.damaged[i], device=dev, fix_error=True)
        self.sync()

    def window(self, seconds: float) -> tuple[list[Call], np.ndarray]:
        ft, sync, now = self.ft, self.sync, time.perf_counter
        enc_kw, dev, damaged = self.enc_kw, self.device, self.damaged
        stamps, count, kept = [], defaultdict(int), {}
        deadline = now() + seconds
        done = False
        while not done:
            for i, pcm in enumerate(self.tracks):
                t0 = now()
                s = ft.batch_encode(pcm, device=dev, **enc_kw)
                sync()
                t1 = now()
                out, _ = ft.batch_decode(damaged[i], device=dev, fix_error=True)
                sync()
                t2 = now()
                stamps.append((i, t0, t1, t2))
                n = count[i]
                count[i] = n + 1
                if self.keep(i, 0, n):
                    kept[i, 0] = s
                if self.keep(i, 1, n):
                    kept[i, 1] = (self.clean[i], out)
                done = t2 >= deadline
        self.kept = kept
        calls = []
        for i, t0, t1, t2 in stamps:
            calls.append(Call("encode", "batch_encode", t0, t1, self.frames[i], self.least[i]))
            calls.append(Call("decode", "batch_decode", t1, t2, self.frames[i], self.least[i]))
        return calls, np.zeros(0)


DRIVER = DamagedBatch
