"""The comparison that decides a run's `correct`: the program's streams
and PCM against the plain reference, worked out again from the input PCM
that the benchmark handed the program. What depends on the profile comes
from the judge module a configuration names (`profile1.py`, `profile0.py`).

* Encode, Profile 1: every symbol of the stream against the reference's
  value before rounding. `p1_symbol_excess` is the largest distance of a
  symbol from its value beyond the half step that rounding allows (0 for
  an encoder that rounds the exact values; a float32 encoder lands a
  value's other neighbour only where the value lies within its own error
  of a half).
* Encode, Profile 0: every coefficient of the stream against the
  reference's transform. `p0_coef_excess` is the largest distance beyond
  the truncation step of the container float at that magnitude, over the
  largest coefficient of its channel-frame.
* Decode: `pcm_gap` is the largest difference between the program's PCM
  and the reference's decode of the same stream.
* Both: `plan_faults` counts the frames whose header, size or place
  departs from the frame plan of the input (and terminators out of
  place); a stream the format's reader refuses counts one more. Its
  limit is 0.
"""

from __future__ import annotations

import functools
import importlib
import math
from dataclasses import dataclass, field

import numpy as np
import torch

from . import codec, stream
from .codec import REFERENCE, Precision


@dataclass
class Config:
    """What a configuration file states of the codec, and the judge module
    (under `reference/`) that reads its streams."""
    judge: str
    profile: int
    srate: int
    channels: int
    bit_depth: int
    frame_size: int
    overlap_ratio: int
    loss_level: float
    little_endian: bool = False

    @classmethod
    def of(cls, cfg: dict) -> "Config":
        return cls(cfg["judge"], cfg["profile"], cfg["srate"], cfg["channels"], cfg["bit_depth"],
                   cfg["frame_size"], cfg.get("overlap_ratio", 0), cfg.get("loss_level", 0.0),
                   cfg.get("little_endian", False))

    @functools.cached_property
    def rules(self):
        return importlib.import_module(f"{__package__}.{self.judge}")

    @property
    def compact(self) -> bool:
        return self.rules.COMPACT


def frame_plan(total: int, cfg: Config) -> tuple[list[tuple[int, int, int]], int]:
    """The frames a sound encoder cuts from `total` samples: ([(start,
    samples read, frame size in the header)], terminators at the end).
    Each frame after the first re-reads the overlap its predecessor
    leaves (N - N (r - 1) // r samples at overlap ratio r, compact
    profiles only); the last frame holds what is left and, in a compact
    profile, is padded up to a compact frame size, after which two
    terminators close the stream (one when nothing is left over)."""
    n = stream.compact_size(cfg.frame_size) if cfg.compact else cfg.frame_size
    olap = (n - n * (cfg.overlap_ratio - 1) // cfg.overlap_ratio
            if cfg.compact and cfg.overlap_ratio > 1 else 0)
    plan, pos, frag = [], 0, 0
    while pos + n - frag <= total:
        plan.append((pos - frag, n, n))
        pos += n - frag
        frag = olap
    rest = total - pos
    tail = rest > 0 or frag > 0
    if tail:
        read = frag + rest
        plan.append((pos - frag, read, stream.compact_size(read) if cfg.compact else read))
    terms = (2 if tail else 1) if cfg.compact else 0
    return plan, terms


def overlap_of(fsize: int, ratio: int) -> int:
    return fsize - fsize * (ratio - 1) // ratio if ratio > 1 else 0


@dataclass
class Parsed:
    """A stream as the reference reads it: frames grouped by size."""
    frames: list[stream.Frame]
    terms: list[int]
    faults: int = 0
    symbols: dict = field(default_factory=dict)     # fsize -> (indices, freqs, thres) or values


def read(data: bytes, cfg: Config, total: int) -> Parsed:
    """Parse `data` and hold its frames against the plan of `total` input
    samples."""
    try:
        frames, terms = cfg.rules.parse(data)
    except stream.StreamError:
        return Parsed([], [], faults=1)
    plan, nterms = frame_plan(total, cfg)
    p = Parsed(frames, terms)
    for i, f in enumerate(frames):
        ok = i < len(plan) and f.fsize == plan[i][2] and f.profile == cfg.profile \
            and f.channels == cfg.channels and f.srate == cfg.srate \
            and f.little_endian == cfg.little_endian \
            and f.overlap_ratio == (cfg.overlap_ratio if cfg.compact else 0) \
            and (f.bits == cfg.bit_depth)
        p.faults += not ok
    p.faults += abs(len(frames) - len(plan))
    p.faults += terms != [len(plan)] * nterms
    if p.faults:
        return p
    sizes = sorted({f.fsize for f in frames})
    try:
        for n in sizes:
            idx = [i for i, f in enumerate(frames) if f.fsize == n]
            p.symbols[n] = (idx, *cfg.rules.symbols([frames[i] for i in idx]))
    except stream.StreamError:
        p.faults += 1
    return p


def _frames_of(pcm: np.ndarray, plan, idx, n) -> np.ndarray:
    """The input frames `idx` of the plan, zero-padded to n samples: [F, n, C]."""
    out = np.zeros((len(idx), n, pcm.shape[1]))
    for j, i in enumerate(idx):
        start, read, _ = plan[i]
        out[j, :read] = pcm[start:start + read]
    return out


def _worst(x: torch.Tensor) -> float:
    """Largest element, inf when any is not finite, 0 for none."""
    if x.numel() == 0:
        return 0.0
    if not bool(torch.isfinite(x).all()):
        return math.inf
    return float(x.max())


#: channel-frames transformed at once (float64 [rows, N] blocks)
BLOCK_FRAMES = 1024


def _block(arrays, b: int, device) -> list[torch.Tensor]:
    return [torch.from_numpy(a[b:b + BLOCK_FRAMES]).to(device) for a in arrays]


def encode_excess(parsed: Parsed, pcm: np.ndarray, cfg: Config, device,
                  prec: Precision = REFERENCE) -> float:
    """`p1_symbol_excess` or `p0_coef_excess` of a parsed stream against
    the input PCM (see the module's docstring); inf when the stream was
    refused."""
    if parsed.faults:
        return math.inf
    plan, _ = frame_plan(len(pcm), cfg)
    worst = 0.0
    for n, (idx, *arrays) in parsed.symbols.items():
        for b in range(0, len(idx), BLOCK_FRAMES):
            x = torch.from_numpy(_frames_of(pcm, plan, idx[b:b + BLOCK_FRAMES], n)).to(device)
            ex = cfg.rules.excess(x, _block(arrays, b, device), cfg, prec)
            worst = max(worst, _worst(torch.clamp(ex, min=0)))
    return worst


def decode_pcm(parsed: Parsed, cfg: Config, device, prec: Precision = REFERENCE) -> np.ndarray:
    """The reference's decode of a parsed stream -> PCM [T, C] float64."""
    out: list[np.ndarray | None] = [None] * len(parsed.frames)
    for n, (idx, *arrays) in parsed.symbols.items():
        for b in range(0, len(idx), BLOCK_FRAMES):
            sel = idx[b:b + BLOCK_FRAMES]
            fr = cfg.rules.synthesis(_block(arrays, b, device), parsed.frames[sel[0]].bits, cfg,
                                     prec)
            fr = fr.double().cpu().numpy()
            for j, i in enumerate(sel):
                out[i] = fr[j]
    olaps = [overlap_of(f.fsize, f.overlap_ratio) for f in parsed.frames]
    return codec.overlap_add(out, olaps)


def pcm_gap(parsed: Parsed, got: np.ndarray, cfg: Config, device,
            prec: Precision = REFERENCE) -> float:
    """`pcm_gap` of the program's PCM `got` of a stream; inf when the
    stream was refused or the lengths differ."""
    if parsed.faults:
        return math.inf
    want = decode_pcm(parsed, cfg, device, prec)
    got = np.asarray(got, dtype=np.float64)
    if got.shape != want.shape:
        return math.inf
    d = np.abs(got - want)
    return float(d.max()) if np.isfinite(d).all() else math.inf


def control_symbols(parsed: Parsed, pcm: np.ndarray, cfg: Config, device,
                    prec: Precision = codec.CONTROL) -> Parsed:
    """The control in the program's place: `parsed` with every symbol (or
    coefficient) replaced by what the reference computes at `prec`,
    rounded (Profile 1) or truncated to the stream depth (Profile 0) as the
    format asks."""
    plan, _ = frame_plan(len(pcm), cfg)
    out = Parsed(parsed.frames, parsed.terms, parsed.faults)
    for n, (idx, *_) in parsed.symbols.items():
        parts = [cfg.rules.control(
            torch.from_numpy(_frames_of(pcm, plan, idx[b:b + BLOCK_FRAMES], n)).to(device), cfg,
            prec) for b in range(0, len(idx), BLOCK_FRAMES)]
        out.symbols[n] = (idx, *(np.concatenate(col) for col in zip(*parts)))
    return out
