"""What a traced run records, and the interval arithmetic that per-layer
metrics read from it.

* `Spans` stands in for the pipeline's stage timer (`pipeline.STAGES`):
  it keeps each stage's host interval, not only its total.
* `trace(fn, devices)` runs `fn` under `torch.profiler` with CUDA activity
  alone, kept in memory, after a warmup step and lead kernels (the
  recording recipe of `chip_smoke.profiled_device_ms`), and maps the
  device events onto the host clock through the first lead kernel.
* `Record` holds one window's calls, stages, pushes and device intervals.

Times are `time.perf_counter()` seconds throughout.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

WINDOW = "portbench:window"
#: throwaway kernels that open the recorded step (PERF.md: a recording
#: after a warmup step alone loses kernels)
LEADS = 8


class Spans:
    """The pipeline's stage timer interface (`stage(name)`, `add_bytes`),
    keeping every stage's (name, start, end)."""

    def __init__(self) -> None:
        self.items: list[tuple[str, float, float]] = []
        self.bytes: dict[str, int] = defaultdict(int)

    def stage(self, name: str):
        return _Stage(self.items, name)

    def add_bytes(self, direction: str, n: int) -> None:
        self.bytes[direction] += int(n)


class _Stage:
    __slots__ = ("items", "name", "t0")

    def __init__(self, items, name):
        self.items, self.name = items, name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        self.items.append((self.name, self.t0, time.perf_counter()))


@dataclass
class Call:
    kind: str            # "encode", "decode", "stream_encode", "stream_decode"
    entry: str           # the program's entry point, the host label of its time
    t0: float
    t1: float
    frames: int
    least_s: float       # the card's least time for the call's work (work.py)


@dataclass
class Record:
    window: tuple[float, float]
    calls: list[Call]
    pushes: np.ndarray = field(default_factory=lambda: np.zeros(0))
    spans: list[tuple[str, float, float]] = field(default_factory=list)
    #: card index -> [(name, start, end)] of kernels and copies, host clock
    device: dict[int, list[tuple[str, float, float]]] = field(default_factory=dict)
    cards: int = 1

    def calls_of(self, kinds) -> list[Call]:
        return [c for c in self.calls if c.kind in kinds]

    def busy(self, card: int) -> np.ndarray:
        """Merged [k, 2] busy intervals of one card."""
        ev = self.device.get(card, [])
        return merge(np.array([(a, b) for _, a, b in ev], dtype=np.float64).reshape(-1, 2))

    def busy_all(self) -> np.ndarray:
        """Merged busy intervals of every card together."""
        ev = [(a, b) for evs in self.device.values() for _, a, b in evs]
        return merge(np.array(ev, dtype=np.float64).reshape(-1, 2))


def merge(iv: np.ndarray) -> np.ndarray:
    """Union of [k, 2] intervals as sorted disjoint [m, 2] intervals."""
    if len(iv) == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), dtype=bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    last = np.flatnonzero(np.append(new[1:], True))
    return np.stack([starts, ends[last]], axis=1)


def covered(merged: np.ndarray, a: float, b: float) -> float:
    """Length of [a, b] that the merged intervals cover."""
    if len(merged) == 0 or b <= a:
        return 0.0
    lo = np.clip(merged[:, 0], a, b)
    hi = np.clip(merged[:, 1], a, b)
    return float(np.sum(hi - lo))


def covered_in(merged: np.ndarray, spans: list[tuple[float, float]]) -> float:
    return sum(covered(merged, a, b) for a, b in spans)


def gaps(merged: np.ndarray, a: float, b: float) -> np.ndarray:
    """The complement of the merged intervals within [a, b], as [m, 2]."""
    inside = merged[(merged[:, 1] > a) & (merged[:, 0] < b)] if len(merged) else merged
    edges = np.concatenate([[a], np.clip(inside.reshape(-1), a, b), [b]])
    g = edges.reshape(-1, 2)
    return g[g[:, 1] > g[:, 0]]


def labels(rec: Record) -> list[tuple[float, float, str]]:
    """The window cut into segments labelled by the innermost host span open
    in each: a pipeline stage, else the program entry of a call, else the
    window itself."""
    spans = [(rec.window[0], rec.window[1], WINDOW)]
    spans += [(c.t0, c.t1, c.entry) for c in rec.calls]
    spans += [(a, b, n) for n, a, b in rec.spans]
    bounds = sorted([(a, 0, -(b - a), i) for i, (a, b, _) in enumerate(spans)]
                    + [(b, 1, 0.0, i) for i, (a, b, _) in enumerate(spans)])
    out, stack, prev = [], [], None
    for t, kind, _, i in bounds:
        if prev is not None and stack and t > prev:
            out.append((prev, t, spans[stack[-1]][2]))
        if kind == 0:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
        prev = t
    return out


def idle_by_label(rec: Record) -> dict[str, float]:
    """Seconds of the window with no kernel or copy on any card, by the host
    label open at the time."""
    idle = gaps(rec.busy_all(), *rec.window)
    out: dict[str, float] = defaultdict(float)
    segs = labels(rec)
    j = 0
    for a, b in idle:
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            s0, s1, name = segs[k]
            out[name] += max(0.0, min(b, s1) - max(a, s0))
            k += 1
    return dict(out)


def device_ops(rec: Record) -> dict[str, float]:
    """Device seconds by kernel or copy name, summed over the cards."""
    out: dict[str, float] = defaultdict(float)
    for evs in rec.device.values():
        for name, a, b in evs:
            out[name] += b - a
    return dict(out)


def _sync(torch, devices) -> None:
    for d in devices:
        torch.cuda.synchronize(d)


def trace(torch, fn, devices):
    """(fn's result, {card: [(name, start, end)]} on the host clock) of one
    recording of `fn` under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    leads = [torch.zeros(1, device=d) for d in devices]
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for lead in leads:
            lead.add_(1)
        _sync(torch, devices)
        prof.step()
        _sync(torch, devices)
        t_lead = time.perf_counter()
        for _ in range(LEADS):
            for lead in leads:
                lead.add_(1)
        _sync(torch, devices)
        result = fn()
        _sync(torch, devices)
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        return result, {}
    first = min(e.time_range.start for e in events)
    offset = t_lead - first * 1e-6
    out: dict[int, list] = defaultdict(list)
    for e in events:
        out[int(e.device_index)].append((e.name, e.time_range.start * 1e-6 + offset,
                                         e.time_range.end * 1e-6 + offset))
    return result, dict(out)


# -- what the per-layer readers share --------------------------------------

def stage_share(rec: Record, kinds, stages) -> float | None:
    """Share (%) of the calls' wall spent in the named pipeline stages."""
    calls = rec.calls_of(kinds)
    wall = sum(c.t1 - c.t0 for c in calls)
    if not calls or not rec.spans:
        return None
    inside = merge(np.array([(a, b) for n, a, b in rec.spans if n in stages],
                            dtype=np.float64).reshape(-1, 2))
    return 100.0 * covered_in(inside, [(c.t0, c.t1) for c in calls]) / wall


def _busy_in(rec: Record, kinds) -> tuple[list[Call], list[float]]:
    calls = rec.calls_of(kinds)
    spans = [(c.t0, c.t1) for c in calls]
    return calls, [covered_in(rec.busy(c), spans) for c in range(rec.cards)]


def idle_share(rec: Record, kinds) -> float | None:
    """Share (%) of the calls' wall with no kernel or copy on a card, the
    mean over the cards."""
    calls, busy = _busy_in(rec, kinds)
    if not calls or not rec.device or not busy:
        return None
    wall = sum(c.t1 - c.t0 for c in calls)
    return 100.0 * sum(1.0 - b / wall for b in busy) / len(busy)


def roofline(rec: Record, kinds) -> float | None:
    """The card's least time for the calls' work (work.py) over the device
    time of the calls, summed over the cards, in %."""
    calls, busy = _busy_in(rec, kinds)
    if not calls or sum(busy) <= 0:
        return None
    return 100.0 * sum(c.least_s for c in calls) / sum(busy)


def card_overlap(rec: Record, kinds) -> float | None:
    """The cards' summed busy time over the union of their busy intervals
    within the calls: 1.0 when no two cards ever run at once."""
    calls, busy = _busy_in(rec, kinds)
    if rec.cards < 2 or sum(b > 0 for b in busy) < 2:
        return None
    union = covered_in(rec.busy_all(), [(c.t0, c.t1) for c in calls])
    return sum(busy) / union
