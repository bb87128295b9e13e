"""Tracing utilities (the port of `frad_python_tpu.utils.tracing`):
`StageTimer`, a lightweight named wall-clock stage accumulator used to
attribute pipeline time (gather / core / d2h / host-pack / framing).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict


class StageTimer:
    """Accumulates wall-clock per named stage; pretty summary on demand.

    A stage may open inside another (the pipeline's `enc:h2d` inside
    `enc:core`, say): its wall is then also in its parent's, so the
    summary's shares are of the wall under the outermost stages, and a
    stage timed inside another is marked `(nested)`.

    Also meters device-link traffic: transfer sites call
    `add_bytes('h2d'|'d2h', n)` so a run can compute the effective link
    bandwidth per direction."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.bytes: dict[str, int] = defaultdict(int)
        #: the part of each stage's wall spent inside another stage
        self.nested: dict[str, float] = defaultdict(float)
        self._depth = threading.local()

    @contextlib.contextmanager
    def stage(self, name: str):
        depth = getattr(self._depth, "n", 0)
        self._depth.n = depth + 1
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._depth.n = depth
            self.totals[name] += dt
            self.counts[name] += 1
            if depth:
                self.nested[name] += dt

    def add_bytes(self, direction: str, n: int) -> None:
        self.bytes[direction] += int(n)

    def transfer_wait(self, direction: str) -> float:
        """Total wall-clock spent BLOCKED on `direction` transfers
        (stages named `enc:h2d`, `dec:d2h`, ...)."""
        return sum(t for name, t in self.totals.items()
                   if name.endswith(":" + direction))

    def summary(self) -> str:
        total = sum(self.totals.values()) - sum(self.nested.values()) or 1.0
        lines = [f"{name:>16}: {t:8.3f}s ({t / total * 100:5.1f}%) x{self.counts[name]}"
                 + (" (nested)" if self.nested.get(name) else "")
                 for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1])]
        for d in ("h2d", "d2h"):
            if self.bytes.get(d):
                w = self.transfer_wait(d)
                mb = self.bytes[d] / (1 << 20)
                eff = f" -> {mb / w:7.1f} MB/s blocked-effective" if w > 1e-9 else ""
                lines.append(f"{'link ' + d:>16}: {mb:8.1f} MB{eff}")
        return "\n".join(lines)
