"""Live stream telemetry for the app pipelines (copy of
`frad_python_tpu.utils.telemetry`).

The reference renders a `\\r`-refreshed stderr line from a mutable stats
object (src/tools/process.py:3-36, src/encoder.py:36-39). This module is
the framework's own take: `StreamStats` keeps per-sample-rate tallies on
a monotonic, pausable clock, and `status_line` renders the one status
string all three app pipelines (encode/decode/repair) share instead of
each carrying a private `_log`.
"""

from __future__ import annotations

import time
from typing import Callable

from .fmt import format_si, format_speed, format_time


class StreamStats:
    """Byte/sample tallies with a pausable monotonic wall clock.

    Samples are tracked per sample rate, so a stream whose rate changes
    mid-way (the decoder's `crit` path) still reports correct coded
    duration and mean bitrate. `clock` is injectable for tests.
    """

    __slots__ = ("_clock", "_epoch", "_halted_at", "_rates", "total_bytes")

    def __init__(self, clock: Callable[[], float] = time.monotonic) -> None:
        self._clock = clock
        self._epoch = clock()
        self._halted_at: float | None = None
        # srate -> [samples, bytes]
        self._rates: dict[int, list[int]] = {}
        self.total_bytes = 0

    def log(self, nbytes: int, samples: int = 0, srate: int = 0) -> None:
        """Account `nbytes` of stream and `samples` frames at `srate`."""
        self.total_bytes += nbytes
        if srate:
            tally = self._rates.setdefault(srate, [0, 0])
            tally[0] += samples
            tally[1] += nbytes

    @property
    def coded_seconds(self) -> float:
        """Audio seconds represented by everything logged so far."""
        return sum(samples / rate for rate, (samples, _) in self._rates.items())

    @property
    def bitrate(self) -> float:
        """Mean coded bits per audio second (0 until audio is logged)."""
        secs = self.coded_seconds
        if secs <= 0.0:
            return 0.0
        coded = sum(nbytes for _, nbytes in self._rates.values())
        return coded * 8.0 / secs

    @property
    def elapsed(self) -> float:
        """Wall seconds since construction, pauses excluded."""
        now = self._halted_at if self._halted_at is not None else self._clock()
        return now - self._epoch

    @property
    def speed(self) -> float:
        """Realtime factor: coded audio seconds per wall second."""
        wall = self.elapsed
        return self.coded_seconds / wall if wall > 0.0 else 0.0

    def pause(self) -> None:
        """Stop the wall clock (e.g. around an interactive prompt)."""
        if self._halted_at is None:
            self._halted_at = self._clock()

    def resume(self) -> None:
        if self._halted_at is not None:
            self._epoch += self._clock() - self._halted_at
            self._halted_at = None


def status_line(stats: StreamStats, *, bytes_only: bool = False) -> str:
    """The shared stderr status line.

    `bytes_only` is the repair pipeline's variant — no audio duration is
    known there, so it reports raw byte throughput instead.
    """
    if bytes_only:
        rate = stats.total_bytes / max(stats.elapsed, 1e-9)
        return (f"size={format_si(stats.total_bytes)}B "
                f"speed={format_si(rate)}B/s    ")
    return (f"size={format_si(stats.total_bytes)}B "
            f"time={format_time(stats.coded_seconds)} "
            f"bitrate={format_si(stats.bitrate)}bit/s "
            f"speed={format_speed(stats.speed)}x    ")
