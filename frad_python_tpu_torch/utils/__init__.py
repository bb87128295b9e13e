"""App-level utilities: CLI parsing, stream telemetry, formatting, host
allocator tuning, tracing, and stream damage for tests."""

from . import cli, fmt, telemetry
from .telemetry import StreamStats, status_line

__all__ = ["StreamStats", "cli", "fmt", "status_line", "telemetry"]
