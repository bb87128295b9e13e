"""Human-readable formatting and path helpers for the CLI surface (copy
of `frad_python_tpu.utils.fmt`).

The OUTPUT formats are part of the app's user-facing contract (the
reference prints the same strings — src/common.py:12-39): Julian-year
clock readouts, 3-significant-digit SI prefixes, and adaptive-precision
speed factors. The implementations here are table-driven rather than
cascaded conditionals.
"""

from __future__ import annotations

import os
import sys

PIPEIN = ("-", "/dev/stdin", "/dev/fd/0")
PIPEOUT = ("-", "/dev/stdout", "/dev/fd/1")

#: Julian year in seconds (365.25 days) — the reference's time unit.
_JULIAN_YEAR = 31557600.0

#: clock fields below a year: (seconds per unit, printf width when inner)
_CLOCK_FIELDS = ((86400.0, 3), (3600.0, 2), (60.0, 2))

#: sub-second units, largest first
_SUBSECOND = ((1.0, "s"), (1e-3, "ms"), (1e-6, "µs"), (1e-9, "ns"))

_SI_PREFIXES = ("", "k", "M", "G", "T", "P", "E", "Z", "Y")


def get_file_stem(path: str) -> str:
    """Basename minus its last extension; pipes collapse to "pipe"."""
    if path in PIPEIN or path in PIPEOUT:
        return "pipe"
    name = os.path.basename(path)
    stem, dot, _ = name.rpartition(".")
    return stem if dot and stem else name


def format_time(n: float) -> str:
    """Adaptive clock format: `J<years>.ddd:hh:mm:ss.mmm` down to ns."""
    if n < 0.0:
        return f"-{format_time(-n)}"
    if n < 60.0:
        for scale, unit in _SUBSECOND:
            if n >= scale:
                return f"{n / scale:.3f} {unit}"
        return "0"

    years, rem = divmod(n, _JULIAN_YEAR)
    fields: list[tuple[int, int]] = []
    for size, width in _CLOCK_FIELDS:
        q, rem = divmod(rem, size)
        fields.append((int(q), width))

    if years:
        clock = ":".join(f"{v:0{w}d}" for v, w in fields)
        return f"J{int(years)}.{clock}:{rem:06.3f}"
    while len(fields) > 1 and fields[0][0] == 0:
        fields.pop(0)
    head = str(fields[0][0])
    tail = "".join(f":{v:0{w}d}" for v, w in fields[1:])
    return f"{head}{tail}:{rem:06.3f}"


def format_si(n: float) -> str:
    """3-decimal SI-prefixed magnitude, e.g. 1234 -> `1.234 k`."""
    if n == 0:
        return "0 "
    mag = abs(n)
    idx = 0
    while mag >= 1000.0 and idx < len(_SI_PREFIXES) - 1:
        mag /= 1000.0
        idx += 1
    sign = "-" if n < 0 else ""
    return f"{sign}{mag:.3f} {_SI_PREFIXES[idx]}"


def format_speed(n: float) -> str:
    """Realtime factor with ~3 significant digits."""
    decimals = 0 if n >= 100.0 else 1 if n >= 10.0 else 2 if n >= 1.0 else 3
    return f"{n:.{decimals}f}"


def check_overwrite(path: str, overwrite: bool) -> None:
    """Refuse to clobber an existing output unless forced or confirmed.

    Interactive runs get a Y/N prompt; non-interactive ones exit with
    a pointer to --force (reference common.py:41-50 behaviour).
    """
    if overwrite or not os.path.exists(path):
        return
    if not sys.stdin.isatty():
        print("Output file already exists, please provide --force(-y) flag "
              "to overwrite.", file=sys.stderr)
        raise SystemExit(0)
    print("Output file already exists, overwrite? (Y/N)", file=sys.stderr)
    while True:
        print("> ", end="", file=sys.stderr, flush=True)
        answer = input().strip().lower()
        if answer == "y":
            return
        if answer == "n":
            print("Aborted.", file=sys.stderr)
            raise SystemExit(0)
