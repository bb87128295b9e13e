"""`repair` action: re-armor a FrAD stream with fresh RS parity.

The port of `frad_python_tpu.app.repair` (reference src/repairer.py),
host only: streams any file or pipe through the Repairer engine in 32 KiB pushes,
reports byte throughput, and with --overwrite atomically replaces the
input once the repaired copy is complete.
"""

from __future__ import annotations

import os
import sys

from ..repairer import Repairer
from ..utils.cli import CliParams
from ..utils.fmt import PIPEIN, PIPEOUT, check_overwrite, get_file_stem
from ..utils.telemetry import StreamStats, status_line


def _resolve_output(input_path: str, requested: str, from_pipe: bool,
                    overwrite_ok: bool) -> str:
    """Pick the repaired-copy path: `<stem>.repaired.<ext>` by default."""
    if requested:
        return requested
    if from_pipe:
        return "repaired.frad"
    _, _, ext = input_path.rpartition(".")
    out = f"{get_file_stem(input_path)}.repaired.{ext}"
    return out


def repair(input_path: str, params: CliParams) -> None:
    if not input_path:
        print("Input file must be given", file=sys.stderr)
        raise SystemExit(1)

    from_pipe = input_path in PIPEIN
    if not from_pipe and not os.path.exists(input_path):
        print("Input file doesn't exist", file=sys.stderr)
        raise SystemExit(1)

    out_path = _resolve_output(input_path, params.output, from_pipe,
                               params.overwrite)
    to_pipe = out_path in PIPEOUT
    if not from_pipe and not to_pipe and os.path.exists(out_path) \
            and os.path.samefile(input_path, out_path):
        print("Input and output files cannot be the same", file=sys.stderr)
        raise SystemExit(1)
    if not to_pipe:
        check_overwrite(out_path, params.overwrite)

    source = sys.stdin.buffer if from_pipe else open(input_path, "rb")
    dest = sys.stdout.buffer if to_pipe else open(out_path, "wb")

    engine = Repairer(params.ecc_ratio)
    for msg in engine.warnings:
        print(msg, file=sys.stderr)

    stats = StreamStats()

    def emit(data: bytes, *, final: bool = False) -> None:
        stats.log(len(data))
        dest.write(data)
        if params.loglevel:
            print(status_line(stats, bytes_only=True),
                  end="\n" if final else "\r", file=sys.stderr)

    while True:
        chunk = source.read(32768)
        if not chunk and engine.is_empty():
            break
        emit(engine.process(chunk))
    emit(engine.flush(), final=True)

    if params.overwrite_repair and not (from_pipe or to_pipe):
        dest.close()
        os.replace(out_path, input_path)
