"""`encode` action: raw PCM file/pipe -> .frad (the port of
`frad_python_tpu.app.encode`; reference src/encoder.py).

Extension policy, metadata header, 32 KiB streaming loop and live
telemetry match the reference. Regular files under 512 MiB go through
the batched pipeline (`parallel.batch_encode`) unless `--no-turbo` asks
for the incremental `Encoder`; pipes always stream. The tensor work runs
on `params.device` (None: CUDA).
"""

from __future__ import annotations

import io
import os
import sys
from typing import BinaryIO

import numpy as np

from ..container import head
from ..encoder import Encoder
from ..models import LOSSLESS
from ..ops.pcm import ff_format_to_numpy_type, to_f64
from ..parallel import batch_encode
from ..utils.cli import CliParams
from ..utils.fmt import PIPEIN, PIPEOUT, check_overwrite, get_file_stem
from ..utils.telemetry import StreamStats, status_line


def set_files(rfile: str, wfile: str, profile: int, overwrite: bool
              ) -> tuple[io.BufferedReader | BinaryIO, io.BufferedWriter | BinaryIO]:
    rpipe = rfile in PIPEIN
    wpipe = wfile in PIPEOUT
    if not rpipe and not os.path.exists(rfile):
        print("Input file doesn't exist", file=sys.stderr)
        raise SystemExit(1)
    if not rpipe and not wpipe and wfile and os.path.exists(wfile) \
            and os.path.samefile(rfile, wfile):
        print("Input and output files cannot be the same", file=sys.stderr)
        raise SystemExit(1)

    if not wpipe:
        if wfile == "":
            wfile = get_file_stem(rfile)
        if not wfile.endswith((".frad", ".dsin", ".fra", ".dsn")):
            if profile in LOSSLESS:
                wfile += ".fra" if len(wfile) <= 8 else ".frad"
            else:
                wfile += ".dsn" if len(wfile) <= 8 else ".dsin"
        check_overwrite(wfile, overwrite)

    readfile = sys.stdin.buffer if rpipe else open(rfile, "rb")
    writefile = sys.stdout.buffer if wpipe else open(wfile, "wb")
    return readfile, writefile


def _log(loglevel: int, info: StreamStats, linefeed: bool) -> None:
    if loglevel == 0:
        return
    print(status_line(info), end="\n" if linefeed else "\r", file=sys.stderr)


def loss_level_from_cli(losslevel: int) -> float:
    """CLI level -> engine loss level: 1.25^lv/19 + 0.5 (reference
    src/encoder.py:55)."""
    return 1.25 ** losslevel / 19.0 + 0.5


def encode(input_path: str, params: CliParams) -> None:
    if input_path == "":
        print("Input file must be given", file=sys.stderr)
        raise SystemExit(1)
    if params.srate == 0:
        print("Sample rate should be set except zero", file=sys.stderr)
        raise SystemExit(1)
    if params.channels == 0:
        print("Channel count should be set except zero", file=sys.stderr)
        raise SystemExit(1)

    # Unset --bits defaults to 16 (the reference leaves 0, which silently
    # disables its encoder via an unchecked set_profile error).
    bits = params.bits or 16
    try:
        encoder = Encoder(params.profile, params.srate, params.channels,
                          bits, params.frame_size, params.pcm, device=params.device)
    except ValueError as e:
        print(e, file=sys.stderr)
        raise SystemExit(1)

    if (msg := encoder.set_ecc(params.enable_ecc, params.ecc_ratio)):
        print(msg, file=sys.stderr)
    encoder.set_little_endian(params.little_endian)
    encoder.set_overlap_ratio(params.overlap_ratio)
    encoder.set_loss_level(loss_level_from_cli(params.losslevel))

    rfile, wfile = set_files(input_path, params.output, params.profile,
                             params.overwrite)

    image = b""
    if params.image_path and os.path.exists(params.image_path):
        image = open(params.image_path, "rb").read()
    wfile.write(head.builder(params.meta, image))

    info = StreamStats()

    # auto-select the batched path for regular files (per-frame dispatch
    # latency makes streaming slow on accelerators); --no-turbo forces the
    # incremental engine, pipes always stream
    use_turbo = params.turbo if params.turbo is not None else (
        rfile is not sys.stdin.buffer
        and os.fstat(rfile.fileno()).st_size < (1 << 29))
    if use_turbo and rfile is not sys.stdin.buffer:
        # whole-file batched path
        dtype = ff_format_to_numpy_type(params.pcm)
        raw = rfile.read()
        usable = len(raw) // (dtype.itemsize * params.channels)
        pcm = np.frombuffer(raw[: usable * dtype.itemsize * params.channels],
                            dtype).reshape(-1, params.channels)
        pcm = to_f64(pcm, dtype)
        out = batch_encode(
            pcm, params.profile, encoder.srate, encoder.bit_depth,
            params.frame_size, loss_level=encoder.loss_level,
            enable_ecc=params.enable_ecc,
            ecc_ratio=(encoder.asfh.ecc_dsize, encoder.asfh.ecc_codesize),
            little_endian=params.little_endian,
            overlap_ratio=encoder.asfh.overlap_ratio, device=encoder.device)
        info.log(len(out), usable, encoder.get_srate())
        wfile.write(out)
        _log(params.loglevel, info, True)
        return

    # Deep reads let the engine micro-batch frames into one device call
    # (Encoder._micro_batch); pipes keep the reference's 32 KiB
    # loop for interactive latency (reference src/encoder.py:64).
    read_size = 32768 if rfile is sys.stdin.buffer else (8 << 20)
    while True:
        buf = rfile.read(read_size)
        if not buf:
            break
        res = encoder.process(buf)
        info.log(len(res.buf), res.samples, encoder.get_srate())
        wfile.write(res.buf)
        _log(params.loglevel, info, False)

    res = encoder.flush()
    info.log(len(res.buf), res.samples, encoder.get_srate())
    wfile.write(res.buf)
    _log(params.loglevel, info, True)
