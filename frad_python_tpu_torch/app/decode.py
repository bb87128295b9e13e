"""`decode` / `play` actions: .frad -> raw PCM or audio sink (the port of
`frad_python_tpu.app.decode`; reference src/decoder.py).

Output-file rotation on `crit` format changes, live telemetry with
per-frame header info at log level 2, and speed/pitch control via
sample-rate scaling. Playback uses sounddevice when available and
degrades to an error message otherwise (the reference hard-depends on
it). Regular files under 512 MiB decode through the batched pipeline
unless `--no-turbo` or `--exact` asks for the `Decoder`; the tensor work
runs on `params.device` (None: CUDA).
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..container.asfh import ASFH
from ..decoder import Decoder
from ..models import BIT_DEPTHS
from ..ops.pcm import ff_format_to_numpy_type, from_f64
from ..parallel import batch_decode
from ..utils.cli import CliParams
from ..utils.fmt import PIPEIN, PIPEOUT, check_overwrite, get_file_stem
from ..utils.telemetry import StreamStats, status_line


def _log(loglevel: int, info: StreamStats, linefeed: bool, asfh: ASFH) -> None:
    if loglevel == 0:
        return
    lines = [status_line(info)]
    if loglevel > 1:
        depths = BIT_DEPTHS[asfh.profile]
        depth = depths[asfh.bit_depth_index] if asfh.bit_depth_index < len(depths) else "?"
        ecc = "disabled" if not asfh.ecc else f"{asfh.ecc_dsize}/{asfh.ecc_codesize}"
        lines.append(f"Profile {asfh.profile}, {depth}bits "
                     f"{asfh.channels}ch@{asfh.srate}Hz, ECC={ecc}    ")
    print("\n".join(lines), end="", file=sys.stderr)
    if linefeed:
        print(file=sys.stderr)
    else:
        for _ in range(len(lines) - 1):
            print("\x1b[1A", end="", file=sys.stderr)
        print("\r", end="", file=sys.stderr)


class _Sink:
    """Audio output sink; lazily (re)opens a sounddevice stream."""

    def __init__(self) -> None:
        try:
            import sounddevice
            self.sd = sounddevice
        except (ImportError, OSError):      # the package, or its PortAudio library
            print("Playback requires the `sounddevice` package, which is "
                  "not available.", file=sys.stderr)
            raise SystemExit(1)
        self.stream = None
        self.srate = 0
        self.channels = 0

    def write(self, pcm: np.ndarray, srate: int) -> None:
        if pcm.size == 0:
            return
        ch = pcm.shape[1]
        if self.stream is None or self.srate != srate or self.channels != ch:
            if self.stream is not None:
                self.stream.close()
            self.stream = self.sd.OutputStream(samplerate=srate, channels=ch,
                                               dtype="float32")
            self.stream.start()
            self.srate, self.channels = srate, ch
        self.stream.write(np.ascontiguousarray(pcm, dtype=np.float32))

    def close(self) -> None:
        if self.stream is not None:
            self.stream.close()


def decode(input_path: str, params: CliParams, play: bool = False) -> None:
    if input_path == "":
        print("Input file must be given", file=sys.stderr)
        raise SystemExit(1)

    rpipe = input_path in PIPEIN
    if not rpipe and not os.path.exists(input_path):
        print("Input file doesn't exist", file=sys.stderr)
        raise SystemExit(1)

    wfile_prim = params.output
    wpipe = wfile_prim in PIPEOUT or play
    if not (rpipe or play or wpipe) and wfile_prim \
            and os.path.exists(wfile_prim) and os.path.samefile(input_path, wfile_prim):
        print("Input and output files cannot be the same", file=sys.stderr)
        raise SystemExit(1)

    if wfile_prim == "":
        wfile_prim = get_file_stem(input_path)
    elif wfile_prim.endswith(".pcm"):
        wfile_prim = wfile_prim[:-4]
    wfile_path = f"{wfile_prim}.pcm"
    if not wpipe:
        check_overwrite(wfile_path, params.overwrite)

    readfile = sys.stdin.buffer if rpipe else open(input_path, "rb")
    writefile = sys.stdout.buffer if (wpipe and not play) else (
        None if play else open(wfile_path, "wb"))
    if play:
        params.loglevel = 0
    sink = _Sink() if play else None

    speed = params.speed if params.speed > 0 else 1.0
    pcm_fmt = ff_format_to_numpy_type(params.pcm)

    def emit(pcm: np.ndarray, srate: int) -> None:
        if pcm.size == 0:
            return
        if play:
            sink.write(pcm, int(srate * speed))
        else:
            writefile.write(from_f64(pcm, pcm_fmt).astype(pcm_fmt).tobytes())

    info = StreamStats()

    use_turbo = params.turbo if params.turbo is not None else (
        not rpipe and not play
        and os.path.getsize(input_path) < (1 << 29))
    if params.exact:
        # bit-exact per-frame mode forfeits every batched fast path
        use_turbo = False
    if use_turbo and not rpipe and not play:
        stream = readfile.read()
        no = 0
        while stream:
            pcm, srate, rest = batch_decode(stream, fix_error=params.enable_ecc,
                                            return_remainder=True, device=params.device)
            info.log(len(stream) - len(rest), len(pcm), srate)
            emit(np.atleast_2d(pcm), srate or 48000)
            if not rest or len(rest) >= len(stream):
                break
            stream = rest
            if not wpipe:   # rotate output like the streaming path (crit)
                no += 1
                wfile_path = f"{wfile_prim}.{no}.pcm"
                check_overwrite(wfile_path, params.overwrite)
                writefile = open(wfile_path, "wb")
        _log(params.loglevel, info, True, ASFH())
        return

    decoder = Decoder(params.enable_ecc,
                      exact=True if params.exact else None, device=params.device)
    no = 0
    # deep reads let the decoder micro-batch frame drains into single
    # device calls (Decoder._drain_pending); playback and pipes
    # keep the reference's 32 KiB loop for interactive latency
    read_size = 32768 if (rpipe or play) else (8 << 20)
    while True:
        buf = readfile.read(read_size)
        if not buf and decoder.is_empty():
            break
        res = decoder.process(buf)
        info.log(len(buf), len(res.pcm), decoder.get_asfh().srate)
        emit(res.pcm, int((res.srate or 48000)))
        _log(params.loglevel, info, False, decoder.get_asfh())

        if res.crit and not wpipe:
            no += 1
            wfile_path = f"{wfile_prim}.{no}.pcm"
            info.pause()
            check_overwrite(wfile_path, params.overwrite)
            info.resume()
            writefile = open(wfile_path, "wb")

    res = decoder.flush()
    info.log(0, len(res.pcm), decoder.get_asfh().srate)
    emit(res.pcm, int(res.srate or 48000))
    _log(params.loglevel, info, True, decoder.get_asfh())
    if play:
        sink.close()
