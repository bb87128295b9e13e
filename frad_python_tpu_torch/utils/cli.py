"""CLI argument parsing: actions, flags and metadata file loaders.

Interface parity with the reference CLI (src/tools/cli.py): same action
aliases, same flag aliases and defaults (pcm=f64be, frame_size=2048,
profile=4, overlap=16, ecc (96,24)), same JSONMeta and Vorbis-comment
metadata file formats (spec: src/help/jsonmeta.txt, vorbismeta.txt).
A copy of `frad_python_tpu.utils.cli` with one flag of the port's own:
`--device <cpu|cuda|cuda:N>` picks the device of the tensor work. Without
it the engines take CUDA and raise when there is none; nothing else
selects the CPU.
"""

from __future__ import annotations

import base64
import json

ENCODE_OPT = ("encode", "enc")
DECODE_OPT = ("decode", "dec")
REPAIR_OPT = ("repair", "ecc")
PLAY_OPT = ("play", "p")
METADATA_OPT = ("meta", "metadata")
JSONMETA_OPT = ("jsonmeta", "jm")
VORBISMETA_OPT = ("vorbismeta", "vm")
PROFILES_OPT = ("profiles", "prf")
HELP_OPT = ("help", "h", "?")

META_ADD = "add"
META_REMOVE = "remove"
META_RMIMG = "rm-img"
META_OVERWRITE = "overwrite"
META_PARSE = "parse"


class CliParams:
    def __init__(self) -> None:
        self.output = ""
        self.pcm = "f64be"
        self.bits = 0
        self.srate = 0
        self.channels = 0
        self.frame_size = 2048
        self.little_endian = False
        self.profile = 4
        self.overlap_ratio = 16
        self.losslevel = 0
        self.enable_ecc = False
        self.ecc_ratio = (96, 24)
        self.overwrite = False
        self.overwrite_repair = False
        self.meta: list[tuple[str, bytes]] = []
        self.image_path = ""
        self.loglevel = 0
        self.speed = 1.0
        self.turbo: bool | None = None   # None = auto (regular files)
        self.exact = False               # bit-exact per-frame decoding
        self.device: str | None = None   # None = CUDA; "cpu" only on request

    def set_meta_from_json(self, path: str) -> None:
        """JSONMeta format: [{"key": .., "type": "string"|"base64", "value": ..}]."""
        for item in json.loads(open(path, encoding="utf-8").read()):
            key, itype, value = item.get("key"), item.get("type"), item.get("value")
            if key is None and value is None:
                continue
            key = key or ""
            value = value or ""
            data = base64.standard_b64decode(value) if itype == "base64" else value.encode()
            self.meta.append((key, data))

    def set_meta_from_vorbis(self, path: str) -> None:
        """Vorbis-comment file: KEY=VALUE lines, bare lines continue the
        previous value with a newline."""
        for line in open(path, encoding="utf-8"):
            parts = line.rstrip("\n").split("=", 1)
            if len(parts) == 1:
                if self.meta:
                    k, v = self.meta[-1]
                    self.meta[-1] = (k, v + f"\n{parts[0]}".encode())
                else:
                    self.meta.append(("", parts[0].encode()))
            else:
                self.meta.append((parts[0], parts[1].encode()))


_FLAG_HANDLERS = {
    ("output", "out", "o"): lambda p, a: setattr(p, "output", a.pop(0)),
    ("pcm", "format", "fmt", "f"): lambda p, a: setattr(p, "pcm", a.pop(0)),
    ("y", "force"): lambda p, a: setattr(p, "overwrite", True),
    ("overwrite", "ow"): lambda p, a: setattr(p, "overwrite_repair", True),
    ("bits", "bit", "b"): lambda p, a: setattr(p, "bits", int(a.pop(0))),
    ("srate", "sample-rate", "sr"): lambda p, a: setattr(p, "srate", int(a.pop(0))),
    ("chnl", "channels", "channel", "ch"): lambda p, a: setattr(p, "channels", int(a.pop(0))),
    ("frame-size", "fsize", "fr"): lambda p, a: setattr(p, "frame_size", int(a.pop(0))),
    ("overlap-ratio", "overlap", "olap"): lambda p, a: setattr(p, "overlap_ratio", int(a.pop(0))),
    ("le", "little-endian"): lambda p, a: setattr(p, "little_endian", True),
    ("profile", "prf", "p"): lambda p, a: setattr(p, "profile", int(a.pop(0))),
    ("losslevel", "level", "lv"): lambda p, a: setattr(p, "losslevel", int(a.pop(0))),
    ("jsonmeta", "jm"): lambda p, a: p.set_meta_from_json(a.pop(0)),
    ("vorbismeta", "vm"): lambda p, a: p.set_meta_from_vorbis(a.pop(0)),
    ("img", "image"): lambda p, a: setattr(p, "image_path", a.pop(0)),
    ("speed", "spd"): lambda p, a: setattr(p, "speed", float(a.pop(0))),
    ("keys", "key", "k"): lambda p, a: setattr(p, "speed", 2 ** (float(a.pop(0)) / 12)),
    ("turbo", "batch"): lambda p, a: setattr(p, "turbo", True),
    ("no-turbo", "streaming"): lambda p, a: setattr(p, "turbo", False),
    # strictly per-frame decoding: bit-identical output at every push
    # granularity, the reference's exact chunk invariance
    # (Decoder(exact=True); forfeits the micro-batched fast path)
    ("exact",): lambda p, a: setattr(p, "exact", True),
    # the port's own: where the tensor work runs (None: CUDA)
    ("device",): lambda p, a: setattr(p, "device", a.pop(0)),
}


def parse(argv: list[str]) -> tuple[str, str, str, CliParams]:
    """argv (including executable) -> (action, metaaction, input, params)."""
    params = CliParams()
    args = list(argv)
    executable = args.pop(0)
    if not args:
        return "", "", "", params

    action = args.pop(0).lower()
    metaaction = ""
    if action in METADATA_OPT:
        if not args:
            raise SystemExit(
                f"Metadata action not specified, type `{executable} help meta` "
                "for available options.")
        metaaction = args.pop(0).lower()
    if not args:
        return action, "", "", params
    input_file = args.pop(0)

    while args:
        key = args.pop(0).lower()
        if not key.startswith("-"):
            continue
        key = key.lstrip("-")

        if key in ("ecc", "enable-ecc", "e"):
            params.enable_ecc = True
            if args and args[0].isnumeric():
                params.ecc_ratio = (int(args.pop(0)), int(args.pop(0)))
        elif key in ("tag", "meta", "m"):
            if metaaction == META_REMOVE:
                params.meta.append((args.pop(0), b""))
            else:
                params.meta.append((args.pop(0), args.pop(0).encode()))
        elif key in ("log", "v"):
            params.loglevel = int(args.pop(0)) if (args and args[0].isnumeric()) else 1
        else:
            for aliases, handler in _FLAG_HANDLERS.items():
                if key in aliases:
                    handler(params, args)
                    break

    return action, metaaction, input_file, params
