"""`meta` action: inspect or rewrite the metadata header of a FrAD file.

The port of `frad_python_tpu.app.metadata` (reference src/header.py),
host only: add/remove/rm-img/overwrite rebuild the file header in place without
decoding audio; parse exports metadata to JSON plus the embedded image.

Design: each modification is a pure `(meta, image) -> (meta, image)`
transform in `_TRANSFORMS`; the splice writes `header + body` to a
sibling temp file and `os.replace`s it over the original, so a crash
mid-rewrite never corrupts the input (the reference buffers the body in
a tempfile and rewrites the original in place). Image type sniffing uses
a local magic-number table (the reference's `filetype` package is not a
baked-in dependency here).
"""

from __future__ import annotations

import base64
import json
import os
import sys
import tempfile

from ..common import FRM_SIGN, SIGNATURE
from ..container import head
from ..utils.cli import (META_ADD, META_OVERWRITE, META_PARSE, META_REMOVE,
                         META_RMIMG, CliParams)
from ..utils.fmt import get_file_stem

MetaList = list[tuple[str, bytes]]

_IMAGE_MAGIC = (
    (b"\x89PNG", "png"), (b"\xff\xd8\xff", "jpg"), (b"GIF8", "gif"),
    (b"RIFF", "webp"), (b"BM", "bmp"), (b"II*\x00", "tiff"), (b"MM\x00*", "tiff"),
)


def _sniff_ext(img: bytes) -> str:
    return next((ext for magic, ext in _IMAGE_MAGIC if img.startswith(magic)),
                "image")


def _fail(msg: str) -> None:
    print(msg, file=sys.stderr)
    raise SystemExit(1)


def _read_header(path: str) -> tuple[MetaList, bytes, int]:
    """Parse the file's metadata header; returns (meta, image, header_len).

    Headerless files (first bytes are a frame sign) are valid FrAD with
    an empty header; anything else is rejected.
    """
    with open(path, "rb") as f:
        probe = f.read(16)
        if probe[:4] == SIGNATURE:
            head_len = int.from_bytes(probe[8:16], "big")
        elif probe[:4] == FRM_SIGN:
            head_len = 0
        else:
            _fail("It seems this is not a valid FrAD file.")
        f.seek(0)
        meta, image = head.parser(f.read(head_len))
    return meta, image, head_len


def _export(path: str, meta: MetaList, image: bytes) -> None:
    """`parse`: dump metadata as JSON (+ image file) next to the input."""
    entries = []
    for key, data in meta:
        try:
            entries.append({"key": key, "type": "string",
                            "value": data.decode("utf-8")})
        except UnicodeDecodeError:
            entries.append({"key": key, "type": "base64",
                            "value": base64.b64encode(data).decode()})
    stem = get_file_stem(path)
    with open(f"{stem}.json", "w", encoding="utf-8") as f:
        json.dump(entries, f, ensure_ascii=False, indent=2)
    if image:
        with open(f"{stem}.{_sniff_ext(image)}", "wb") as f:
            f.write(image)


def _load_image(params: CliParams) -> bytes:
    if params.image_path and os.path.exists(params.image_path):
        with open(params.image_path, "rb") as f:
            return f.read()
    return b""


#: modtype -> (old_meta, old_img, params) -> (new_meta, new_img)
_TRANSFORMS = {
    META_ADD: lambda meta, img, p: (
        list(meta) + list(p.meta), _load_image(p) or img),
    META_REMOVE: lambda meta, img, p: (
        [kv for kv in meta if kv[0] not in {k for k, _ in p.meta}], img),
    META_RMIMG: lambda meta, img, p: (meta, b""),
    META_OVERWRITE: lambda meta, img, p: (list(p.meta), _load_image(p)),
}


def modify(path: str, modtype: str, params: CliParams) -> None:
    if not path:
        _fail("Input file must be given")
    if not os.path.exists(path):
        _fail("Input file does not exist")

    meta, image, head_len = _read_header(path)

    if modtype == META_PARSE:
        _export(path, meta, image)
        return
    transform = _TRANSFORMS.get(modtype)
    if transform is None:
        _fail("Invalid modification type.")
    meta, image = transform(meta, image, params)

    # splice: new header + untouched audio body, atomically swapped in
    folder = os.path.dirname(os.path.abspath(path))
    fd, tmp_path = tempfile.mkstemp(dir=folder, suffix=".frad.tmp")
    try:
        with os.fdopen(fd, "wb") as out, open(path, "rb") as src:
            out.write(head.builder(meta, image))
            src.seek(head_len)
            while (chunk := src.read(1 << 20)):
                out.write(chunk)
        os.replace(tmp_path, path)
    except BaseException:
        os.unlink(tmp_path)
        raise
