"""FrAD file header: metadata comment blocks and embedded image (copy of
`frad_python_tpu.container.head`, host only).

Byte-level format parity with the reference header builder/parser
(src/libfrad/tools/head.py):

* File header: `fRad` signature + 4 reserved bytes + u64 total header
  length + 48 reserved bytes + blocks (reference head.py:28-38)
* Comment block: magic 0xFA 0xAA + u48 block length + u32 title length +
  title + data (reference head.py:6-10)
* Image block: magic 0xF5 + APIC-type byte (0b01000000 | pictype) +
  u64 block length + data (reference head.py:12-17)
* Tolerant parser that skips unknown bytes one at a time
  (reference head.py:40-61)
"""

from __future__ import annotations

from ..common import SIGNATURE

COMMENT_MAGIC = b"\xfa\xaa"
IMAGE_MAGIC = b"\xf5"


def comment_block(title: str, data: bytes) -> bytes:
    title_b = title.encode()
    body = title_b + data
    return (
        COMMENT_MAGIC
        + (len(body) + 12).to_bytes(6, "big")
        + len(title_b).to_bytes(4, "big")
        + body
    )


def image_block(data: bytes, pictype: int | None = None) -> bytes:
    pictype = pictype if pictype else 3
    if pictype > 20:
        pictype = 3
    return (
        IMAGE_MAGIC
        + bytes([0b01000000 | pictype])
        + (len(data) + 10).to_bytes(8, "big")
        + data
    )


def builder(meta: list[tuple[str, bytes]] | None, img: bytes = b"") -> bytes:
    """Serialise a complete file header (64-byte prologue + blocks)."""
    blocks = b"".join(comment_block(t, d) for t, d in (meta or []))
    if img:
        blocks += image_block(img)
    return (
        SIGNATURE
        + b"\x00" * 4
        + (64 + len(blocks)).to_bytes(8, "big")
        + b"\x00" * 48
        + blocks
    )


def parser(header: bytes) -> tuple[list[tuple[str, bytes]], bytes]:
    """Parse header block region into (metadata list, image bytes).

    Tolerant of garbage: unknown bytes are skipped one at a time, matching
    reference head.py:58-59. The input may include or exclude the 64-byte
    prologue; blocks are recognised purely by magic.
    """
    meta: list[tuple[str, bytes]] = []
    img = b""
    pos = 0
    n = len(header)
    view = memoryview(header)
    while n - pos >= 2:
        if view[pos:pos + 2] == COMMENT_MAGIC:
            block_length = int.from_bytes(view[pos + 2:pos + 8], "big")
            title_length = int.from_bytes(view[pos + 8:pos + 12], "big")
            title = bytes(view[pos + 12:pos + 12 + title_length]).decode()
            data = bytes(view[pos + 12 + title_length:pos + block_length])
            meta.append((title, data))
            pos += max(block_length, 1)
        elif view[pos] == IMAGE_MAGIC[0]:
            block_length = int.from_bytes(view[pos + 2:pos + 10], "big")
            img = bytes(view[pos + 10:pos + block_length])
            pos += max(block_length, 1)
        else:
            pos += 1
    return meta, img
