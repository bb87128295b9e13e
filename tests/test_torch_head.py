"""The port's FrAD file header (`container/head.py`) against the JAX
package's: `builder`, `parser`, `comment_block` and `image_block` are
byte-identical on random metadata, and the port's parser reads what the
JAX builder writes (and the reverse)."""

import numpy as np
import pytest

from frad_python_tpu.common import SIGNATURE as JSIGNATURE
from frad_python_tpu.container import head as jhead
from frad_python_tpu_torch.common import SIGNATURE
from frad_python_tpu_torch.container import head as thead

TITLES = ["", "TITLE", "ARTIST", "タイトル", "clé ünïcode", "a" * 300, "🎵", "KEY WITH SPACES"]


def random_meta(seed: int) -> list[tuple[str, bytes]]:
    rng = np.random.default_rng(seed)
    meta = []
    for _ in range(int(rng.integers(0, 7))):
        title = TITLES[int(rng.integers(0, len(TITLES)))]
        kind = int(rng.integers(0, 4))
        if kind == 0:
            data = b""
        elif kind == 1:
            data = "värde 値".encode() * int(rng.integers(1, 4))
        else:
            data = rng.integers(0, 256, int(rng.integers(1, 2000)), dtype=np.uint8).tobytes()
        meta.append((title, data))
    return meta


def random_image(seed: int) -> bytes:
    rng = np.random.default_rng(1000 + seed)
    if seed % 3 == 0:
        return b""
    return b"\x89PNG" + rng.integers(0, 256, int(rng.integers(1, 5000)), dtype=np.uint8).tobytes()


def test_constants():
    assert SIGNATURE == JSIGNATURE == b"fRad"
    assert thead.COMMENT_MAGIC == jhead.COMMENT_MAGIC
    assert thead.IMAGE_MAGIC == jhead.IMAGE_MAGIC


@pytest.mark.parametrize("seed", range(12))
def test_builder_and_parser_identical(seed):
    meta, img = random_meta(seed), random_image(seed)
    built = thead.builder(meta, img)
    assert built == jhead.builder(meta, img)
    assert built[:4] == SIGNATURE
    assert int.from_bytes(built[8:16], "big") == len(built)
    # with and without the 64-byte prologue, by both parsers
    for blob in (built, built[64:]):
        got = thead.parser(blob)
        assert got == jhead.parser(blob)
        assert got == (meta, img)
    assert thead.builder(None) == jhead.builder(None) == thead.builder([])


@pytest.mark.parametrize("seed", range(6))
def test_blocks_identical(seed):
    rng = np.random.default_rng(seed)
    for title, data in random_meta(seed + 50) + [("", b"")]:
        assert thead.comment_block(title, data) == jhead.comment_block(title, data)
    data = rng.integers(0, 256, 333, dtype=np.uint8).tobytes()
    for pictype in (None, 0, 1, 3, 20, 21, 200):
        assert thead.image_block(data, pictype) == jhead.image_block(data, pictype)
    assert thead.image_block(b"") == jhead.image_block(b"")


@pytest.mark.parametrize("seed", range(8))
def test_parser_tolerates_garbage_between_blocks(seed):
    """Unknown bytes between blocks are skipped one at a time by both
    parsers alike (garbage free of the two block magics' first bytes, so
    that both must find exactly the blocks)."""
    rng = np.random.default_rng(seed)
    meta, img = random_meta(seed + 100), random_image(seed + 1)

    def garbage() -> bytes:
        g = rng.integers(0, 256, int(rng.integers(0, 40)), dtype=np.uint8)
        g = g[(g != 0xFA) & (g != 0xF5)]
        return g.tobytes()

    blob = garbage()
    for title, data in meta:
        blob += thead.comment_block(title, data) + garbage()
    if img:
        blob += thead.image_block(img) + garbage()
    assert thead.parser(blob) == jhead.parser(blob) == (meta, img)
    # raw random bytes: whatever they parse to, both parse the same
    noise = rng.integers(0, 256, 4000, dtype=np.uint8).tobytes()
    try:
        want = jhead.parser(noise)
    except UnicodeDecodeError as e:
        with pytest.raises(UnicodeDecodeError) as got:
            thead.parser(noise)
        assert str(got.value) == str(e)
    else:
        assert thead.parser(noise) == want
