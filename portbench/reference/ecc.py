"""Plain Reed-Solomon armor and CRC-16 of FrAD frames, written from the
format's description and independent of the program.

The armor: a frame's payload is cut into blocks of `dsize` bytes, the last
block keeping its short length, and each block is followed by `nsym`
parity bytes of a systematic Reed-Solomon code over GF(2^8). The compact
header of an armored frame carries the CRC-16/ANSI of the armored
payload.

The code: GF(2^8) with the primitive polynomial x^8 + x^4 + x^3 + x^2 + 1
(0x11D), generator alpha = 2 and first consecutive root alpha^0, so the
generator polynomial is g(x) = (x - 1)(x - alpha) ... (x - alpha^(nsym - 1)).
A block's bytes are the coefficients of m(x), its first byte the highest;
its parity is m(x) x^nsym mod g(x), highest coefficient first. Leading
zero coefficients leave the remainder as it is, so a short block's parity
is that of the block with zeros put in front of it.

CRC-16/ANSI (also called CRC-16/ARC): the polynomial x^16 + x^15 + x^2 + 1
reflected (0xA001), initial value 0, no final XOR.
"""

from __future__ import annotations

import functools

import numpy as np

PRIMITIVE = 0x11D
CRC16_POLY = 0xA001


def _field_tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(512, dtype=np.int64)
    log = np.zeros(256, dtype=np.int64)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= PRIMITIVE
    exp[255:510] = exp[:255]
    return exp, log


EXP, LOG = _field_tables()


def gf_mul(a, b) -> np.ndarray:
    """Products in GF(2^8), elementwise."""
    a, b = np.asarray(a, dtype=np.int64), np.asarray(b, dtype=np.int64)
    return np.where((a == 0) | (b == 0), 0, EXP[LOG[a] + LOG[b]])


@functools.cache
def generator(nsym: int) -> np.ndarray:
    """g(x) = prod_{i < nsym} (x - alpha^i), highest coefficient first
    ([nsym + 1], leading 1). Subtraction is addition (XOR) in GF(2^8)."""
    g = np.array([1], dtype=np.int64)
    for i in range(nsym):
        g = np.append(g, 0) ^ np.insert(gf_mul(g, EXP[i]), 0, 0)
    return g


@functools.cache
def _feedback(nsym: int) -> np.ndarray:
    """[256, nsym] uint8: row f holds f * g(x)'s coefficients below the
    leading one, what the division subtracts when f leaves the register."""
    g = generator(nsym)[1:]
    return gf_mul(np.arange(256)[:, None], g[None, :]).astype(np.uint8)


def parity(blocks: np.ndarray, nsym: int) -> np.ndarray:
    """Parity [n, nsym] uint8 of n blocks [n, k] uint8 (short blocks padded
    at the front with zeros): the remainder of the long division of each
    block by g(x), all blocks a step at a time."""
    blocks = np.asarray(blocks, dtype=np.uint8)
    table = _feedback(nsym)
    reg = np.zeros((len(blocks), nsym), dtype=np.uint8)
    zero = np.zeros((len(blocks), 1), dtype=np.uint8)
    for col in range(blocks.shape[1]):
        out = blocks[:, col] ^ reg[:, 0]
        reg = np.concatenate([reg[:, 1:], zero], axis=1) ^ table[out]
    return reg


def armor(payload: bytes, dsize: int, nsym: int) -> bytes:
    """The armored payload: each block of `dsize` bytes followed by its
    parity; an empty payload stays empty."""
    if not payload:
        return b""
    data = np.frombuffer(payload, dtype=np.uint8)
    blocks = [(s, min(dsize, len(data) - s)) for s in range(0, len(data), dsize)]
    padded = np.zeros((len(blocks), dsize), dtype=np.uint8)
    for j, (s, n) in enumerate(blocks):
        padded[j, dsize - n:] = data[s:s + n]
    par = parity(padded, nsym)
    return b"".join(data[s:s + n].tobytes() + par[j].tobytes()
                    for j, (s, n) in enumerate(blocks))


def _crc16_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.int64)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ CRC16_POLY if c & 1 else c >> 1
        table[i] = c
    return table


CRC16_TABLE = _crc16_table()


def crc16(payloads: list[bytes]) -> np.ndarray:
    """CRC-16/ANSI of each payload, [len(payloads)] int64: all payloads a
    byte position at a time."""
    lens = np.fromiter((len(p) for p in payloads), dtype=np.int64, count=len(payloads))
    width = int(lens.max()) if len(lens) else 0
    mat = np.zeros((len(payloads), width), dtype=np.uint8)
    for i, p in enumerate(payloads):
        mat[i, :len(p)] = np.frombuffer(p, dtype=np.uint8)
    crc = np.zeros(len(payloads), dtype=np.int64)
    for j in range(width):
        nxt = (crc >> 8) ^ CRC16_TABLE[(crc ^ mat[:, j]) & 0xFF]
        crc = np.where(lens > j, nxt, crc)
    return crc
