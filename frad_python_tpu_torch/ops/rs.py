"""Reed-Solomon GF(2^8) codec, vectorised across ECC blocks (numpy).

Wire-compatible with the JAX package's `ops/rs.py`: field GF(256) with
primitive polynomial 0x11D, generator element 2, fcr=0, systematic
encoding with parity appended. Every emitted codeword evaluates to zero
at the generator roots a^0..a^{nsym-1}.

* encode runs the parity LFSR across all blocks of a frame at once.
* decode computes all block syndromes vectorised (Horner across byte
  positions); only blocks with non-zero syndromes take the scalar
  Berlekamp-Massey + Chien + Forney repair.
* the C++ host module (`native`) runs both unless FRAD_TORCH_NO_NATIVE
  selects this numpy path.
"""

from __future__ import annotations

import functools

import numpy as np

_PRIM = 0x11D

#: GF(2^8) codewords hold at most 2^8 - 1 symbols. The FrAD wire format
#: cannot express larger ratios (encoders clamp dsize+codesize to 255),
#: so this module rejects them loudly instead of failing quietly.
MAX_CODEWORD = 255


def check_code_params(dsize: int, nsym: int) -> None:
    """Reject RS parameters GF(256) cannot honor.

    Raises ValueError when dsize + nsym exceeds 255: beyond that,
    Chien error positions alias mod 255 and the code silently loses
    its correction guarantee. The FrAD container never produces such
    ratios; this guard is for direct callers.
    """
    if nsym < 0:
        raise ValueError(f"RS parity size must be >= 0, got {nsym}")
    if dsize < 1:
        raise ValueError(
            f"RS data size must be >= 1, got {dsize} (a codeword must "
            "hold at least one data symbol beyond its parity)")
    if dsize + nsym > MAX_CODEWORD:
        raise ValueError(
            f"RS(dsize={dsize}, nsym={nsym}) needs a {dsize + nsym}-symbol "
            f"codeword; GF(256) codewords are limited to {MAX_CODEWORD} "
            "symbols and the FrAD wire format cannot express larger ratios "
            "(use dsize + nsym <= 255)")

_EXP = np.zeros(512, dtype=np.uint8)
_LOG = np.zeros(256, dtype=np.int32)
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= _PRIM
_EXP[255:510] = _EXP[:255]


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(_EXP[_LOG[a] + _LOG[b]])


def gf_div(a: int, b: int) -> int:
    if a == 0:
        return 0
    if b == 0:
        raise ZeroDivisionError("GF division by zero")
    return int(_EXP[(_LOG[a] - _LOG[b]) % 255])


def gf_pow(a: int, n: int) -> int:
    if a == 0:
        return 0
    return int(_EXP[(_LOG[a] * n) % 255])


@functools.lru_cache(maxsize=64)
def generator_poly(nsym: int) -> tuple[int, ...]:
    """Monic generator polynomial prod_{i<nsym} (x - a^i), high-first."""
    g = [1]
    for i in range(nsym):
        root = gf_pow(2, i)
        nxt = [0] * (len(g) + 1)
        for j, c in enumerate(g):
            nxt[j] ^= c  # times x
            nxt[j + 1] ^= gf_mul(c, root)
        g = nxt
    return tuple(g)


def encode_blocks(data: np.ndarray, nsym: int) -> np.ndarray:
    """[nblocks, dsize] uint8 -> [nblocks, nsym] parity, all blocks at once."""
    if nsym <= 0:
        return np.zeros((data.shape[0], 0), dtype=np.uint8)
    check_code_params(data.shape[1], nsym)
    from .. import native
    if native.enabled():
        return native.rs_encode_blocks(data, nsym)
    nblocks, dsize = data.shape
    g = generator_poly(nsym)
    g_log = np.array([_LOG[c] for c in g[1:]], dtype=np.int32)  # len nsym

    rem = np.zeros((nblocks, nsym), dtype=np.uint8)
    for i in range(dsize):
        fb = data[:, i] ^ rem[:, 0]
        rem[:, :-1] = rem[:, 1:]
        rem[:, -1] = 0
        nz = fb != 0
        if np.any(nz):
            rem[nz] ^= _EXP[_LOG[fb[nz]][:, None] + g_log[None, :]]
    return rem


def syndromes_blocks(codewords: np.ndarray, nsym: int) -> np.ndarray:
    """[nblocks, blen] -> [nblocks, nsym] syndromes S_j = C(a^j), Horner."""
    nblocks, blen = codewords.shape
    alpha_log = np.arange(nsym, dtype=np.int32)  # log of a^j is j
    synd = np.zeros((nblocks, nsym), dtype=np.uint8)
    for i in range(blen):
        # synd = synd * a^j + byte  (per column j)
        nz = synd != 0
        scaled = np.zeros_like(synd)
        scaled[nz] = _EXP[(_LOG[synd[nz]] + np.broadcast_to(alpha_log, synd.shape)[nz]) % 255]
        synd = scaled ^ codewords[:, i][:, None]
    return synd


def _poly_add(p: list[int], q: list[int]) -> list[int]:
    """GF(2^8) polynomial XOR-add, high-first coefficient lists."""
    n = max(len(p), len(q))
    out = [0] * n
    for i, c in enumerate(p):
        out[i + n - len(p)] = c
    for i, c in enumerate(q):
        out[i + n - len(q)] ^= c
    return out


def _berlekamp_massey(synd: list[int], nsym: int) -> list[int] | None:
    """Error-locator polynomial, returned low-first [1, l1, ...], or None
    when the implied error count exceeds correction capability."""
    err_loc = [1]  # high-first during iteration
    old_loc = [1]
    for i in range(nsym):
        delta = synd[i]
        for j in range(1, len(err_loc)):
            delta ^= gf_mul(err_loc[-(j + 1)], synd[i - j])
        old_loc = old_loc + [0]
        if delta != 0:
            if len(old_loc) > len(err_loc):
                dlog = _LOG[delta]
                new_loc = [int(_EXP[_LOG[c] + dlog]) if c else 0 for c in old_loc]
                old_loc = [gf_div(c, delta) for c in err_loc]
                err_loc = new_loc
            err_loc = _poly_add(err_loc, [gf_mul(delta, c) for c in old_loc])
    # strip leading zeros
    while err_loc and err_loc[0] == 0:
        err_loc = err_loc[1:]
    errs = len(err_loc) - 1
    if errs * 2 > nsym or not err_loc:
        return None
    return err_loc[::-1]


def _correct_block(cw: np.ndarray, synd: np.ndarray, nsym: int) -> np.ndarray | None:
    """Repair one codeword in place; None when uncorrectable."""
    blen = len(cw)
    loc = _berlekamp_massey([int(s) for s in synd], nsym)
    if loc is None:
        return None
    # Chien search: roots of the locator give error positions
    err_pos = []
    loc_hi = loc[::-1]  # high-first for eval
    for i in range(blen):
        # X_i = a^{blen-1-i}; error at i if locator(X_i^-1) == 0
        x_inv = gf_pow(2, (-(blen - 1 - i)) % 255)
        val = 0
        for c in loc_hi:
            val = gf_mul(val, x_inv) ^ c
        if val == 0:
            err_pos.append(i)
    if len(err_pos) != len(loc) - 1:
        return None

    # Forney: error magnitudes from the evaluator polynomial
    # omega = synd_poly * loc mod x^nsym  (synd low-first)
    synd_l = [int(s) for s in synd]
    omega = [0] * nsym
    for i, si in enumerate(synd_l):
        for j, lj in enumerate(loc):
            if i + j < nsym:
                omega[i + j] ^= gf_mul(si, lj)

    out = cw.copy()
    for pos in err_pos:
        x = gf_pow(2, blen - 1 - pos)          # X_k
        x_inv = gf_pow(2, (-(blen - 1 - pos)) % 255)
        # omega(X^-1)
        om = 0
        for c in omega[::-1]:
            om = gf_mul(om, x_inv) ^ c
        # formal derivative of locator at X^-1: odd terms only
        den = 0
        for j in range(1, len(loc), 2):
            den ^= gf_mul(loc[j], gf_pow(x_inv, j - 1))
        if den == 0:
            return None
        mag = gf_mul(x, gf_div(om, den))
        out[pos] ^= mag
    # verify
    if np.any(syndromes_blocks(out[None, :], nsym)[0]):
        return None
    return out


def decode_blocks(codewords: np.ndarray, nsym: int) -> tuple[np.ndarray, np.ndarray]:
    """Repair [nblocks, blen] codewords.

    Returns (corrected data portion [nblocks, blen-nsym], ok mask
    [nblocks]); uncorrectable blocks are returned zero-filled with
    ok=False (the caller semantics of `container/ecc.decode`).
    """
    if nsym <= 0:
        return codewords.copy(), np.ones(codewords.shape[0], dtype=bool)
    # a (possibly shortened) codeword still can't exceed 255 symbols
    check_code_params(codewords.shape[1] - nsym, nsym)
    from .. import native
    if native.enabled():
        return native.rs_decode_blocks(codewords, nsym)
    nblocks, blen = codewords.shape
    synd = syndromes_blocks(codewords, nsym)
    bad = np.any(synd != 0, axis=1)
    data = codewords[:, : blen - nsym].copy()
    ok = np.ones(nblocks, dtype=bool)
    for bi in np.flatnonzero(bad):
        fixed = _correct_block(codewords[bi], synd[bi], nsym)
        if fixed is None:
            data[bi] = 0
            ok[bi] = False
        else:
            data[bi] = fixed[: blen - nsym]
    return data, ok
