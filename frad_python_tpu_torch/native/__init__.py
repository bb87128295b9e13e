"""The C++ host module: ctypes bindings of `frad_native.cpp`.

The port's host byte work runs through this library, as the JAX
package's main path runs through its own copy: CRC-16, Exp-Golomb-Rice,
Reed-Solomon blocks, PCM casts (int16 and int24), the truncated-float
packings of the lossless profiles, and the batched passes of the
pipeline (Profile 1 payload pack and unpack, frame pack, frame parse, ECC
unarmor), threaded in C++.

The library is built at first use (`build.py`) and every symbol must
bind: a failed build or load raises, there is no silent fallback.
`FRAD_TORCH_NO_NATIVE=1` selects the numpy paths on purpose: callers
test `enabled()`. Each wrapper counts its calls in its `calls` attribute,
as the CUDA kernels count `launches`.
"""

from __future__ import annotations

import ctypes
import functools
import os
import threading

import numpy as np

_C = ctypes
_P, _I, _I64, _SZ = _C.c_void_p, _C.c_int, _C.c_int64, _C.c_size_t
_I64P = _C.POINTER(_C.c_int64)
#: C entry points: (restype, argtypes)
SIGNATURES = {
    "frad_crc16_ansi": (_C.c_uint16, [_C.c_char_p, _SZ]),
    "frad_egr_encode": (_SZ, [_I64P, _SZ, _C.c_char_p]),
    "frad_egr_decode": (_SZ, [_C.c_char_p, _SZ, _I64P]),
    "frad_rs_encode_blocks": (None, [_C.c_char_p, _SZ, _SZ, _SZ, _C.c_char_p]),
    "frad_rs_decode_blocks": (None, [_C.c_char_p, _SZ, _SZ, _SZ, _C.c_char_p]),
    "frad_i16_to_f64": (None, [_P, _SZ, _C.c_double, _P, _I]),
    "frad_f64_to_i16": (None, [_P, _SZ, _C.c_double, _P, _I]),
    "frad_i24_to_f64": (None, [_C.c_char_p, _SZ, _P, _I]),
    "frad_f64_to_i24": (None, [_P, _SZ, _P, _I]),
    "frad_pack_floats": (None, [_P, _SZ, _I, _I, _P, _I]),
    "frad_unpack_floats": (None, [_C.c_char_p, _SZ, _I, _I, _P, _I]),
    "frad_maxabs_rows": (None, [_P, _SZ, _SZ, _P, _I]),
    "frad_pack_floats_maxabs": (None, [_P, _SZ, _SZ, _I, _I, _P, _P, _I]),
    "frad_p1_unpack_batch": (None, [_C.c_char_p, _I64P, _I64, _I64, _I64, _I64,
                                    _P, _P, _P, _P, _I]),
    "frad_p1_pack_batch": (None, [_P, _I64P, _I64P, _P, _I64, _I64, _I64P, _I64,
                                  _P, _I64, _I64P, _I]),
    "frad_frame_pack_batch": (None, [_C.c_char_p, _I64P, _I64, _P, _P, _P,
                                     _I, _I, _I, _C.c_uint32, _I, _I, _I,
                                     _I, _I, _I, _P, _I64P, _I]),
    "frad_unarmor_batch": (None, [_C.c_char_p, _I64P, _I64, _I, _I, _P, _I, _I,
                                  _P, _I64P, _P, _I]),
    "frad_frame_parse_batch": (_I64, [_C.c_char_p, _I64, _I64] + [_P] * 12 + [_I64P]),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

#: every counted wrapper, in definition order
WRAPPERS: list = []


def enabled() -> bool:
    """False when FRAD_TORCH_NO_NATIVE selects the numpy host paths."""
    return not os.environ.get("FRAD_TORCH_NO_NATIVE")


def library() -> ctypes.CDLL:
    """The loaded library, built at first use; raises when the build,
    the load or any symbol fails."""
    global _lib
    from . import build

    with _lock:
        if _lib is None:
            path, _ = build.build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f"cannot load {path}: {e}") from e
            missing = [name for name in SIGNATURES if not hasattr(lib, name)]
            if missing:
                raise RuntimeError(f"{path} lacks {', '.join(missing)}")
            for name, (restype, argtypes) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
        return _lib


def reset_calls() -> None:
    """Set every wrapper's call count to 0."""
    for w in WRAPPERS:
        w.calls = 0


def _counted(fn):
    """Count the wrapper's completed library calls in `fn.calls`."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        wrapper.calls += 1
        return out

    wrapper.calls = 0
    WRAPPERS.append(wrapper)
    return wrapper


def _offsets(parts: list[bytes]) -> np.ndarray:
    """[len(parts) + 1] int64 start offsets of `parts` joined."""
    offsets = np.zeros(len(parts) + 1, dtype=np.int64)
    np.cumsum([len(p) for p in parts], out=offsets[1:])
    return offsets


def _check_bits(bits: int) -> None:
    """The C float packers take the byte-aligned depths only (the 12-bit
    nibble packing stays in numpy)."""
    if bits not in (16, 24, 32, 48, 64):
        raise ValueError(f"native float packing takes 16/24/32/48/64 bits, not {bits}")


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(_I64P)


@_counted
def crc16_ansi(data: bytes) -> int:
    return int(library().frad_crc16_ansi(data, len(data)))


@_counted
def egr_encode(data: np.ndarray) -> bytes:
    data = np.ascontiguousarray(data, dtype=np.int64)
    n = len(data)
    out = ctypes.create_string_buffer(17 * n + 16)
    written = library().frad_egr_encode(_i64p(data), n, out)
    return out.raw[:written]


@_counted
def egr_decode(dbytes: bytes) -> np.ndarray:
    out = np.empty(max(8 * (len(dbytes) - 1), 1), dtype=np.int64)
    count = library().frad_egr_decode(dbytes, len(dbytes), _i64p(out))
    return out[:count].copy()


@_counted
def rs_encode_blocks(data: np.ndarray, nsym: int) -> np.ndarray:
    """[nblocks, dsize] uint8 -> [nblocks, nsym] parity."""
    from ..ops.rs import check_code_params

    nblocks, dsize = data.shape
    check_code_params(dsize, nsym)   # guards the C tables indexed by nsym
    data = np.ascontiguousarray(data, dtype=np.uint8)
    parity = np.empty((nblocks, nsym), dtype=np.uint8)
    library().frad_rs_encode_blocks(data.ctypes.data_as(_C.c_char_p), nblocks, dsize,
                                    nsym, parity.ctypes.data_as(_C.c_char_p))
    return parity


@_counted
def rs_decode_blocks(codewords: np.ndarray, nsym: int) -> tuple[np.ndarray, np.ndarray]:
    """Repair [nblocks, blen] codewords -> (data [nblocks, blen - nsym],
    ok [nblocks]); uncorrectable blocks come back zero-filled."""
    from ..ops.rs import check_code_params

    nblocks, blen = codewords.shape
    check_code_params(blen - nsym, nsym)
    cw = np.ascontiguousarray(codewords, dtype=np.uint8).copy()
    ok = np.empty(nblocks, dtype=np.uint8)
    library().frad_rs_decode_blocks(cw.ctypes.data_as(_C.c_char_p), nblocks, blen, nsym,
                                    ok.ctypes.data_as(_C.c_char_p))
    return cw[:, : blen - nsym], ok.astype(bool)


@_counted
def f64_to_i16(pcm: np.ndarray, scale: float = 32768.0, nthreads: int = 2) -> np.ndarray:
    """f64 PCM -> rint(x * scale) clamped to int16, shape preserved."""
    pcm = np.ascontiguousarray(pcm, dtype=np.float64)
    out = np.empty(pcm.shape, dtype=np.int16)
    library().frad_f64_to_i16(pcm.ctypes.data, pcm.size, scale, out.ctypes.data, nthreads)
    return out


@_counted
def i16_to_f64(arr: np.ndarray, scale: float = 1.0 / 32768.0,
               nthreads: int = 2) -> np.ndarray:
    """int16 -> f64 * scale, shape preserved."""
    arr = np.ascontiguousarray(arr, dtype=np.int16)
    out = np.empty(arr.shape, dtype=np.float64)
    library().frad_i16_to_f64(arr.ctypes.data, arr.size, scale, out.ctypes.data, nthreads)
    return out


@_counted
def f64_to_i24(pcm: np.ndarray, nthreads: int = 2) -> np.ndarray:
    """f64 PCM -> rint(x * 2^23) clamped to int24, as little-endian byte
    triples: uint8 [n * 3]."""
    pcm = np.ascontiguousarray(pcm, dtype=np.float64)
    out = np.empty(pcm.size * 3, dtype=np.uint8)
    library().frad_f64_to_i24(pcm.ctypes.data, pcm.size, out.ctypes.data, nthreads)
    return out


@_counted
def i24_to_f64(raw: bytes, nthreads: int = 2) -> np.ndarray:
    """Little-endian int24 triples -> f64 in [-1, 1); a length that is not
    a whole number of triples raises ValueError, as the numpy path does."""
    if len(raw) % 3:
        raise ValueError(f"i24 byte stream length {len(raw)} not a multiple of 3")
    out = np.empty(len(raw) // 3, dtype=np.float64)
    library().frad_i24_to_f64(raw, out.size, out.ctypes.data, nthreads)
    return out


@_counted
def pack_floats(values: np.ndarray, bits: int, little_endian: bool,
                nthreads: int = 3) -> bytes:
    """Truncated-float serialisation at 16/24/32/48/64 bits: the bytes of
    `ops.packing.pack_floats`."""
    _check_bits(bits)
    flat = np.ascontiguousarray(values, dtype=np.float64).reshape(-1)
    out = np.empty(flat.size * (bits // 8), dtype=np.uint8)
    library().frad_pack_floats(flat.ctypes.data, flat.size, bits, int(little_endian),
                               out.ctypes.data, nthreads)
    return out.tobytes()


@_counted
def unpack_floats(frad: bytes, bits: int, little_endian: bool,
                  nthreads: int = 3) -> np.ndarray:
    """Inverse of `pack_floats` over the whole values of `frad` -> f64, with
    NaN and Inf scrubbed to 0."""
    _check_bits(bits)
    out = np.empty(len(frad) // (bits // 8), dtype=np.float64)
    library().frad_unpack_floats(frad, out.size, bits, int(little_endian),
                                 out.ctypes.data, nthreads)
    return out


@_counted
def pack_floats_maxabs(mat: np.ndarray, bits: int, little_endian: bool,
                       nthreads: int = 2) -> tuple[bytes, np.ndarray]:
    """`pack_floats` of an [rows, cols] f64 matrix fused with each row's
    max|x| (a NaN is skipped). Returns (packed bytes, maxabs [rows]); the
    caller re-packs when a row's max escalates past the container."""
    _check_bits(bits)
    mat = np.ascontiguousarray(mat, dtype=np.float64)
    rows, cols = mat.shape
    out = np.empty(rows * cols * (bits // 8), dtype=np.uint8)
    maxabs = np.empty(rows, dtype=np.float64)
    library().frad_pack_floats_maxabs(mat.ctypes.data, rows, cols, bits, int(little_endian),
                                      out.ctypes.data, maxabs.ctypes.data, nthreads)
    return out.tobytes(), maxabs


@_counted
def maxabs_rows(mat: np.ndarray, nthreads: int = 2) -> np.ndarray:
    """Per-row max|x| of an [rows, cols] f64 matrix (a NaN is skipped)."""
    mat = np.ascontiguousarray(mat, dtype=np.float64)
    rows, cols = mat.shape
    out = np.empty(rows, dtype=np.float64)
    library().frad_maxabs_rows(mat.ctypes.data, rows, cols, out.ctypes.data, nthreads)
    return out


@_counted
def p1_unpack_batch(payloads: list[bytes], fq_len: int, tq_len: int, lq_len: int = 0,
                    nthreads: int = 3
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray | None, np.ndarray]:
    """Inflate + EGR-decode + untrim a batch of Profile 1 payloads, or with
    `lq_len` of Profile 2 payloads, into f32.

    Returns (fq [B, fq_len], tq [B, tq_len], lq [B, lq_len] or None,
    ok [B] bool). A corrupt payload comes back as zero rows with ok False."""
    b = len(payloads)
    blob = b"".join(payloads)
    offsets = _offsets(payloads)
    fq = np.empty((b, fq_len), dtype=np.float32)
    tq = np.empty((b, tq_len), dtype=np.float32)
    lq = np.empty((b, lq_len), dtype=np.float32) if lq_len else None
    ok = np.empty(b, dtype=np.uint8)
    library().frad_p1_unpack_batch(blob, _i64p(offsets), b, fq_len, tq_len, lq_len,
                                   fq.ctypes.data, tq.ctypes.data,
                                   lq.ctypes.data if lq is not None else None,
                                   ok.ctypes.data, nthreads)
    return fq, tq, lq, ok.astype(bool)


@_counted
def p1_pack_batch(words: np.ndarray, nbits: np.ndarray, ks: np.ndarray,
                  skip: np.ndarray, tq: np.ndarray, nthreads: int = 3
                  ) -> list[bytes | None]:
    """Assemble and deflate a batch of Profile 1 payloads from EGR words.

    words [B, W] uint32 (big-endian stream order), nbits/ks [B], skip [B]
    bool (overflow frames the caller packs on the host), tq [B, T]
    threshold ints. Returns each frame's payload, None where skipped;
    the bytes equal `zlib.compress(frad, wbits=-15)` with the same zlib.
    """
    b, w = words.shape
    words = np.ascontiguousarray(words, dtype=np.uint32)
    nbits = np.ascontiguousarray(nbits, dtype=np.int64)
    ks = np.ascontiguousarray(ks, dtype=np.int64)
    skip_u8 = np.ascontiguousarray(skip, dtype=np.uint8)
    tq = np.ascontiguousarray(tq, dtype=np.int64).reshape(b, -1)
    t = tq.shape[1]
    frad_max = 4 + 17 * t + 16 + 1 + 4 * w
    cap = frad_max + frad_max // 1000 + 128   # > deflateBound for raw deflate
    out = np.empty(b * cap, dtype=np.uint8)
    out_len = np.zeros(b, dtype=np.int64)
    library().frad_p1_pack_batch(words.ctypes.data, _i64p(nbits), _i64p(ks),
                                 skip_u8.ctypes.data, b, w, _i64p(tq), t,
                                 out.ctypes.data, cap, _i64p(out_len), nthreads)
    return [out[i * cap: i * cap + out_len[i]].tobytes() if out_len[i] > 0 else None
            for i in range(b)]


@_counted
def frame_pack_batch(payloads: list[bytes] | tuple[bytes, np.ndarray], bdis: np.ndarray,
                     fsizes: np.ndarray, fsize_idx: np.ndarray | None, *, profile: int,
                     is_compact: bool, channels: int, srate: int, srate_idx: int = 0,
                     overlap_ratio: int = 0, little_endian: bool = False,
                     ecc: bool = False, ecc_dsize: int = 0, ecc_codesize: int = 0,
                     nthreads: int = 3) -> bytes:
    """RS armor + ASFH header + CRC for every frame of a batch, threaded,
    into one buffer: the bytes of the per-frame `ecc.encode` +
    `ASFH.write` chain. `payloads` is a list of per-frame payloads or an
    already joined (blob, offsets [B + 1]) pair."""
    if ecc and ecc_codesize > 0:
        from ..ops.rs import check_code_params

        check_code_params(ecc_dsize, ecc_codesize)
    if isinstance(payloads, tuple):
        blob, offsets = payloads
        offsets = np.ascontiguousarray(offsets, dtype=np.int64)
        if offsets[0] != 0 or offsets[-1] != len(blob) or (np.diff(offsets) < 0).any():
            raise ValueError("frame_pack_batch: offsets do not cut the blob")
        b = len(offsets) - 1
    else:
        b = len(payloads)
        blob = b"".join(payloads)
        offsets = _offsets(payloads)
    lens = np.diff(offsets)
    if ecc and ecc_codesize > 0:
        nfull = lens // ecc_dsize
        rem = lens - nfull * ecc_dsize
        alens = np.where(lens > 0, lens + (nfull + (rem > 0)) * ecc_codesize, 0)
    else:
        alens = lens
    hlen = (16 if ecc else 12) if is_compact else 32
    out_offsets = np.zeros(b + 1, dtype=np.int64)
    np.cumsum(hlen + np.where(alens >= 0xFFFFFFFF, 8, 0) + alens, out=out_offsets[1:])

    bdis = np.ascontiguousarray(bdis, dtype=np.uint8)
    fsizes = np.ascontiguousarray(fsizes, dtype=np.uint32)
    fsize_idx = np.ascontiguousarray(
        np.zeros(b) if fsize_idx is None else fsize_idx, dtype=np.uint8)
    out = np.empty(int(out_offsets[-1]), dtype=np.uint8)
    library().frad_frame_pack_batch(
        blob, _i64p(offsets), b, bdis.ctypes.data, fsizes.ctypes.data,
        fsize_idx.ctypes.data, profile, int(is_compact), channels, srate, srate_idx,
        overlap_ratio, int(little_endian), int(ecc), ecc_dsize, ecc_codesize,
        out.ctypes.data, _i64p(out_offsets), nthreads)
    return out.tobytes()


@_counted
def unarmor_batch(payloads: list[bytes], dsize: int, csize: int, crcs: np.ndarray,
                  crc_is16: bool, fix_error: bool, nthreads: int = 3
                  ) -> tuple[list[bytes], np.ndarray]:
    """Strip the parity of a batch of armored payloads, RS-repairing each
    frame whose CRC mismatches when `fix_error`. Returns (raw payloads,
    ok [B] bool)."""
    from ..ops.rs import check_code_params

    check_code_params(dsize, csize)
    b = len(payloads)
    blob = b"".join(payloads)
    offsets = _offsets(payloads)
    lens = np.diff(offsets)
    bs = dsize + csize
    nfull = lens // bs
    rem = lens - nfull * bs
    outlens = nfull * dsize + np.where(rem > 0, np.maximum(rem - csize, 0), 0)
    out_offsets = np.zeros(b + 1, dtype=np.int64)
    np.cumsum(outlens, out=out_offsets[1:])
    crcs = np.ascontiguousarray(crcs, dtype=np.uint32)
    out = np.empty(int(out_offsets[-1]), dtype=np.uint8)
    ok = np.empty(b, dtype=np.uint8)
    library().frad_unarmor_batch(blob, _i64p(offsets), b, dsize, csize, crcs.ctypes.data,
                                 int(crc_is16), int(fix_error), out.ctypes.data,
                                 _i64p(out_offsets), ok.ctypes.data, nthreads)
    raw = out.tobytes()
    return [raw[out_offsets[i]: out_offsets[i + 1]] for i in range(b)], ok.astype(bool)


@_counted
def frame_parse_batch(stream: bytes):
    """Whole-stream ASFH frame scan, the semantics of `ASFH.read` over
    the stream.

    Returns (count, pay_off, pay_len, is_ff, pfb, chans, srates, fsizes,
    olaps, eccds, ecccs, crcs, hdrlens, tail_pos): tail_pos is the byte
    offset of the unparsed tail, -1 when there is none. A compact header
    with a CSS sample-rate index outside the table is skipped: the scan
    resumes behind its frame sign, as the Python parser does.
    """
    n = len(stream)
    cap = max(min(stream.count(b"\xff\xd0\xd2\x98"), n // 12 + 1), 1)
    cols = [np.empty(cap, dtype=dt) for dt in (
        np.int64, np.int64, np.uint8, np.uint8, np.uint16, np.uint32, np.uint32,
        np.uint8, np.uint8, np.uint8, np.uint32, np.int32)]
    tail_pos = ctypes.c_int64(-1)
    cnt = library().frad_frame_parse_batch(stream, n, cap, *(c.ctypes.data for c in cols),
                                           ctypes.byref(tail_pos))
    return (int(cnt), *cols, int(tail_pos.value))
