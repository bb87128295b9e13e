"""The `trunc_unpack` kernel's arithmetic (csrc/trunc_unpack.cu), modelled in
numpy on the CPU: the launch geometry of `kernels/trunc_unpack.geometry`
(which bins of which frame each thread writes, and whether its loads and
stores stay in their row, on their pieces' boundaries), and how each value's
float bits come out of the payload words through `__byte_perm` with the
selectors the kernel source states, on the kernel's group path (C = 1, 2
and 8) and its run-time channel path (any other C). The model is held to
`trunc_unpack_plain` and to the JAX package's `trunc_unpack`, bit for bit
(compared as int32 patterns, so that -0.0 is not +0.0), on random payload
words with NaN, Inf, signed-zero and subnormal patterns at every depth
(`chip_smoke.trunc_random_words`) and on words packed from the
truncation edges, at 16/24/32 bits and both byte orders.

Tolerances: none.
"""

import importlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from frad_python_tpu.ops import bitpack as jbitpack
from frad_python_tpu_torch.kernels import build

# the module: the package's `trunc_unpack` name is the wrapper function
ktu = importlib.import_module("frad_python_tpu_torch.kernels.trunc_unpack")
ktp = importlib.import_module("frad_python_tpu_torch.kernels.trunc_pack")
SOURCE = build.CSRC_DIR / "trunc_unpack.cu"
#: every form chip_smoke.py launches the kernel at, and more: C = 8 in whole
#: groups, C = 2 and 5 with N not a multiple of the group's bins, a tiny row
GEOMETRY_FORMS = chip_smoke.TRUNC_SHAPES + chip_smoke.TRUNC_ODD_SHAPES + (
    (3, 8, 64), (2, 2, 1002), (2, 5, 36), (1, 1, 4))
#: small forms that reach each path of the kernel: whole groups at C = 1,
#: 2 (the 2040-sample tail among them) and 8, rows of N not whole groups at
#: C = 1, 2 and 8, the run-time path at C = 3 and 5
SHAPES = chip_smoke.TRUNC_SHAPES[1:3] + ((2, 1, 2048), (2, 8, 96), (2, 2, 1002), (3, 3, 1004),
                                         (2, 1, 1001), (2, 8, 1001), (2, 5, 36))
EXTRA_EDGES = [np.inf, -np.inf, 1 + 2.0 ** -11, -(1 + 2.0 ** -11), 65519.0, 2.0 ** -25,
               3 * 2.0 ** -26, np.float32(3.4e38), -1e-40, -0.0]


def forms(shapes):
    return [(s, bits) for s in shapes for bits in (16, 24, 32) if bits != 24 or s[1] * s[2] % 4 == 0]


def selectors() -> dict:
    """{(bits, little): (s0, s1, s2, s3)} as `selectors` in the kernel
    source returns them."""
    text = SOURCE.read_text()

    def parse(sel: str) -> tuple:
        return tuple(int(v.strip().rstrip("u"), 16) for v in sel.split(","))

    out = {}
    for bits, lit, big in re.findall(
            r"if \(bits == (\d+)\) return little \? Sel\{([^}]*)\} : Sel\{([^}]*)\};", text):
        out[(int(bits), True)], out[(int(bits), False)] = parse(lit), parse(big)
    last = re.search(r"return little \? Sel\{([^}]*)\} : Sel\{([^}]*)\};\n\}", text)
    out[(32, True)], out[(32, False)] = parse(last.group(1)), parse(last.group(2))
    return out


def source_bins(c: int) -> int:
    """`group_bins` of the kernel source, for the channel count the kernel
    dispatches c to (its own path at 1, 2 and 8, else the run-time one)."""
    line = re.search(r"constexpr int group_bins\(int cc\) \{ return ([^;]*); \}",
                     SOURCE.read_text()).group(1)
    own = {int(k): int(v) for k, v in re.findall(r"cc == (\d+) \? (\d+)", line)}
    return own.get(c if c in (1, 2, 8) else 0, int(line.rsplit(":", 1)[1]))


def piece_width(nbytes: int) -> int:
    """csrc/vec_io.cuh's piece_width: the widest access that divides a run."""
    return next(w for w in (16, 8, 4, 2) if nbytes % w == 0)


def byte_perm(x: np.ndarray, y: np.ndarray, s: int) -> np.ndarray:
    """CUDA's __byte_perm(x, y, s) on uint32 arrays: byte i of the result
    is byte ((s >> 4i) & 7) of the eight bytes y:x (x's bytes 0-3)."""
    src = np.stack([(x >> (8 * i)) & 0xFF for i in range(4)]
                   + [(y >> (8 * i)) & 0xFF for i in range(4)]).astype(np.uint32)
    return sum(src[(s >> (4 * i)) & 7] << np.uint32(8 * i) for i in range(4)).astype(np.uint32)


def value(bits: int, a: np.ndarray, b: np.ndarray, s) -> np.ndarray:
    """The kernel's `value`: the float32 of payload word a (and b), NaN
    and Inf scrubbed to +0.0. `s` is a selector or an array of them."""
    s = np.broadcast_to(np.asarray(s, np.uint32), a.shape)
    out = np.zeros(a.shape, np.uint32)
    for sel in np.unique(s):
        at = s == sel
        out[at] = byte_perm(a[at], b[at] if bits == 24 else np.zeros_like(a[at]), int(sel))
    if bits == 16:
        x = (out & 0xFFFF).astype(np.uint16).view(np.float16).astype(np.float32)
    elif bits == 24:
        x = (out & np.uint32(0xFFFFFF00)).view(np.float32)
    else:
        x = out.view(np.float32)
    return np.where(np.isfinite(x), x, np.float32(0.0))


def model(words: np.ndarray, bits: int, little: bool, n: int, c: int) -> np.ndarray:
    """float32 [B, c, n] as the kernel makes it from payload words [B, W]."""
    b = words.shape[0]
    sel = selectors()[(bits, little)]
    raw = np.ascontiguousarray(words).view(np.uint8).reshape(b, -1)   # the payload's bytes
    bpv = bits // 8
    if c in (1, 2, 8):
        # a thread's group: G bins of every channel, its words (zero past the
        # row's end, as the element-wise loads), its values in payload order
        g = ktu.bins(c)
        groups = -(-n // g)
        padded = np.zeros((b, groups * g * c * bpv), np.uint8)
        padded[:, :raw.shape[1]] = raw
        w = padded.view("<u4").reshape(b, groups, -1)
        if bits == 16:
            v = np.stack([value(16, w, w, sel[0]), value(16, w, w, sel[1])], axis=-1)
        elif bits == 24:
            q = w.reshape(b, groups, -1, 3)
            z = np.zeros_like(q[..., 0])
            v = np.stack([value(24, q[..., 0], q[..., 1], sel[0]),
                          value(24, q[..., 0], q[..., 1], sel[1]),
                          value(24, q[..., 1], q[..., 2], sel[2]),
                          value(24, q[..., 2], z, sel[3])], axis=-1)
        else:
            v = value(32, w, w, sel[0])
        v = v.reshape(b, groups * g, c)[:, :n]
        return np.ascontiguousarray(v.transpose(0, 2, 1))
    # the run-time path: value m = t*c + ch, element by element
    m = np.arange(c * n)
    if bits == 16:
        e = raw.view("<u2").astype(np.uint32)
        v = value(16, e, e, sel[0])
    elif bits == 32:
        e = raw.view("<u4")
        v = value(32, e, e, sel[0])
    else:
        e = np.concatenate([raw.view("<u4"), np.zeros((b, 1), np.uint32)], axis=1)
        r = m & 3
        j = 3 * (m >> 2) + ((3 * r) >> 2)
        second = np.where(r == 3, e.shape[1] - 1, j + 1)           # the zero word at r == 3
        v = value(24, e[:, j], e[:, second], np.array(sel)[r])
    return np.ascontiguousarray(v.reshape(b, n, c).transpose(0, 2, 1))


def jax_unpack(words: np.ndarray, bits: int, little: bool, n: int, c: int) -> np.ndarray:
    """The JAX package's trunc_unpack on the same words (its own unsigned
    word type), in the kernel's [B, C, N] layout."""
    jw = jnp.asarray(words.view(np.uint16 if bits == 16 else np.uint32))
    flat = np.asarray(jbitpack.trunc_unpack(jw, bits, little))
    return np.ascontiguousarray(flat.reshape(words.shape[0], n, c).transpose(0, 2, 1))


def plain(words: np.ndarray, bits: int, little: bool, n: int, c: int) -> np.ndarray:
    return ktu.trunc_unpack_plain(torch.from_numpy(words), bits, little, n, c).numpy()


def assert_bits_equal(a: np.ndarray, b: np.ndarray) -> None:
    assert a.shape == b.shape and a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def packed_edges(shape, bits: int, little: bool) -> np.ndarray:
    """trunc_pack_plain's words of chip_smoke's truncation edges (and a
    NaN) with EXTRA_EDGES in the last channel of frame 0."""
    y = chip_smoke.trunc_inputs(shape, 5 + shape[2])
    k = min(len(EXTRA_EDGES), y.shape[2] - 10)
    y[0, -1, 10:10 + k] = EXTRA_EDGES[:k]
    words, _ = ktp.trunc_pack_plain(torch.from_numpy(y), bits, little)
    return words.numpy()


@pytest.mark.parametrize("shape,bits", forms(SHAPES), ids=str)
def test_value_model_equals_plain_and_jax(shape, bits):
    """The kernel's assembly, on random words and on packed edges, gives the
    plain version's and the JAX package's float bits at both byte orders."""
    b, c, n = shape
    for little in (False, True):
        for words in (chip_smoke.trunc_random_words(shape, bits, little, 3 + n),
                      packed_edges(shape, bits, little)):
            got = model(words, bits, little, n, c)
            assert_bits_equal(got, plain(words, bits, little, n, c))
            assert_bits_equal(got, jax_unpack(words, bits, little, n, c))


@pytest.mark.parametrize("little", [False, True])
@pytest.mark.parametrize("bits", [16, 24, 32])
@pytest.mark.parametrize("shape", [(3, 2, 512), (2, 8, 64), (2, 3, 100)], ids=str)
def test_random_words_plain_equals_jax(shape, bits, little):
    """trunc_unpack_plain against the JAX package's trunc_unpack on random
    payload words, bit for bit: every class of pattern, both orders."""
    b, c, n = shape
    words = chip_smoke.trunc_random_words(shape, bits, little, 11 * bits + little)
    assert_bits_equal(plain(words, bits, little, n, c), jax_unpack(words, bits, little, n, c))


@pytest.mark.parametrize("bits", [16, 24, 32])
def test_random_words_reach_every_class(bits):
    """chip_smoke's random words hold, at each depth and byte order, values
    that are NaN or Inf (scrubbed to +0.0), -0.0, subnormals and plain
    finite values, in the dtype and shape the wrapper takes."""
    shape = (2, 2, 512)
    for little in (False, True):
        words = chip_smoke.trunc_random_words(shape, bits, little, 1)
        assert words.dtype == (np.int16 if bits == 16 else np.int32)
        assert words.shape == (2, 2 * 512 * bits // 8 // words.itemsize)
        raw = words.view(np.uint8).reshape(2, -1, bits // 8)
        raw = raw[..., ::-1] if little else raw                   # most significant first
        top = np.zeros(raw.shape[:2], np.uint64)
        for i in range(bits // 8):
            top = (top << np.uint64(8)) | raw[..., i].astype(np.uint64)
        ebits, mbits = (5, 10) if bits == 16 else (8, bits - 9)
        expo = (top >> np.uint64(mbits)) & np.uint64((1 << ebits) - 1)
        mant = top & np.uint64((1 << mbits) - 1)
        sign = top >> np.uint64(bits - 1)
        full = expo == (1 << ebits) - 1
        assert (full & (mant == 0)).sum() > 0 and (full & (mant != 0)).sum() > 0   # Inf, NaN
        assert ((expo == 0) & (mant == 0) & (sign == 1)).sum() > 0                   # -0.0
        assert ((expo == 0) & (mant != 0)).sum() > 0                                 # subnormals
        out = plain(words, bits, little, 512, 2)
        assert (np.signbit(out) & (out == 0)).any() and (out != 0).any()


@pytest.mark.parametrize("shape", GEOMETRY_FORMS, ids=str)
def test_geometry_writes_every_bin_once(shape):
    """Each (b, c, t) is written by exactly one thread of the grid (frame,
    chunk) that geometry picks, in whole warps of at most BLOCK threads,
    with fewer than a warp of idle threads a chunk; on the vector path
    every group's loads and every channel's stores lie in their row, in
    pieces of 4 to 16 bytes on their own boundaries."""
    b, c, n = shape
    g = ktu.bins(c)
    assert g == source_bins(c)
    chunks, threads = ktu.geometry(c, n)
    assert threads % 32 == 0 and 32 <= threads <= ktu.BLOCK and 1 <= chunks <= 65535
    assert chunks * threads * g >= n                 # the C entry's own check
    t0 = (np.arange(chunks)[:, None] * threads + np.arange(threads)[None, :]).ravel() * g
    assert (t0 < n).sum() == -(-n // g)              # one group a thread
    assert chunks * threads - (t0 < n).sum() < 32 * chunks
    t0 = t0[t0 < n]
    t = (t0[:, None] + np.arange(g)[None, :]).ravel()
    t = t[t < n]                                     # the element-wise stores' mask
    hits = np.bincount((np.arange(c)[:, None] * n + t[None, :]).ravel(), minlength=c * n)
    np.testing.assert_array_equal(hits, np.ones(c * n, np.int64))   # every frame alike
    if n % g:
        return                                       # element-wise stores, no vector path
    store = piece_width(g * 4)                       # each channel's bins, in whole pieces
    assert store >= 8 and (n * 4) % store == 0
    for bits in (16, 24, 32):
        if bits == 24 and c * n % 4 or c not in (1, 2, 8):
            continue                                 # value-by-value loads
        bpv = bits // 8
        load = piece_width(g * c * bpv)
        first = t0 * c * bpv
        assert load >= 4 and (first % load == 0).all() and (c * n * bpv) % load == 0
        assert (first + g * c * bpv <= c * n * bpv).all()


def test_trunc_smoke_shapes_take_the_vector_path():
    """The codec's forms (chip_smoke.TRUNC_SHAPES: the 2040- and
    1536-sample tails too) are whole groups, and chip_smoke's odd forms
    reach the element-wise path at C = 1 and 8 and the run-time path."""
    for _, c, n in chip_smoke.TRUNC_SHAPES:
        assert c in (1, 2, 8) and n % ktu.bins(c) == 0
    odd = {(c, n % ktu.bins(c) == 0) for _, c, n in chip_smoke.TRUNC_ODD_SHAPES}
    assert {(1, False), (8, False)} <= odd and any(c not in (1, 2, 8) for c, _ in odd)


def test_selectors_take_each_value_from_its_bytes():
    """Each selector puts a value's bytes where its float's bits go: the
    payload's first byte is the most significant one unless little; a
    24-bit value's low byte is cleared after the permute."""
    sel = selectors()
    assert set(sel) == {(b, o) for b in (16, 24, 32) for o in (False, True)}
    x = np.array([0x44332211], np.uint32)
    y = np.array([0x88776655], np.uint32)
    z = np.zeros(1, np.uint32)
    assert byte_perm(x, z, sel[(32, True)][0])[0] == 0x44332211
    assert byte_perm(x, z, sel[(32, False)][0])[0] == 0x11223344
    assert byte_perm(x, z, sel[(16, True)][0])[0] == 0x2211
    assert byte_perm(x, z, sel[(16, True)][1])[0] == 0x4433
    assert byte_perm(x, z, sel[(16, False)][0])[0] == 0x1122
    assert byte_perm(x, z, sel[(16, False)][1])[0] == 0x3344
    # 24 bits: value r starts at byte (0, 3, 2, 1)[r] of the words a:b that
    # the kernel hands it (b = 0 at r = 3)
    want = {0: (0x33221100, 0x11223300), 1: (0x66554400, 0x44556600),
            2: (0x55443300, 0x33445500), 3: (0x44332200, 0x22334400)}
    for r, (le, be) in want.items():
        b = z if r == 3 else y
        assert byte_perm(x, b, sel[(24, True)][r])[0] & 0xFFFFFF00 == le
        assert byte_perm(x, b, sel[(24, False)][r])[0] & 0xFFFFFF00 == be
