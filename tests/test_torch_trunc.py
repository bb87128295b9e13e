"""The `trunc_pack` kernel's arithmetic (csrc/trunc_pack.cu), modelled in
numpy on the CPU: the launch geometry of `kernels/trunc_pack.geometry`,
which value goes to which thread and which of a group's bytes go into
which 32-bit word through `__byte_perm` with the selectors the kernel
source states. The model is held to `trunc_pack_plain` and to the JAX
package's `trunc_pack`, byte for byte, on NaN, +-Inf, the f16 overflow,
rounding ties, subnormals and signed zeros, at chip_smoke.py's
TRUNC_SHAPES (tails included) and at forms that take the kernel's
value-by-value path.

Tolerances: none. Payload bytes and max|x| are compared exactly, except
the bytes of a NaN at 16 bits, which are each converter's own NaN
(chip_smoke.py excludes the same words on the card); max|x| is NaN in
all three where a frame holds a NaN.
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

# the module: the package's `trunc_pack` name is the wrapper function
ktp = importlib.import_module("frad_python_tpu_torch.kernels.trunc_pack")
SOURCE = build.CSRC_DIR / "trunc_pack.cu"
#: chip_smoke.py's forms and three more: C = 1, and C * N not a multiple of
#: the group (the kernel's masked path; the last at 16 and 32 bits only)
SHAPES = chip_smoke.TRUNC_SHAPES[1:3] + ((3, 2, 64), (2, 1, 2048), (3, 3, 1004), (2, 1, 1001))
EXTRA_EDGES = [np.inf, -np.inf, 1 + 2.0 ** -11, 1 + 3 * 2.0 ** -11, -(1 + 2.0 ** -11),
               65519.0, 2.0 ** -25, 3 * 2.0 ** -26, np.float32(3.4e38)]


def selectors() -> dict:
    """{(bits, little): (s0, s1, s2)} as `selectors` in the kernel source
    returns them."""
    text = SOURCE.read_text()
    out = {}
    for bits, lit, big in re.findall(
            r"if \(bits == (\d+)\) return little \? Sel\{([^}]*)\} : Sel\{([^}]*)\};", text):
        out[(int(bits), True)] = tuple(int(v.strip().rstrip("u"), 16) for v in lit.split(","))
        out[(int(bits), False)] = tuple(int(v.strip().rstrip("u"), 16) for v in big.split(","))
    last = re.search(r"return little \? Sel\{([^}]*)\} : Sel\{([^}]*)\};\n\}", text)
    out[(32, True)] = tuple(int(v.strip().rstrip("u"), 16) for v in last.group(1).split(","))
    out[(32, False)] = tuple(int(v.strip().rstrip("u"), 16) for v in last.group(2).split(","))
    return out


def byte_perm(x: np.ndarray, y: np.ndarray, s: int) -> np.ndarray:
    """CUDA's __byte_perm(x, y, s) on uint32 arrays: byte i of the result
    is byte ((s >> 4i) & 7) of the eight bytes y:x (x's bytes 0-3)."""
    src = np.stack([(x >> (8 * i)) & 0xFF for i in range(4)]
                   + [(y >> (8 * i)) & 0xFF for i in range(4)]).astype(np.uint32)
    return sum(src[(s >> (4 * i)) & 7] << np.uint32(8 * i) for i in range(4)).astype(np.uint32)


def kernel_loads(y: np.ndarray, g: int) -> np.ndarray:
    """The 16 values thread-group g of a frame loads, [B, 16], as the
    kernel's paths read them: float4s of the channel rows at C = 1 and 2,
    value by value (0 past the row's end) otherwise."""
    b, c, n = y.shape
    m = g * ktp.GROUP
    if c * n % ktp.GROUP == 0 and c == 1:
        return y[:, 0, m:m + 16]
    if c * n % ktp.GROUP == 0 and c == 2:
        t0 = m >> 1
        a, bb = y[:, 0, t0:t0 + 8], y[:, 1, t0:t0 + 8]
        return np.stack([a, bb], axis=-1).reshape(b, 16)
    v = np.zeros((b, 16), np.float32)
    t, ch = m // c, m % c
    for k in range(16):
        if m + k < c * n:
            v[:, k] = y[:, ch, t]
        ch += 1
        if ch == c:
            ch, t = 0, t + 1
    return v


def model(y: np.ndarray, bits: int, little: bool) -> tuple[bytes, np.ndarray]:
    """(payload bytes of every frame, maxabs) as the kernel makes them."""
    b, c, n = y.shape
    m_total = c * n
    s0, s1, s2 = selectors()[(bits, little)]
    bpv = bits // 8
    frames = [bytearray() for _ in range(b)]
    mx = np.zeros(b, np.uint32)
    for g in range(-(-m_total // ktp.GROUP)):
        v = kernel_loads(y, g)
        u = v.view(np.uint32)
        mx = np.maximum(mx, (u & np.uint32(0x7FFFFFFF)).max(axis=1))
        if bits == 16:
            with np.errstate(over="ignore"):            # values past the f16 range
                h = v.astype(np.float16).view(np.uint16).astype(np.uint32)
            w = [byte_perm(h[:, 2 * k], h[:, 2 * k + 1], s0) for k in range(8)]
        elif bits == 24:
            w = []
            for q in range(4):
                w += [byte_perm(u[:, 4 * q], u[:, 4 * q + 1], s0),
                      byte_perm(u[:, 4 * q + 1], u[:, 4 * q + 2], s1),
                      byte_perm(u[:, 4 * q + 2], u[:, 4 * q + 3], s2)]
        else:
            w = [byte_perm(u[:, k], np.zeros_like(u[:, k]), s0) for k in range(16)]
        words = np.stack(w, axis=1).astype("<u4")
        nbytes = min(ktp.GROUP, m_total - g * ktp.GROUP) * bpv
        for i in range(b):
            frames[i] += words[i].tobytes()[:nbytes]
    return b"".join(bytes(f) for f in frames), mx.view(np.float32)


def inputs(shape, seed: int) -> np.ndarray:
    y = chip_smoke.trunc_inputs(shape, seed)
    n_extra = min(len(EXTRA_EDGES), y.shape[2] - 10)
    y[0, -1, 10:10 + n_extra] = EXTRA_EDGES[:n_extra]
    return y


def nan_bytes(y: np.ndarray, bits: int) -> np.ndarray:
    """Payload byte positions of the NaNs of y, at 16 bits (their bits are
    each converter's own); nothing at 24 and 32 bits."""
    b = y.shape[0]
    flat = np.isnan(y.transpose(0, 2, 1).reshape(b, -1))
    if bits != 16:
        return np.zeros(flat.size * bits // 8, bool)
    return np.repeat(flat.reshape(-1), 2)


@pytest.mark.parametrize("shape,bits", [(s, bits) for s in SHAPES for bits in (16, 24, 32)
                                         if bits != 24 or s[1] * s[2] % 4 == 0], ids=str)
def test_word_model_equals_plain_and_jax(shape, bits):
    b, c, n = shape
    y = inputs(shape, 7 + b * c + n)
    keep = ~nan_bytes(y, bits)
    flat = y.transpose(0, 2, 1).reshape(b, -1)
    for little in (False, True):
        got, mx = model(y, bits, little)
        words, maxabs = ktp.trunc_pack_plain(torch.from_numpy(y), bits, little)
        want = words.numpy().astype(words.numpy().dtype.newbyteorder("<")).tobytes()
        jax_words = np.asarray(jbitpack.trunc_pack(jnp.asarray(flat), bits, little))
        jax_bytes = jax_words.astype(jax_words.dtype.newbyteorder("<")).tobytes()
        assert len(got) == len(want) == len(jax_bytes) == b * c * n * bits // 8
        g, w, j = (np.frombuffer(x, np.uint8) for x in (got, want, jax_bytes))
        np.testing.assert_array_equal(g[keep], w[keep])
        np.testing.assert_array_equal(g[keep], j[keep])
        np.testing.assert_array_equal(mx, maxabs.numpy())      # NaN where planted
        assert np.isnan(mx[-1]) == (b > 1)


def test_selectors_are_one_byte_permute_apart():
    """Both byte orders take the same value pairs; a selector of one order
    is the other's with each value's bytes reversed."""
    sel = selectors()
    assert set(sel) == {(b, o) for b in (16, 24, 32) for o in (False, True)}
    x = np.array([0x44332211], np.uint32)
    y = np.array([0x88776655], np.uint32)
    assert byte_perm(x, y, sel[(32, True)][0])[0] == 0x44332211
    assert byte_perm(x, y, sel[(32, False)][0])[0] == 0x11223344
    assert byte_perm(x, y, sel[(16, True)][0])[0] == 0x66552211
    assert byte_perm(x, y, sel[(16, False)][0])[0] == 0x55661122
    # 24 bits, little-endian: [x1 x2 x3 y1], big-endian: [x3 x2 x1 y3]
    assert byte_perm(x, y, sel[(24, True)][0])[0] == 0x66443322
    assert byte_perm(x, y, sel[(24, False)][0])[0] == 0x88223344


@pytest.mark.parametrize("shape", chip_smoke.TRUNC_SHAPES + SHAPES[2:], ids=str)
def test_geometry_tiles_every_form(shape):
    """Every group of a frame goes to exactly one thread of its cluster, in
    one round at every form the codec launches, in whole warps, with no
    block of a cluster left without a group."""
    _, c, n = shape
    blocks, threads = ktp.geometry(c, n)
    groups = -(-c * n // ktp.GROUP)
    assert 1 <= blocks <= ktp.MAX_CLUSTER and threads % 32 == 0 and 32 <= threads <= 1024
    assert (blocks - 1) * threads < groups <= blocks * threads
    owner = np.full(groups, -1)
    for rank in range(blocks):
        for tid in range(threads):
            for g in range(rank * threads + tid, groups, blocks * threads):
                assert owner[g] == -1
                owner[g] = rank * threads + tid
    assert (owner >= 0).all()
    if shape in chip_smoke.TRUNC_SHAPES:
        assert (owner == np.arange(groups)).all()          # one group a thread
