"""`egr_pack` (CPU: its plain version) against the JAX package's device
packer (`bitpack.egr_pack_frames` with the compaction of
`pipeline._egr_compact_packer`) and against the host EGR coder
(`golomb.encode`): integer work, so every comparison is exact. Then
`batch_encode` through the kernel's wrapper: byte-identical to the host
coder's stream on the same symbols, and to the streams the tree gave
before the wrapper took the packer's place (digests of the frames'
headers and inflated payloads, so that no zlib version enters)."""

import hashlib
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frad_python_tpu.ops import bitpack as jbitpack
from frad_python_tpu.ops import golomb as jgolomb
from frad_python_tpu.parallel import pipeline as jpipeline
import frad_python_tpu_torch as ft
from frad_python_tpu_torch import kernels
from frad_python_tpu_torch.models import batch as tbatch
from frad_python_tpu_torch.ops import bitpack as tbitpack
from frad_python_tpu_torch.ops import golomb as tgolomb
from frad_python_tpu_torch.parallel import pipeline as tpipeline

CPU = torch.device("cpu")


def symbol_rows(b: int, m: int, seed: int) -> np.ndarray:
    """[b, m] int32 frames that walk the packer's edges: a row of zeros
    (k = 0, every code one bit, so every 32nd code ends on a word
    boundary), a row whose only non-zero symbol is 1 (dmax = 1), a row of
    wide symbols that overflows max_words in the middle of the batch, -2^23
    and 2^23 - 1, and Laplace rows of several scales."""
    rng = np.random.default_rng(seed)
    scale = np.exp(rng.standard_normal((b, 1)) * 1.5 + 1.0)
    s = np.rint(rng.laplace(0, 1, (b, m)) * scale).astype(np.int64)
    kinds = ["zeros", "one", "wide", "edge"]
    for i in range(b):
        kind = kinds[i] if i < len(kinds) and b > 1 else None
        if b == 1:
            kind = kinds[seed % 4]
        if kind == "zeros":
            s[i] = 0
        elif kind == "one":
            s[i] = 0
            s[i, m // 3] = 1
        elif kind == "wide":
            s[i] = rng.integers(-(1 << 22), 1 << 22, m)
        elif kind == "edge":
            s[i, 0], s[i, -1] = -(1 << 23), (1 << 23) - 1
    return s.astype(np.int32)


def jax_packed(sym: np.ndarray, max_words: int):
    """(flat, used, total_bits, k, overflow, words) of the JAX package's
    jitted packer and compaction."""
    b = sym.shape[0]
    pack = jpipeline._egr_compact_packer(max_words, b * max_words)
    meta, flat, words = pack(jnp.asarray(sym), jnp.zeros((b, 1), jnp.int32))
    meta = np.asarray(meta).astype(np.int64)
    nbits, ks, ovf = meta[:, 0], meta[:, 1], meta[:, 2]
    used = np.where(ovf != 0, 0, (nbits + 31) // 32)
    return np.asarray(flat)[: used.sum()], used, nbits, ks, ovf, np.asarray(words)


@pytest.mark.parametrize("m", [64, 4080, 4096])
@pytest.mark.parametrize("b", [1, 2, 5, 64])
def test_egr_pack_plain_equals_the_jax_packer_and_the_host_coder(b, m):
    sym = symbol_rows(b, m, 10 * b + m)
    max_words = max(m * 12 // 32, 16)
    flat, used, nbits, ks, ovf, words = (
        t.numpy() for t in kernels.egr_pack_plain(torch.from_numpy(sym), max_words, True))
    for t in (flat, used, nbits, ks, ovf, words):
        assert t.dtype == np.int32
    # the wrapper on a CPU tensor is the plain version
    for got, want in zip(kernels.egr_pack(torch.from_numpy(sym), max_words, True),
                         (flat, used, nbits, ks, ovf, words)):
        np.testing.assert_array_equal(got.numpy(), want)
    assert len(kernels.egr_pack(torch.from_numpy(sym), max_words)) == 5
    assert kernels.egr_pack.launches == 0

    jflat, jused, jnbits, jks, jovf, jwords = jax_packed(sym, max_words)
    np.testing.assert_array_equal(nbits, jnbits)
    np.testing.assert_array_equal(ks, jks)
    np.testing.assert_array_equal(ovf, jovf)
    np.testing.assert_array_equal(used, jused)
    np.testing.assert_array_equal(flat.view(np.uint32), jflat)
    keep = ovf == 0
    np.testing.assert_array_equal(words.view(np.uint32)[keep], jwords[keep])
    if b >= 3:
        assert ovf[2] == 1 and used[2] == 0 and not ovf[[0, 1]].any()
    assert len(flat) == used.sum()

    offs = np.cumsum(used) - used
    for i in range(b):
        if ovf[i]:
            continue
        row = flat.view(np.uint32)[offs[i]: offs[i] + used[i]]
        stream = tbitpack.words_to_stream(row, nbits[i], ks[i])
        assert stream == jgolomb.encode(sym[i].astype(np.int64))
        assert stream == tgolomb.encode(sym[i].astype(np.int64))
        assert stream == jbitpack.words_to_stream(jwords[i], jnbits[i], jks[i])
        # zero padding of the last partial word and of the row
        if nbits[i] % 32:
            assert int(row[-1]) & ((1 << (32 - int(nbits[i]) % 32)) - 1) == 0
        assert not words[i, used[i]:].any()


def test_codes_that_end_on_a_word_boundary():
    """Codes whose last bit is bit 31 of a word (end % 32 == 0) and codes
    that straddle two words, by construction: k = 3 (dmax 8), symbols 0
    code in 4 bits, symbol 8 in 6."""
    sym = np.zeros((2, 64), dtype=np.int32)
    sym[:, 0] = 8                           # sets k = 3; code 6 bits
    sym[0, 7] = -8                          # bits 30..35 straddle words 0 and 1
    sym[1, 1:8] = 0                         # 6 + 7 * 4 = 34: symbol 7 straddles
    flat, used, nbits, ks, ovf = (t.numpy() for t in kernels.egr_pack_plain(
        torch.from_numpy(sym), 16))
    assert ks.tolist() == [3, 3] and not ovf.any()
    offs = np.cumsum(used) - used
    for i in range(2):
        row = flat.view(np.uint32)[offs[i]: offs[i] + used[i]]
        assert tbitpack.words_to_stream(row, nbits[i], ks[i]) == jgolomb.encode(
            sym[i].astype(np.int64))
    # row of zeros: 64 one-bit codes end exactly on two word boundaries
    z = kernels.egr_pack_plain(torch.zeros((1, 64), dtype=torch.int32), 16)
    assert z[2].tolist() == [64] and z[1].tolist() == [2]
    assert z[0].view(torch.int32).tolist() == [-1, -1]


# ---------------------------------------------------------------------------
# batch_encode through the wrapper
# ---------------------------------------------------------------------------

#: (channels, srate, fsize, bits, seconds, ecc) and the digest of the
#: stream each gave before `egr_pack` took the packer's place (made with
#: `digest` on that tree)
PINNED = [
    ((2, 44100, 2048, 16, 0.5, False),
     "a3de3a6339d94ccff0117dac38864bb86a5b38ea59207d616e5959582e9e6e0d"),
    ((1, 48000, 512, 24, 0.2, True),
     "0adbde4f2e97cc4770ffe9100a14492a5fe15009d9406ebe337ea5eff847f35e"),
    ((3, 32000, 1024, 12, 0.3, False),
     "7c3f9ab73cccd29cd9ab58f1a9df3858e97fbefedc79ec6f2d382efe5ac93e41"),
]


def seeded_core(frames, srate, loss_level, factor):
    """Stand-in for `batch.p1_encode_core`: symbols from a seed instead of
    the float32 DCT chain, so that the stream's bytes depend on integer
    work alone, the same on every machine. Row 1 of a batch is wide enough
    to overflow max_words."""
    b, n, c = frames.shape
    rng = np.random.default_rng(b * 1000 + n + c)
    fq = np.rint(rng.laplace(0, 3, (b, n, c)) * np.exp(rng.standard_normal((b, 1, 1)))
                 ).astype(np.int32)
    if b > 2:
        fq[1] = rng.integers(-30000, 30000, (n, c))
    tq = rng.integers(0, 50, (b, 27, c)).astype(np.int32)
    return torch.from_numpy(fq), torch.from_numpy(tq)


def encode_seeded(monkeypatch, batch_mod, encode, cfg) -> bytes:
    ch, srate, fsize, bits, seconds, ecc = cfg
    monkeypatch.setattr(batch_mod, "p1_encode_core", seeded_core)
    monkeypatch.setattr(batch_mod, "p1_encode_core_i16", seeded_core)
    pcm = np.zeros((int(seconds * srate), ch))
    return encode(pcm, 1, srate, bits, fsize, enable_ecc=ecc, device="cpu")


def stream_digest(parse_frames, ecc_decode, stream: bytes) -> str:
    """sha256 over each frame's header fields and its payload with the
    armor stripped and DEFLATE undone (lengths and CRCs left out: they
    follow the deflated bytes)."""
    h = hashlib.sha256()
    headers, payloads, tail = parse_frames(stream)
    assert tail == b""
    for a, p in zip(headers, payloads):
        h.update(repr((a.profile, a.ecc, a.endian, a.bit_depth_index, a.channels, a.srate,
                       a.fsize, a.overlap_ratio, a.ecc_dsize, a.ecc_codesize,
                       p is None)).encode())
        if p is not None:
            if a.ecc:
                p = ecc_decode(p, a.ecc_dsize, a.ecc_codesize, False)
            h.update(zlib.decompress(p, wbits=-15))
    return h.hexdigest()


def digest(stream: bytes) -> str:
    from frad_python_tpu_torch.container import ecc as tecc
    return stream_digest(tpipeline._parse_frames, tecc.decode, stream)


@pytest.mark.parametrize("cfg,want_digest", PINNED)
def test_batch_encode_streams_unchanged(monkeypatch, cfg, want_digest):
    stream = encode_seeded(monkeypatch, tbatch, ft.batch_encode, cfg)
    assert digest(stream) == want_digest
    # and equal, payload for payload, to the host coder on the same symbols
    headers, payloads, _ = tpipeline._parse_frames(stream)
    ch, srate, fsize, bits, seconds, ecc = cfg
    n_frames = sum(p is not None for p in payloads)
    assert n_frames >= 3
    frames, _ = tpipeline.plan_frames(int(seconds * srate), fsize, 16, True)
    uniform = [f for f in frames if f[1] == frames[0][1]]
    fq, tq = seeded_core(np.zeros((len(uniform), fsize, ch)), srate, 0.5, 1.0)
    from frad_python_tpu_torch.container import ecc as tecc
    from frad_python_tpu_torch.models import profile1 as tprofile1
    for i in range(len(uniform)):
        want = tprofile1.pack_streams(fq[i].numpy().ravel(), tq[i].numpy().ravel())
        got = payloads[i]
        if ecc:
            got = tecc.decode(got, headers[i].ecc_dsize, headers[i].ecc_codesize, False)
        assert zlib.decompress(got, wbits=-15) == zlib.decompress(want, wbits=-15), i


def test_batch_encode_native_and_numpy_hosts_agree(monkeypatch):
    cfg = PINNED[0][0]
    a = encode_seeded(monkeypatch, tbatch, ft.batch_encode, cfg)
    monkeypatch.setenv("FRAD_TORCH_NO_NATIVE", "1")
    b = encode_seeded(monkeypatch, tbatch, ft.batch_encode, cfg)
    assert digest(a) == digest(b)
