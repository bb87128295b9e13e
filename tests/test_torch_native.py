"""The port's C++ host module against the JAX package's native module and
against the port's own numpy paths (FRAD_TORCH_NO_NATIVE=1), on the same
inputs. This is the host byte domain: every comparison is exact. Also
the build and load contract: cached builds, concurrent builds, and a
failed build or a missing symbol raising instead of falling back.

The tests need g++ and skip only where there is none.
"""

import ctypes
import os
import shutil
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from frad_python_tpu import native as jnative
from frad_python_tpu_torch import common as tcommon
from frad_python_tpu_torch import native as tnative
from frad_python_tpu_torch.container import asfh as tasfh
from frad_python_tpu_torch.container import ecc as tecc
from frad_python_tpu_torch.models import profile1 as tprofile1
from frad_python_tpu_torch.native import build as tbuild
from frad_python_tpu_torch.ops import bitpack as tbitpack
from frad_python_tpu_torch.ops import golomb as tgolomb
from frad_python_tpu_torch.ops import rs as trs
from frad_python_tpu_torch.parallel import pipeline as tpipeline


@pytest.fixture(autouse=True)
def _gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the native host module cannot be built")
    if not jnative.available():
        jnative.reload()     # another test process may have been building it at start-up
    assert jnative.available(), "the JAX package's native module is not built"


@pytest.fixture
def numpy_path(monkeypatch):
    """Select the port's numpy host paths for the body of a `with`."""
    class _Path:
        def __enter__(self):
            monkeypatch.setenv("FRAD_TORCH_NO_NATIVE", "1")

        def __exit__(self, *exc):
            monkeypatch.delenv("FRAD_TORCH_NO_NATIVE")
    return _Path()


def _bytes(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("n", [0, 1, 7, 255, 4096])
def test_crc16(numpy_path, n):
    data = _bytes(n, n)
    got = tcommon.crc16_ansi(data)
    with numpy_path:
        assert tcommon.crc16_ansi(data) == got
    assert tnative.crc16_ansi(data) == jnative.crc16_ansi(data) == got


def _symbols(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "zeros":
        return np.zeros(500, dtype=np.int64)
    if kind == "small":
        return rng.integers(-3, 4, 4096)
    if kind == "laplace":
        return np.rint(rng.laplace(0, 20, 4096)).astype(np.int64)
    if kind == "pow2":
        return np.array([0, 8, -8, 1, -1, 1024], dtype=np.int64)
    return rng.integers(-(1 << 20), 1 << 20, 777)           # wide


@pytest.mark.parametrize("kind", ["zeros", "small", "laplace", "pow2", "wide"])
def test_egr_encode_decode(numpy_path, kind):
    data = _symbols(kind, 3)
    enc = tnative.egr_encode(data)
    assert enc == jnative.egr_encode(data) == tgolomb.encode(data)
    with numpy_path:
        assert tgolomb.encode(data) == enc
        np.testing.assert_array_equal(tgolomb.decode(enc), data)
    np.testing.assert_array_equal(tnative.egr_decode(enc), jnative.egr_decode(enc))
    np.testing.assert_array_equal(tnative.egr_decode(enc), data)
    # a truncated stream decodes as far as it goes, the same on all paths
    cut = enc[: len(enc) // 2]
    want = jnative.egr_decode(cut)
    np.testing.assert_array_equal(tgolomb.decode(cut), want)
    with numpy_path:
        np.testing.assert_array_equal(tgolomb.decode(cut), want)


@pytest.mark.parametrize("dsize,nsym", [
    (96, 1), (96, 5), (96, 7), (96, 8), (96, 15), (96, 32), (48, 12), (96, 24),
    (200, 55),                      # the longest GF(256) codeword (255)
])
def test_rs_blocks(numpy_path, dsize, nsym):
    rng = np.random.default_rng(dsize * 256 + nsym)
    data = rng.integers(0, 256, size=(8, dsize), dtype=np.uint8)
    par = tnative.rs_encode_blocks(data, nsym)
    np.testing.assert_array_equal(par, jnative.rs_encode_blocks(data, nsym))
    np.testing.assert_array_equal(trs.encode_blocks(data, nsym), par)
    with numpy_path:
        np.testing.assert_array_equal(trs.encode_blocks(data, nsym), par)

    cw = np.concatenate([data, par], axis=1)
    cw[3, dsize // 2] ^= 0xC3                   # one error: correctable
    cw[5, : nsym + 1] ^= 0x5A                   # nsym + 1 errors: not
    fixed, ok = tnative.rs_decode_blocks(cw, nsym)
    jfixed, jok = jnative.rs_decode_blocks(cw, nsym)
    np.testing.assert_array_equal(fixed, jfixed)
    np.testing.assert_array_equal(ok, jok)
    with numpy_path:
        nfixed, nok = trs.decode_blocks(cw, nsym)
    np.testing.assert_array_equal(nfixed, fixed)
    np.testing.assert_array_equal(nok, ok)
    if nsym >= 2:
        np.testing.assert_array_equal(fixed[3], data[3])
        assert ok[3] and not ok[5] and not fixed[5].any()


def test_rs_rejects_codewords_beyond_gf256(numpy_path):
    data = np.zeros((2, 300), dtype=np.uint8)
    for fn in (tnative.rs_encode_blocks, trs.encode_blocks):
        with pytest.raises(ValueError, match="GF\\(256\\)"):
            fn(data, 24)
    with pytest.raises(ValueError, match="GF\\(256\\)"):
        tnative.frame_pack_batch([b"x"], np.zeros(1), np.ones(1), None, profile=1,
                                 is_compact=True, channels=1, srate=44100,
                                 ecc=True, ecc_dsize=240, ecc_codesize=24)
    with numpy_path:
        with pytest.raises(ValueError, match="GF\\(256\\)"):
            trs.encode_blocks(data, 24)


def test_i16_casts(numpy_path):
    rng = np.random.default_rng(4)
    pcm = np.concatenate([rng.standard_normal(5000) * 0.5,
                          [1.0, -1.0, 2.0, -2.0, 0.5 / 32768, 1.5 / 32768, -2.5 / 32768, 0.0]])
    pcm = pcm.reshape(-1, 2)
    # the port's int16 upload cast runs inside the staging pass: one frame
    # of the whole clip
    got = tnative.stage_frames(pcm, [0], len(pcm), np.empty((1,) + pcm.shape, np.int16))[0]
    np.testing.assert_array_equal(got, jnative.f64_to_i16(pcm))
    np.testing.assert_array_equal(got, tpipeline._to_i16(pcm))
    with numpy_path:
        np.testing.assert_array_equal(tpipeline._to_i16(pcm), got)
    back = tnative.i16_to_f64(got)
    np.testing.assert_array_equal(back, jnative.i16_to_f64(got).reshape(got.shape))
    np.testing.assert_array_equal(back, got.astype(np.float64) / 32768.0)


def _stage_case(name):
    """(track, starts, flen, dlen, frames from `plan_frames`) of a staging case."""
    rng = np.random.default_rng(len(name))

    def planned(total, channels, uniform=True, fsize=2048):
        track = rng.standard_normal((total, channels)) * 0.4
        track[::97] *= 4.0                                  # some values past the int16 clamp
        frs, _ = tpipeline.plan_frames(total, fsize, 16, True)
        frs = [f for f in frs if (f[1] == frs[0][1]) == uniform]
        flen = frs[0][1]
        dlen = tprofile1.frame_params(flen, 44100, 0.5)[0]
        return track, [s for s, _ in frs], flen, dlen, frs

    if name == "hop_c1_b1":
        return planned(2048 + 1000, 1)
    if name == "hop_c2_b2":
        return planned(2048 + 1920 + 500, 2)
    if name == "hop_c2_b300":
        return planned(2048 + 299 * 1920 + 700, 2)
    if name == "hop_c8_b40":
        return planned(2048 + 39 * 1920 + 30, 8)
    if name == "tail":                                      # the overlap and the rest: dlen > flen
        return planned(2048 + 9 * 1920 + 700, 2, uniform=False)
    if name == "short_track":                               # one frame shorter than the frame size
        return planned(1000, 2)
    if name == "flen_1900_dlen_2048":                       # a frame off the compact grid
        track, starts, _, _, _ = planned(2048 + 20 * 1920, 2)
        return track, starts, 1900, 2048, None
    # irregular starts: before the track, past its end, repeated, descending
    track = rng.standard_normal((9000, 2)) * 0.4
    starts = [0, -700, 8500, 9000, 12000, -5000, 4321, 4321, 17, 3000, 1, 6999]
    return track, starts, 2048, 2304, None


STAGE_CASES = ["hop_c1_b1", "hop_c2_b2", "hop_c2_b300", "hop_c8_b40", "tail", "short_track",
               "flen_1900_dlen_2048", "irregular"]


def _cast(arr, dtype):
    """The pipeline's numpy cast of float64 frames to an upload dtype."""
    if dtype == np.int16:
        return np.clip(np.rint(arr * 32768.0), -32768, 32767).astype(np.int16)
    return arr.astype(dtype)


@pytest.mark.parametrize("nthreads", [1, 3, None])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int16])
@pytest.mark.parametrize("case", STAGE_CASES)
def test_stage_frames_equal_gather_and_cast(case, dtype, nthreads):
    """The native staging pass equals, element for element, the frames
    zero-filled outside the track and from flen on, then cast; for frames
    of the pipeline's plan that is `_gather`, its zero pad and today's
    cast (`_to_i16` for int16)."""
    track, starts, flen, dlen, frs = _stage_case(case)
    want = np.zeros((len(starts), dlen, track.shape[1]))
    for i, s in enumerate(starts):
        a, b = max(s, 0), min(s + flen, len(track))
        if b > a:
            want[i, a - s:b - s] = track[a:b]
    if frs is not None:
        gathered = tpipeline._gather(track, frs, flen)
        np.testing.assert_array_equal(want[:, :flen], gathered)
        assert not want[:, flen:].any()
        if dtype == np.int16:
            np.testing.assert_array_equal(_cast(want, dtype), tpipeline._to_i16(want))
    out = np.full((len(starts), dlen, track.shape[1]), 7, dtype=dtype)
    calls = tnative.stage_frames.calls
    got = tnative.stage_frames(track, starts, flen, out, nthreads=nthreads)
    assert got is out and tnative.stage_frames.calls == calls + 1
    np.testing.assert_array_equal(out, _cast(want, dtype))


def test_stage_frames_writes_into_a_slice_and_checks_its_output():
    track, starts, flen, dlen, _ = _stage_case("hop_c2_b2")
    buf = np.full((3, dlen, 2), 5.0, dtype=np.float32)
    tnative.stage_frames(track, starts, flen, buf[:2])
    assert (buf[2] == 5.0).all()
    np.testing.assert_array_equal(buf[:2, :flen], tpipeline._gather(
        track, [(s, flen) for s in starts], flen).astype(np.float32))
    with pytest.raises(ValueError, match="float32, float64 or int16"):
        tnative.stage_frames(track, starts, flen, np.empty((2, dlen, 2), np.int32))
    with pytest.raises(ValueError, match="float32, float64 or int16"):
        tnative.stage_frames(track, starts, flen, np.empty((2, 2, dlen), np.float32)
                             .transpose(0, 2, 1))
    with pytest.raises(ValueError, match="do not fit"):
        tnative.stage_frames(track, starts, flen, np.empty((3, dlen, 2), np.float32))
    with pytest.raises(ValueError, match="do not fit"):
        tnative.stage_frames(track, starts, dlen + 1, np.empty((2, dlen, 2), np.float32))


def _packed_batch(b=10, m=2048):
    """Device-packed EGR words of `b` frames (the port's packer, on the
    CPU), one row overflowing, and their threshold rows."""
    rng = np.random.default_rng(b)
    scale = np.linspace(0.5, 40.0, b)[:, None]
    fq = np.rint(rng.laplace(0, 1, (b, m)) * scale).astype(np.int32)
    fq[b // 2] = rng.integers(-(1 << 20), 1 << 20, m)       # overflows max_words
    tq = rng.integers(0, 60, (b, 54)).astype(np.int32)
    words, nbits, ks, ovf = tbitpack.egr_pack_frames(torch.from_numpy(fq), m * 12 // 32)
    return (fq, tq, words.numpy().astype(np.uint32), nbits.numpy(), ks.numpy(),
            ovf.numpy())


def test_p1_pack_batch(numpy_path):
    fq, tq, words, nbits, ks, ovf = _packed_batch()
    assert ovf.sum() == 1
    got = tnative.p1_pack_batch(words, nbits, ks, ovf, tq)
    assert got == jnative.p1_pack_batch(words, nbits, ks, ovf, tq)
    for i, p in enumerate(got):
        if ovf[i]:
            assert p is None
            continue
        with numpy_path:
            thres = tgolomb.encode(tq[i])
        frad = (struct.pack(">I", len(thres)) + thres
                + tbitpack.words_to_stream(words[i], nbits[i], ks[i]))
        assert p == zlib.compress(frad, wbits=-15)
        np.testing.assert_array_equal(tprofile1.unpack_streams(p)[0], fq[i])


def test_p1_unpack_batch_with_corrupt_payloads(numpy_path):
    fq, tq, words, nbits, ks, ovf = _packed_batch()
    payloads = [p for p in tnative.p1_pack_batch(words, nbits, ks, ovf, tq) if p]
    good = payloads[0]
    payloads += [b"", b"\x00garbage", good[: len(good) // 2], _bytes(300, 9),
                 zlib.compress(b"\x00\x00", wbits=-15),               # too short
                 zlib.compress(b"\xff\xff\xff\xff\x00", wbits=-15)]   # thres_len past end
    n, ch = 1024, 2
    got_fq, got_tq, no_lq, ok = tnative.p1_unpack_batch(payloads, n * ch, 27 * ch)
    assert no_lq is None
    jfq, jtq, _, jok = jnative.p1_unpack_batch(payloads, n * ch, 27 * ch)
    np.testing.assert_array_equal(got_fq, jfq)
    np.testing.assert_array_equal(got_tq, jtq)
    np.testing.assert_array_equal(ok, jok)
    assert ok[:9].all() and not ok[9:13].any()
    assert not got_fq[~ok].any() and not got_tq[~ok].any()
    with numpy_path:
        nfq, ntq, _ = tpipeline._unpack_run(payloads, n, ch, 1, "float32")
    np.testing.assert_array_equal(nfq, got_fq)
    np.testing.assert_array_equal(ntq, got_tq)
    np.testing.assert_array_equal(got_fq[0, :2048], fq[0])


def _corrupt_batch():
    """(pack arguments of 20 frames, one overflowing; their payloads with
    corrupt ones appended)."""
    _, tq, words, nbits, ks, ovf = _packed_batch(20)
    args = (words, nbits, ks, ovf, tq)
    payloads = [p for p in tnative.p1_pack_batch(*args) if p]
    payloads += [b"", b"\x00garbage", payloads[0][: len(payloads[0]) // 2],
                 zlib.compress(b"\x00\x00", wbits=-15)]
    return args, payloads


def _inflated(payloads):
    """Bytes zlib gives back for the payloads it inflates whole."""
    total = 0
    for p in payloads:
        try:
            total += len(zlib.decompress(p, wbits=-15))
        except zlib.error:
            pass
    return total


def _check_pass(p, frames, phases, cpus=None, threads=None):
    """A pass record's own arithmetic: phases tile the workers' lifetimes,
    the CPU time fits inside those (to a scheduler tick a worker, where the
    thread CPU clock moves in ticks) and the lifetimes inside the pass's
    wall, the workers' wall clock lies inside the wrapper's (one clock,
    CLOCK_MONOTONIC, on both sides). Without a count named (`threads`) the
    pass started `pass_workers(frames)` workers."""
    assert p.frames == frames
    assert p.threads == (threads or tnative.pass_workers(frames))
    assert p.cpus == (cpus or len(os.sched_getaffinity(0))) >= 1
    assert p.cpu_quota is None or p.cpu_quota > 0
    assert tuple(p.phase_s) == phases and all(v >= 0 for v in p.phase_s.values())
    assert sum(p.phase_s.values()) == pytest.approx(p.live_s, rel=0.01)
    assert 0 <= p.busy_s <= p.live_s * 1.01 + p.threads * 0.01
    assert 0 < p.live_s <= p.threads * (p.t1 - p.t0)
    assert p.t0 <= p.first <= p.last <= p.t1


def _usable(monkeypatch, affinity, quota, local):
    """Make the process see `affinity` CPUs, a cgroup quota and torchrun's
    LOCAL_WORLD_SIZE (None: unset)."""
    monkeypatch.setattr(tnative.os, "sched_getaffinity", lambda pid: set(range(affinity)))
    monkeypatch.setattr(tnative, "cpu_quota", lambda: quota)
    if local is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)


@pytest.mark.parametrize("affinity,quota,local,frames,want", [
    (8, None, None, 1, 1),
    (8, None, None, 7, 1),          # run_pass's one-worker floor
    (8, None, None, 8, 3),          # never below 3 where 3 CPUs are usable
    (8, None, None, 40, 5),         # at most a worker for each 8 frames
    (8, None, None, 6890, 8),       # never above the affinity
    (64, None, None, 6890, 64),
    (8, 2.5, None, 6890, 2),        # the whole CPUs of a fractional quota
    (8, 0.5, None, 6890, 1),
    (8, 16.0, None, 6890, 8),
    (8, None, "4", 6890, 2),        # shared among the host's torchrun processes
    (8, None, "4", 8, 2),
    (16, 12.0, "2", 6890, 6),
    (2, None, None, 100, 2),
    (1, None, None, 100, 1),
])
def test_pass_workers(monkeypatch, affinity, quota, local, frames, want):
    _usable(monkeypatch, affinity, quota, local)
    assert tnative.pass_workers(frames) == want


def test_pass_workers_bounds(monkeypatch):
    """One worker below 8 frames; else never above the usable CPUs nor a
    worker for each 8 frames beyond 3, and never below 3 where 3 CPUs are
    usable."""
    for affinity in range(1, 17):
        _usable(monkeypatch, affinity, None, None)
        for frames in range(1, 300):
            w = tnative.pass_workers(frames)
            if frames < 8:
                assert w == 1
            else:
                assert min(3, affinity) <= w <= min(affinity, max(3, -(-frames // 8)))


@pytest.mark.parametrize("nthreads", [1, 3, None])
def test_pack_pass_bytes_at_every_worker_count(numpy_path, nthreads):
    """Frames are independent: at 1, 3 and `pass_workers` workers the pack
    gives the JAX package's bytes, each payload `zlib.compress` of its frame."""
    _, tq, words, nbits, ks, ovf = _packed_batch(96)
    tnative.reset_calls()
    got = tnative.p1_pack_batch(words, nbits, ks, ovf, tq, nthreads=nthreads, stats=True)
    assert tnative.p1_pack_batch.passes[0].threads == (nthreads or tnative.pass_workers(96))
    assert got == jnative.p1_pack_batch(words, nbits, ks, ovf, tq)
    for i, p in enumerate(got):
        if ovf[i]:
            assert p is None
            continue
        with numpy_path:
            thres = tgolomb.encode(tq[i])
        frad = (struct.pack(">I", len(thres)) + thres
                + tbitpack.words_to_stream(words[i], nbits[i], ks[i]))
        assert p == zlib.compress(frad, wbits=-15)


@pytest.mark.parametrize("nthreads", [1, 3, None])
def test_unpack_pass_at_every_worker_count(nthreads):
    _, payloads = _corrupt_batch()
    payloads = payloads * 4
    tnative.reset_calls()
    got = tnative.p1_unpack_batch(payloads, 2048, 54, nthreads=nthreads, stats=True)
    assert tnative.p1_unpack_batch.passes[0].threads == \
        (nthreads or tnative.pass_workers(len(payloads)))
    want = jnative.p1_unpack_batch(payloads, 2048, 54)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("nthreads", [1, 3, None])
def test_frame_pack_and_unarmor_bytes_at_every_worker_count(nthreads):
    lens = [0, 1, 95, 96, 97, 500, 960, 1234, 3000, 17] * 6
    payloads = [_bytes(n, i) for i, n in enumerate(lens)]
    bdis = np.random.default_rng(12).integers(0, 7, len(lens)).astype(np.uint8)
    flens = np.full(len(lens), 2048, dtype=np.uint32)
    fidx = np.array([tpipeline.compact.get_samples_index(2048)] * len(lens))
    kw = dict(profile=1, is_compact=True, channels=2, srate=44100,
              srate_idx=tpipeline.compact.get_srate_index(44100), overlap_ratio=16,
              ecc=True, ecc_dsize=96, ecc_codesize=24)
    got = tnative.frame_pack_batch(payloads, bdis, flens, fidx, nthreads=nthreads, **kw)
    assert got == jnative.frame_pack_batch(payloads, bdis, flens, fidx, **kw)
    armored = [tecc.encode(p, 96, 24) for p in payloads]
    crcs = np.array([tcommon.crc16_ansi(p) for p in armored])
    raws, ok = tnative.unarmor_batch(armored, 96, 24, crcs, True, True, nthreads=nthreads)
    want, jok = jnative.unarmor_batch(armored, 96, 24, crcs, True, True)
    assert raws == want == payloads
    np.testing.assert_array_equal(ok, jok)


def test_cpu_quota_reads_the_smallest_limit_on_the_path(tmp_path):
    """cgroup v2 `cpu.max` and v1 `cpu.cfs_quota_us` / `cpu.cfs_period_us`,
    the smallest limit of the cgroup and its parents; no limit is None."""
    def put(rel, text):
        f = tmp_path / rel
        f.parent.mkdir(parents=True, exist_ok=True)
        f.write_text(text)

    put("cpu.max", "max 100000\n")
    put("a/cpu.max", "600000 100000\n")
    put("a/b/cpu.max", "800000 100000\n")
    assert tnative._cgroup_quota("0::/a/b\n", str(tmp_path)) == 6.0
    assert tnative._cgroup_quota("0::/\n", str(tmp_path)) is None
    put("cpu,cpuacct/j/cpu.cfs_quota_us", "250000\n")
    put("cpu,cpuacct/j/cpu.cfs_period_us", "100000\n")
    put("cpu,cpuacct/cpu.cfs_quota_us", "-1\n")
    put("cpu,cpuacct/cpu.cfs_period_us", "100000\n")
    assert tnative._cgroup_quota("4:memory:/j\n2:cpu,cpuacct:/j\n", str(tmp_path)) == 2.5
    assert tnative._cgroup_quota("2:cpu,cpuacct:/\n1:pids:/\n", str(tmp_path)) is None
    q = tnative.cpu_quota()
    assert q is None or q > 0


def test_pass_busy_time_is_cpu_time():
    """`busy_s` is the workers' CPU time, not their lifetimes: a pass whose
    worker is kept off the CPU for part of its life (here: the pass runs
    while a second Python thread holds a spin on the only CPU the process
    may use) reads less busy time than lifetime."""
    import threading
    import time

    args, _ = _corrupt_batch()
    args = tuple(np.concatenate([a] * 40) for a in args)
    cpus = sorted(os.sched_getaffinity(0))
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            sum(range(1000))

    os.sched_setaffinity(0, cpus[:1])
    try:
        tnative.reset_calls()
        t = threading.Thread(target=spin)
        t.start()
        time.sleep(0.01)
        tnative.p1_pack_batch(*args, nthreads=3, stats=True)
    finally:
        stop.set()
        t.join()
        os.sched_setaffinity(0, cpus)
    (p,) = tnative.p1_pack_batch.passes
    _check_pass(p, len(args[0]), ("thres_egr", "words", "deflate"), cpus=1, threads=3)
    assert p.busy_s < 0.9 * p.live_s, (p.busy_s, p.live_s)


def test_pass_counters_leave_the_results_alone():
    args, payloads = _corrupt_batch()
    assert tnative.p1_pack_batch(*args, stats=True) == tnative.p1_pack_batch(*args)
    plain = tnative.p1_unpack_batch(payloads, 2048, 54)
    counted = tnative.p1_unpack_batch(payloads, 2048, 54, stats=True)
    for a, b in zip(plain, counted):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("frames", [1, 7, 8, 20, 160])
def test_pack_pass_counters(frames):
    args, _ = _corrupt_batch()
    args = tuple(np.concatenate([a] * 8)[:frames] for a in args)
    tnative.reset_calls()
    got = tnative.p1_pack_batch(*args, stats=True)
    (p,) = tnative.p1_pack_batch.passes
    _check_pass(p, frames, ("thres_egr", "words", "deflate"))
    assert p.bytes_out == sum(len(x) for x in got if x)
    assert p.bytes_in == _inflated(x for x in got if x)


@pytest.mark.parametrize("frames", [1, 7, 8, 23, 184])
def test_unpack_pass_counters(frames):
    _, payloads = _corrupt_batch()
    payloads = (payloads * 8)[-frames:]
    tnative.reset_calls()
    tnative.p1_unpack_batch(payloads, 2048, 54, stats=True)
    (p,) = tnative.p1_unpack_batch.passes
    _check_pass(p, frames, ("inflate", "egr_untrim"))
    assert p.bytes_in == sum(len(x) for x in payloads)
    assert p.bytes_out == _inflated(payloads)


def test_pass_logs_only_with_stats_and_reset():
    args, payloads = _corrupt_batch()
    tnative.reset_calls()
    tnative.p1_pack_batch(*args)
    tnative.p1_unpack_batch(payloads, 2048, 54)
    assert not tnative.p1_pack_batch.passes and not tnative.p1_unpack_batch.passes
    for _ in range(2):
        tnative.p1_pack_batch(*args, stats=True)
        tnative.p1_unpack_batch(payloads, 2048, 54, stats=True)
    assert len(tnative.p1_pack_batch.passes) == len(tnative.p1_unpack_batch.passes) == 2
    assert tnative.p1_pack_batch.passes.maxlen == tnative.PASS_LOG
    tnative.reset_calls()
    assert not tnative.p1_pack_batch.passes and not tnative.p1_unpack_batch.passes
    assert tnative.p1_pack_batch.calls == tnative.p1_unpack_batch.calls == 0


def test_pipeline_counts_passes_only_under_a_stage_timer(monkeypatch):
    """With `pipeline.STAGES` unset the C passes get a null counter buffer
    and no pass is logged; with a timer set, each pass is logged."""
    from frad_python_tpu_torch import batch_decode, batch_encode
    from frad_python_tpu_torch.utils.tracing import StageTimer

    lib, buffers = tnative.library(), []

    class _Lib:
        def __getattr__(self, name):
            fn = getattr(lib, name)
            if name not in ("frad_p1_pack_batch", "frad_p1_unpack_batch"):
                return fn

            def call(*args):
                buffers.append((name, args[-1]))
                return fn(*args)
            return call

    monkeypatch.setattr(tnative, "library", _Lib)
    pcm = np.random.default_rng(3).uniform(-0.5, 0.5, (44100, 2))
    kw = dict(compute_dtype="float32", device="cpu")
    tnative.reset_calls()
    stream = batch_encode(pcm, 1, 44100, 16, 2048, **kw)
    batch_decode(stream, **kw)
    assert [n for n, _ in buffers] == ["frad_p1_pack_batch", "frad_p1_unpack_batch"]
    assert all(b is None for _, b in buffers)
    assert not tnative.p1_pack_batch.passes and not tnative.p1_unpack_batch.passes
    buffers.clear()
    try:
        tpipeline.STAGES = StageTimer()
        assert batch_encode(pcm, 1, 44100, 16, 2048, **kw) == stream
        batch_decode(stream, **kw)
    finally:
        tpipeline.STAGES = None
    assert all(b is not None for _, b in buffers) and len(buffers) == 2
    assert len(tnative.p1_pack_batch.passes) == len(tnative.p1_unpack_batch.passes) == 1
    for p in (*tnative.p1_pack_batch.passes, *tnative.p1_unpack_batch.passes):
        assert p.threads == tnative.pass_workers(p.frames)


@pytest.mark.parametrize("profile,ecc_ratio", [
    (1, None), (1, (96, 24)), (1, (48, 12)), (1, (200, 55)), (1, (10, 0)),
    (4, None), (4, (96, 24)),
])
def test_frame_pack_batch(numpy_path, profile, ecc_ratio):
    rng = np.random.default_rng(12)
    lens = [0, 1, 95, 96, 97, 500, 960, 1234, 3000, 17]
    payloads = [_bytes(n, i) for i, n in enumerate(lens)]
    bdis = rng.integers(0, 7, len(lens)).astype(np.uint8)
    compact = profile == 1
    flens = np.array([2048, 1920, 2048, 128, 2048, 2048, 1536, 2048, 2048, 256]
                     if compact else rng.integers(1, 70000, len(lens)), dtype=np.uint32)
    ecc = ecc_ratio is not None
    dsize, csize = ecc_ratio or (0, 0)
    kw = dict(profile=profile, channels=3, srate=48000, overlap_ratio=16,
              little_endian=True, ecc_ratio=ecc_ratio)
    got = tpipeline._frame_batch(list(zip(payloads, bdis.tolist(), flens.tolist())), **kw)
    fidx = np.array([tpipeline.compact.get_samples_index(int(f)) for f in flens]) \
        if compact else None
    want = jnative.frame_pack_batch(
        payloads, bdis, flens, fidx, profile=profile, is_compact=compact, channels=3,
        srate=48000, srate_idx=tpipeline.compact.get_srate_index(48000) if compact else 0,
        overlap_ratio=16, little_endian=True, ecc=ecc, ecc_dsize=dsize, ecc_codesize=csize)
    assert got == want
    with numpy_path:
        frames = []
        for p, bdi, fl in zip(payloads, bdis, flens):
            a = tasfh.ASFH()
            a.profile, a.bit_depth_index, a.channels, a.srate = profile, int(bdi), 3, 48000
            a.fsize, a.overlap_ratio, a.endian = int(fl), 16, True
            a.ecc, a.ecc_dsize, a.ecc_codesize = ecc, dsize, csize
            frames.append(a.write(tecc.encode(p, dsize, csize) if ecc else p))
    assert b"".join(frames) == got


def _parse_stream():
    """Frames of two configurations, junk before, between and inside a
    false sign, terminators, and a truncated trailing frame."""
    def frame(profile, ecc, payload, ch=2, fsize=2048):
        a = tasfh.ASFH()
        a.profile, a.channels, a.srate, a.fsize = profile, ch, 44100, fsize
        a.bit_depth_index, a.overlap_ratio = 2, 16
        a.ecc, a.ecc_dsize, a.ecc_codesize = ecc, (96 if ecc else 0), (24 if ecc else 0)
        return a, a.write(payload)

    parts = [b"junk\xff\xd0\xd2"]
    a = None
    for i in range(12):
        a, f = frame(1, i % 3 == 0, _bytes(100 + 37 * i, i))
        parts.append(f)
        if i == 5:
            parts.append(b"\x00" * 7)
    parts.append(a.force_flush() * 2)
    parts.append(frame(4, False, _bytes(64, 99), ch=1, fsize=777)[1])
    _, last = frame(1, True, _bytes(300, 50))
    parts.append(last[:-20])
    return b"".join(parts)


def test_frame_parse_batch(numpy_path):
    stream = _parse_stream()
    got = tnative.frame_parse_batch(stream)
    want = jnative.frame_parse_batch(stream)
    assert got[0] == want[0] == 15 and got[-1] == want[-1] > 0
    for g, w in zip(got[1:-1], want[1:-1]):
        np.testing.assert_array_equal(g[: got[0]], w[: want[0]])
    nh, np_, ntail = tpipeline._parse_frames(stream)
    *_, ntail_pos, nstarts = tpipeline._scan_frames(stream)
    with numpy_path:
        ph, pp, ptail = tpipeline._parse_frames(stream)
        *_, ptail_pos, pstarts = tpipeline._scan_frames(stream)
    assert np_ == pp and ntail == ptail == stream[got[-1]:]
    assert ptail_pos == ntail_pos == got[-1] and pstarts == nstarts
    assert len(nstarts) == 15 and all(stream.startswith(a.buffer, st) for a, st in zip(nh, nstarts))
    for a, b in zip(nh, ph):
        for name in set(tasfh.ASFH.__slots__) - {"all_set"}:   # False on a terminator
            assert getattr(a, name) == getattr(b, name), name


@pytest.mark.parametrize("ecc_ratio,framer_passes", [(None, 2), ((96, 24), 2), ((0, 0), 0)])
def test_pipeline_native_passes_per_call(ecc_ratio, framer_passes):
    """Natively each `batch_decode` and each `batch_repair` scans the stream
    in one `frame_parse_batch` call; `batch_encode` frames each group (the
    uniform frames, the tail frame) in one `frame_pack_batch` call, or frame
    by frame at an ECC data size of 0, and `batch_repair` each run (here the
    frames before the junk and those after it)."""
    from frad_python_tpu_torch import batch_decode, batch_encode, batch_repair

    pcm = np.random.default_rng(4).uniform(-0.5, 0.5, (30000, 2))
    kw = dict(compute_dtype="float32", device="cpu")
    ecc = dict(enable_ecc=True, ecc_ratio=ecc_ratio) if ecc_ratio else {}
    tnative.reset_calls()
    stream = batch_encode(pcm, 1, 44100, 16, 2048, **kw, **ecc)
    assert (tnative.frame_pack_batch.calls, tnative.frame_parse_batch.calls) == (framer_passes, 0)
    tnative.reset_calls()
    batch_decode(stream, fix_error=True, **kw)
    assert (tnative.frame_pack_batch.calls, tnative.frame_parse_batch.calls) == (0, 1)
    tnative.reset_calls()
    batch_repair(stream + b"junk" + stream, (48, 12))
    assert (tnative.frame_pack_batch.calls, tnative.frame_parse_batch.calls) == (2, 1)


@pytest.mark.parametrize("crc_is16", [True, False])
@pytest.mark.parametrize("fix_error", [True, False])
def test_unarmor_batch(numpy_path, crc_is16, fix_error):
    rng = np.random.default_rng(21)
    raws = [_bytes(n, n) for n in (1, 95, 96, 500, 960, 1234, 3000, 97, 300)]
    armored = [tecc.encode(r, 96, 24) for r in raws]
    crcs = np.array([tcommon.crc16_ansi(p) if crc_is16 else tcommon.crc32(p) for p in armored])
    damaged = []
    for i, p in enumerate(armored):
        b = bytearray(p)
        if i % 2 == 0:
            for off in rng.choice(len(b), min(3, len(b)), replace=False):
                b[off] ^= 0xA5
        if i == 7:
            b[: 60] = bytes(60)                       # beyond correction
        damaged.append(bytes(b))
    got, ok = tnative.unarmor_batch(damaged, 96, 24, crcs, crc_is16, fix_error)
    want, jok = jnative.unarmor_batch(damaged, 96, 24, crcs, crc_is16, fix_error)
    assert got == want
    np.testing.assert_array_equal(ok, jok)
    with numpy_path:
        h = tasfh.ASFH()
        h.profile = 1 if crc_is16 else 4
        nump = []
        for p, crc in zip(damaged, crcs):
            h.crc = int(crc)
            nump.append(tecc.decode(p, 96, 24, fix_error and not h.payload_crc_matches(p)))
    assert nump == got
    if fix_error:
        assert [g for i, g in enumerate(got) if i != 7] == [r for i, r in enumerate(raws)
                                                              if i != 7]
        assert not ok[7] and ok[[0, 1, 2, 3, 4, 5, 6, 8]].all()


def test_counters_and_numpy_knob(numpy_path):
    tnative.reset_calls()
    assert all(w.calls == 0 for w in tnative.WRAPPERS)
    tgolomb.encode(np.arange(5))
    assert tnative.egr_encode.calls == 1 and tnative.enabled()
    with numpy_path:
        assert not tnative.enabled()
        tgolomb.encode(np.arange(5))
        tcommon.crc16_ansi(b"abc")
    assert tnative.egr_encode.calls == 1 and tnative.crc16_ansi.calls == 0
    assert len(tnative.WRAPPERS) == len(tnative.SIGNATURES)


_TINY = 'extern "C" int frad_tiny(int x) { return x + 1; }\n'


def test_build_is_cached_and_atomic(tmp_path, monkeypatch):
    src = tmp_path / "tiny.cpp"
    src.write_text(_TINY)
    monkeypatch.setattr(tbuild, "SRC", src)
    monkeypatch.setattr(tbuild, "BUILD_DIR", tmp_path / "_build")
    with ThreadPoolExecutor(4) as pool:
        outs = list(pool.map(lambda _: tbuild.build(), range(4)))
    path = outs[0][0]
    assert {o[0] for o in outs} == {path} and path.parent.parent == tmp_path / "_build"
    assert [p.name for p in path.parent.iterdir()] == [tbuild.LIB_NAME]   # no temp left
    assert tbuild.build() == (path, False)
    assert ctypes.CDLL(str(path)).frad_tiny(41) == 42
    src.write_text(_TINY + "// edited\n")
    new, compiled = tbuild.build()
    assert compiled and new != path


def test_failed_build_or_missing_symbol_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(tbuild, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(tnative, "_lib", None)
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tbuild, "SRC", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tcommon.crc16_ansi(b"abc")          # no fallback to the Python CRC
    assert not list((tmp_path / "_build").rglob("*.so"))
    tiny = tmp_path / "tiny.cpp"
    tiny.write_text(_TINY)
    monkeypatch.setattr(tbuild, "SRC", tiny)
    with pytest.raises(RuntimeError, match="lacks frad_crc16_ansi"):
        tnative.library()
    assert tnative._lib is None


def test_chip_smoke_refuses_the_numpy_host_path(monkeypatch):
    """The card's smoke run must exercise the native module: with
    FRAD_TORCH_NO_NATIVE set it stops before driving any path."""
    import subprocess
    import sys
    import types

    import chip_smoke
    from frad_python_tpu_torch.kernels import build as kbuild

    real_run = subprocess.run

    def run(cmd, *args, **kwargs):
        if cmd[0] == "nvidia-smi":
            return types.SimpleNamespace(stdout="card, 700.00 W\n")
        return real_run(cmd, *args, **kwargs)

    monkeypatch.setattr(subprocess, "run", run)
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "card")
    monkeypatch.setattr(kbuild, "build", lambda verbose=False: (kbuild.library_path(), False))
    monkeypatch.setattr(kbuild, "library", lambda: None)
    monkeypatch.setenv("FRAD_TORCH_NO_NATIVE", "1")
    with pytest.raises(RuntimeError, match="FRAD_TORCH_NO_NATIVE"):
        chip_smoke.main()
