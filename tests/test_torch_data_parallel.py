"""The port's automatic frame-batch data parallelism (`models/batch.py`:
`place_rows`, `data_sharding`, `sharding_disabled`, `run_rows`,
`decode_oa_rows`) against the JAX package's on its 8-device CPU mesh
(`tests/conftest.py`), on the CPU at small sizes, with the card list
patched to eight CPU devices (`_data_devices`), the counterpart of
`--xla_force_host_platform_device_count=8`.

Tolerances, each with its reason:

* float64 streams of profiles 1, 2 and 0 (16 and 24 bits): byte for byte
  against the JAX package's split streams (ROADMAP: byte-exact on the
  CPU); their decoded PCM within 1e-9 (lossy) and 1e-12 (lossless).
* 48-bit profile 0: the FFTs differ in the last bits of float64, which a
  36-bit truncation sees about once in 2^16 values: the frame plan equal
  and under 1% of the payload bytes differ.
* float32: symbols may flip at a rint boundary where the GEMMs sum in
  another order; the flip rate (payloads that differ) is printed, the
  frame plan must be equal and the decoded SNR within 0.1 dB of the JAX
  package's.
* The port against itself, split over eight devices and in one call:
  bit for bit, every profile and dtype (rows never interact; the
  overlap-add's halo is the same frame tail the whole-batch kernel reads).
"""

import contextlib
import inspect
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from frad_python_tpu.models import batch as jbatch
from frad_python_tpu.parallel import pipeline as jpipeline
import frad_python_tpu_torch as ft
from frad_python_tpu_torch.kernels.overlap_add import _crossfade_window, crossfade_window
from frad_python_tpu_torch.models import batch as tbatch
from frad_python_tpu_torch.ops import dct as tdct
from frad_python_tpu_torch.ops import policy as tpolicy
from frad_python_tpu_torch.ops import psycho as tpsycho
from frad_python_tpu_torch.parallel import pipeline as tpipeline
from frad_python_tpu_torch.parallel import sharded

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
NDEV = 8
N = 256                        # compact frame of the lossy cases
HOP = N * 15 // 16             # overlap ratio 16
SRATE = 44100
RANK_TIMEOUT_S = 240


@pytest.fixture
def split8(monkeypatch):
    """The port splits over eight CPU devices, as the JAX package's mesh."""
    monkeypatch.setattr(tbatch, "_data_devices", lambda device: [CPU] * NDEV)


def _lossy_track(frames: int, tail: int = 0, seed: int = 7) -> np.ndarray:
    """PCM whose uniform run is `frames` frames of N (then a tail frame of
    the overlap plus `tail` samples, which a lossy stream always has)."""
    rng = np.random.default_rng(seed)
    t = np.arange(N + (frames - 1) * HOP + tail)
    tone = 0.3 * np.sin(2 * np.pi * 440 * t / SRATE)[:, None]
    return tone + 0.05 * rng.standard_normal((len(t), 2))


def _lossless_track(frames: int, n: int, tail: int = 0, seed: int = 8) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.clip(rng.standard_normal((frames * n + tail, 2)) * 0.3, -1, 1)


def _payloads(stream: bytes) -> list:
    return tpipeline._parse_frames(stream)[1]


def _plan(stream: bytes) -> list:
    hs, ps, tail = tpipeline._parse_frames(stream)
    return [(h.profile, h.fsize, h.bit_depth_index, p is None) for h, p in zip(hs, ps)] + [tail]


def _snr(ref: np.ndarray, out: np.ndarray) -> float:
    m = min(len(ref), len(out))
    return float(10 * np.log10(np.sum(ref[:m] ** 2) / np.sum((out[:m] - ref[:m]) ** 2)))


def _blocks_seen(monkeypatch) -> list:
    """(real rows, blocks, padding) of every `place_rows` call from here on."""
    seen = []
    real = tbatch.place_rows

    def spy(arr, device=None, upload=None, nreal=None):
        placed = real(arr, device, upload, nreal)
        seen.append((arr.shape[0] if nreal is None else nreal, len(placed.blocks), placed.pad))
        return placed

    monkeypatch.setattr(tbatch, "place_rows", spy)
    return seen


#: name: (profile, bits, frame size, encode options, decode options)
LOSSY = {
    "p1": (1, 16, N, {}, {}),
    "p2": (2, 16, N, {}, {}),
}
LOSSLESS = {"p0_16": (0, 16, 128, {}, {}), "p0_24": (0, 24, 128, {}, {})}


def _encode_decode(mod_encode, mod_decode, pcm, cfg, dtype, **dev):
    profile, bits, n, ekw, dkw = cfg
    stream = mod_encode(pcm, profile, SRATE, bits, n, compute_dtype=dtype, **ekw, **dev)
    out = mod_decode(stream, compute_dtype=dtype, **dkw, **dev)[0]
    return stream, out


def _track(name: str, frames: int, tail: int = 0) -> np.ndarray:
    if name in LOSSY:
        return _lossy_track(frames, tail)
    return _lossless_track(frames, LOSSLESS[name][2], tail)


# ----------------------------------------------------------------------
# batch sizes against the JAX package's 8-device mesh
# ----------------------------------------------------------------------
@pytest.mark.parametrize("frames", [15, 16, 23])
@pytest.mark.parametrize("name", [*LOSSY, *LOSSLESS])
def test_float64_streams_equal_jax_split(split8, monkeypatch, name, frames):
    """B = 15 stays whole, 16 splits 2 a device, 23 pads 1; the streams
    equal the JAX package's (its mesh splits the same batches) byte for
    byte and the port's own unsplit streams; the PCM too."""
    cfg = {**LOSSY, **LOSSLESS}[name]
    pcm = _track(name, frames)
    seen = _blocks_seen(monkeypatch)
    stream, out = _encode_decode(ft.batch_encode, ft.batch_decode, pcm, cfg, "float64",
                                 device=CPU)
    uniform = [s for s in seen if s[0] == frames]
    assert uniform and all(s == ((frames, 1, 0) if frames < 2 * NDEV
                                 else (frames, NDEV, (-frames) % NDEV)) for s in uniform), seen
    want, want_out = _encode_decode(jpipeline.batch_encode, jpipeline.batch_decode, pcm, cfg,
                                    "float64")
    assert stream == want
    np.testing.assert_allclose(out, want_out, rtol=0, atol=1e-9 if name in LOSSY else 1e-12)
    with tbatch.sharding_disabled():
        alone, alone_out = _encode_decode(ft.batch_encode, ft.batch_decode, pcm, cfg,
                                          "float64", device=CPU)
    assert stream == alone and np.array_equal(out, alone_out)


#: float32 cases: (name, config, frames)
F32_CASES = {
    "p1_i16_egr": ((1, 16, N, {"i16_upload": True}, {"i16_transfer": True}), 23),
    "p1_egr_16": ((1, 16, N, {}, {}), 16),
    "p2": ((2, 16, N, {}, {}), 23),
    "p0_16_fast": ((0, 16, 128, {}, {}), 23),
    "p0_24_fast": ((0, 24, 128, {}, {}), 16),
    "p0_24_i24": ((0, 24, 128, {"i24_upload": True}, {"i24_transfer": True}), 23),
}


@pytest.mark.parametrize("case", list(F32_CASES))
def test_float32_split_bounded_against_jax_and_equal_to_unsplit(split8, capsys, case):
    """float32: the split streams and PCM equal the port's unsplit ones bit
    for bit; against the JAX package's split run the frame plan is equal,
    the payloads that differ (the flip rate) are printed, and the decoded
    SNR is within 0.1 dB of the JAX package's."""
    cfg, frames = F32_CASES[case]
    pcm = _lossy_track(frames) if cfg[0] else _lossless_track(frames, cfg[2])
    stream, out = _encode_decode(ft.batch_encode, ft.batch_decode, pcm, cfg, "float32",
                                 device=CPU)
    with tbatch.sharding_disabled():
        alone, alone_out = _encode_decode(ft.batch_encode, ft.batch_decode, pcm, cfg,
                                          "float32", device=CPU)
    assert stream == alone and np.array_equal(out, alone_out)
    want, want_out = _encode_decode(jpipeline.batch_encode, jpipeline.batch_decode, pcm, cfg,
                                    "float32")
    assert _plan(stream) == _plan(want)
    flips = sum(a != b for a, b in zip(_payloads(stream), _payloads(want)) if a is not None)
    with capsys.disabled():
        print(f"\n{case}: {flips} of {len(_payloads(want))} payloads differ from the JAX "
              f"package's split stream")
    assert _snr(pcm, out) >= _snr(pcm, want_out) - 0.1


def test_deep_p0_split_against_jax(split8):
    """48-bit profile 0 (float64 FFT form), 23 frames and a tail frame: the
    split stream equals the port's unsplit one; against the JAX package's
    the plan is equal and under 1% of the payload bytes differ."""
    pcm = _lossless_track(23, 128, tail=50)
    cfg = (0, 48, 128, {}, {})
    stream, out = _encode_decode(ft.batch_encode, ft.batch_decode, pcm, cfg, "float64",
                                 device=CPU)
    with tbatch.sharding_disabled():
        alone, _ = _encode_decode(ft.batch_encode, ft.batch_decode, pcm, cfg, "float64",
                                  device=CPU)
    assert stream == alone
    want, want_out = _encode_decode(jpipeline.batch_encode, jpipeline.batch_decode, pcm, cfg,
                                    "float64")
    assert _plan(stream) == _plan(want)
    a, b = np.frombuffer(stream, np.uint8), np.frombuffer(want, np.uint8)
    assert (a != b).sum() < 0.01 * len(a)
    np.testing.assert_allclose(out, want_out, rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", ["p1", "p0_24"])
def test_tail_frame_of_another_size(split8, monkeypatch, name):
    """A run of 23 frames splits and the tail frame of another size runs
    alone; float64 streams equal the JAX package's."""
    cfg = {**LOSSY, **LOSSLESS}[name]
    pcm = _track(name, 23, tail=37)
    seen = _blocks_seen(monkeypatch)
    stream, out = _encode_decode(ft.batch_encode, ft.batch_decode, pcm, cfg, "float64",
                                 device=CPU)
    assert (23, NDEV, 1) in seen and any(s[1] == 1 for s in seen)
    want, want_out = _encode_decode(jpipeline.batch_encode, jpipeline.batch_decode, pcm, cfg,
                                    "float64")
    assert stream == want
    np.testing.assert_allclose(out, want_out, rtol=0, atol=1e-9)


# ----------------------------------------------------------------------
# the split overlap-add and the fragment
# ----------------------------------------------------------------------
ON = 360                       # cut and overlap are not powers of two at any ratio below


def _decode_inputs(frames: int, dtype: str, seed: int, n: int = ON):
    rng = np.random.default_rng(seed)
    fq = np.rint(rng.laplace(0, 3, (frames, n, 2))).astype(dtype)
    tq = np.rint(rng.laplace(0, 4, (frames, 27, 2))).astype(dtype)
    return fq, tq


@pytest.mark.parametrize("ratio", [2, 3, 16])
@pytest.mark.parametrize("frames", [23, 21, 17])          # pad 1, 3 and 7
def test_split_overlap_add_fragment_is_the_last_real_frames(split8, monkeypatch, frames,
                                                            ratio):
    """`decode_oa_rows` over eight blocks equals `p1_decode_oa_core` in one
    call bit for bit; block i >= 1 is blended with the tail of block i-1's
    last frame; the fragment is the tail of the last real frame, not of a
    padding row."""
    cut = ON * (ratio - 1) // ratio
    olap = ON - cut
    fq, tq = _decode_inputs(frames, "float64", frames * ratio)
    halos = []
    real_oa = tbatch.overlap_add

    def spy(pcm, w, c, i16, halo=None):
        halos.append(None if halo is None else halo.clone())
        return real_oa(pcm, w, c, i16, halo)

    monkeypatch.setattr(tbatch, "overlap_add", spy)
    rows = tbatch.decode_oa_rows(tbatch.p1_decode_core, (fq, tq), CPU, (SRATE, 2.0 ** 15),
                                 olap, cut, False)
    out, frag = rows.fetch()
    split_halos = halos[:]              # the unsplit calls below add theirs
    pad = (-frames) % NDEV
    assert rows.pad == pad and len(rows.blocks) == NDEV
    pcm = tbatch.p1_decode_core(torch.from_numpy(fq), torch.from_numpy(tq), SRATE, 2.0 ** 15)
    want_out, want_frag = tbatch.p1_decode_oa_core(torch.from_numpy(fq), torch.from_numpy(tq),
                                                   SRATE, 2.0 ** 15, olap, cut, False)
    assert np.array_equal(out, want_out.numpy()) and np.array_equal(frag, want_frag.numpy())
    assert np.array_equal(frag, pcm[frames - 1, cut:cut + olap].numpy())
    per = (frames + pad) // NDEV
    assert split_halos[0] is None and len(split_halos) == NDEV
    for i in range(1, NDEV):
        if i * per < frames:       # a block holding real frames: its halo is a real tail
            assert np.array_equal(split_halos[i].numpy(),
                                  pcm[i * per - 1, cut:cut + olap].T.numpy())
    jout, jfrag = jbatch.p1_decode_oa_core(fq, tq, SRATE, 2.0 ** 15, olap, cut, False)
    np.testing.assert_allclose(out, np.asarray(jout), rtol=0, atol=1e-9)
    np.testing.assert_allclose(frag, np.asarray(jfrag), rtol=0, atol=1e-9)


@pytest.mark.parametrize("i16", [False, True])
def test_split_p2_overlap_add_and_int16_emit(split8, i16):
    """Profile 2's decode (TNS synthesis) through the same split, float32,
    int16 emit and not: bit for bit against one call. (At float32 the
    frame is N = 256: torch's vectorised CPU pow rounds the last elements
    of a block that is not a whole number of vectors in its scalar tail,
    one ulp off the vector path, so the plain versions at N = 360 are not
    the same function of a row's position; the card's kernels are.)"""
    fq, tq = _decode_inputs(21, "float32", 5, N)
    lq = np.rint(np.random.default_rng(6).laplace(0, 2, (21, 13, 2))).astype(np.float32)
    cut, olap = HOP, N - HOP
    out, frag = tbatch.decode_oa_rows(tbatch.p2_decode_core, (fq, tq, lq), CPU,
                                      (SRATE, 2.0 ** 15), olap, cut, i16).fetch()
    want = tbatch.p2_decode_oa_core(*(torch.from_numpy(a) for a in (fq, tq, lq)), SRATE,
                                    2.0 ** 15, olap, cut, i16)
    assert out.dtype == (np.int16 if i16 else np.float32)
    assert np.array_equal(out, want[0].numpy()) and np.array_equal(frag, want[1].numpy())


# ----------------------------------------------------------------------
# switches, devices and the launch loop
# ----------------------------------------------------------------------
def test_sharding_disabled_and_small_batches_take_the_one_device_path(split8, monkeypatch):
    """Inside `sharding_disabled()`, and under 2 rows a device, a decode is
    one block, one `overlap_add` launch without a halo."""
    fq, tq = _decode_inputs(16, "float32", 3)
    calls = []
    real_oa = tbatch.overlap_add
    monkeypatch.setattr(tbatch, "overlap_add",
                        lambda *a: calls.append(len(a) > 4 and a[4] is not None) or real_oa(*a))
    args = (tbatch.p1_decode_core, (fq, tq), CPU, (SRATE, 2.0 ** 15), 16, 240, False)
    with tbatch.sharding_disabled():
        assert tbatch.data_sharding(64, CPU) is None
        rows = tbatch.decode_oa_rows(*args)
    assert tbatch.SHARDING and len(rows.blocks) == 1 and calls == [False]
    calls.clear()
    rows = tbatch.decode_oa_rows(tbatch.p1_decode_core, (fq[:15], tq[:15]), *args[2:])
    assert len(rows.blocks) == 1 and calls == [False]
    calls.clear()
    rows = tbatch.decode_oa_rows(*args)
    assert len(rows.blocks) == NDEV and calls == [False] + [True] * (NDEV - 1)


@pytest.mark.parametrize("value,expect", [("1", False), ("", True)])
def test_env_switch(value, expect):
    """FRAD_TORCH_NO_SHARD=1 turns the split off for the process."""
    env = dict(os.environ, FRAD_TORCH_NO_SHARD=value)
    code = ("import torch; from frad_python_tpu_torch.models import batch as b; "
            "b._data_devices = lambda d: [torch.device('cpu')] * 8; "
            "print(b.SHARDING, b.data_sharding(64, 'cpu') is None)")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO, capture_output=True,
                         text=True, check=True).stdout.split()
    assert out == [str(expect), str(not expect)]


def test_data_devices(monkeypatch):
    """'cuda' without an index is every visible card; an explicit card or
    the CPU is itself alone."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tbatch._data_devices(torch.device("cuda")) == [
        torch.device("cuda", i) for i in range(4)]
    assert tbatch._data_devices(torch.device("cuda", 2)) == [torch.device("cuda", 2)]
    assert tbatch._data_devices(CPU) == [CPU]
    monkeypatch.setattr(tbatch, "_data_devices", lambda d: [d] * 4)
    assert tbatch.data_sharding(7, CPU) is None and tbatch.data_sharding(8, CPU) == [CPU] * 4


def test_place_rows_blocks_and_padding(monkeypatch):
    """Contiguous row blocks, one upload a block to its device, zero rows
    appended to the last; float64 splits too; one device: one upload."""
    devs = [torch.device("cpu")] * 4
    monkeypatch.setattr(tbatch, "_data_devices", lambda d: devs)
    ups = []
    arr = np.arange(11 * 3, dtype=np.float64).reshape(11, 3)
    placed = tbatch.place_rows(arr, CPU, lambda a, d: ups.append(d) or torch.from_numpy(a))
    assert placed.pad == 1 and len(ups) == 4 and [len(b) for b in placed.blocks] == [3] * 4
    joined = torch.cat(placed.blocks).numpy()
    assert np.array_equal(joined[:11], arr) and not joined[11:].any()
    assert placed.blocks[0].dtype == torch.float64
    monkeypatch.setattr(tbatch, "_data_devices", lambda d: [d])
    placed = tbatch.place_rows(arr, "cpu")
    assert placed.pad == 0 and len(placed.blocks) == 1


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("ndev,nreal", [(4, 11), (4, 12), (4, 5), (1, 11), (4, 7)])
def test_place_rows_of_a_staging_buffer_uploads_slices(monkeypatch, kind, ndev, nreal):
    """A staging buffer of `padded_rows(nreal)` rows (the lossy encode's:
    a numpy array, or on CUDA a pinned tensor) is placed as `place_rows`
    places its first `nreal` rows, each block a slice of the buffer, its
    padding rows the buffer's zero rows; no block is copied on the host."""
    monkeypatch.setattr(tbatch, "_data_devices", lambda d: [CPU] * ndev)
    rows = tbatch.padded_rows(nreal, CPU)
    split = ndev > 1 and nreal >= 2 * ndev
    assert rows == (nreal + (-nreal) % ndev if split else nreal)
    arr = np.arange(1.0, 1.0 + nreal * 6).reshape(nreal, 3, 2)
    buf = np.zeros((rows, 3, 2))
    buf[:nreal] = arr
    if kind == "tensor":
        buf = torch.from_numpy(buf)
    ups = []

    def upload(a, d):
        ups.append(a)
        return tpolicy.to_device(a, d)

    placed = tbatch.place_rows(buf, CPU, upload, nreal=nreal)
    want = tbatch.place_rows(arr, CPU)
    assert placed.pad == want.pad and len(placed.blocks) == len(want.blocks) == len(ups)
    for got, exp, up in zip(placed.blocks, want.blocks, ups):
        assert torch.equal(got, exp)
        assert np.shares_memory(np.asarray(up), np.asarray(buf))


def test_to_device_uploads_a_host_tensor_as_it_is():
    t = torch.arange(6.0).reshape(2, 3)
    assert tpolicy.to_device(t, CPU) is t


def test_explicit_tensors_and_sharded_cores_never_split(split8, monkeypatch):
    """A core called with tensors (the engines' per-frame path and
    `parallel/sharded.py`, whose ranks each own a card) runs as one call:
    `place_rows` is never reached, and sharded.py never calls the split."""
    monkeypatch.setattr(tbatch, "place_rows", lambda *a, **k: pytest.fail("split"))
    x = torch.from_numpy(_lossy_track(17)[:16 * N].reshape(16, N, 2).astype(np.float32))
    fq, tq = tbatch.p1_encode_core(x, SRATE, 0.5, 2.0 ** 15)
    assert fq.shape == (16, N, 2)
    src = inspect.getsource(sharded)
    assert "run_rows" not in src and "place_rows" not in src and "decode_oa_rows" not in src


def test_to_host_synchronises_each_card_once(monkeypatch):
    """`policy.synchronize` waits once on the current stream of every
    distinct CUDA device among the tensors, not on the current device's."""
    waited = []

    class Stream:
        def __init__(self, dev):
            self.dev = dev

        def synchronize(self):
            waited.append(self.dev)

    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    fake = [types.SimpleNamespace(device=torch.device(d))
            for d in ("cuda:1", "cpu", "cuda:0", "cuda:1", "cuda:3", "cuda:0")]
    tpolicy.synchronize(fake)
    assert waited == [torch.device("cuda", k) for k in (1, 0, 3)]
    waited.clear()
    tpolicy.synchronize([types.SimpleNamespace(device=CPU)])
    assert waited == []


def test_device_caches_one_entry_per_normalised_device(monkeypatch):
    """'cpu' and torch.device('cpu') share one entry of each device cache;
    'cuda' is keyed by the current card's index."""
    for cached, call in (
            (tdct._device_matrices, lambda d: tdct.device_matrices(48, d)),
            (tpsycho._device_consts, lambda d: tpsycho.device_consts(48, 44100, d)),
            (_crossfade_window, lambda d: crossfade_window(7, d))):
        cached.cache_clear()
        call("cpu")
        call(torch.device("cpu"))
        call(CPU)
        assert cached.cache_info().currsize == 1
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert tpolicy.device_key("cuda") == torch.device("cuda", 3)
    assert tpolicy.device_key(torch.device("cuda", 1)) == torch.device("cuda", 1)
    assert tpolicy.device_key("cpu") == CPU


def test_kernel_launch_guard(monkeypatch):
    """`build.on_device` makes the tensors' card current and yields its
    stream; tensors on two cards, or off CUDA, are refused; every wrapper
    launches inside it."""
    from frad_python_tpu_torch import kernels
    from frad_python_tpu_torch.kernels import build

    made = []
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: made.append(d) or contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=40 + d.index))
    a = types.SimpleNamespace(device=torch.device("cuda", 2))
    with build.on_device("k", a, None, a) as stream:
        assert stream.value == 42 and made == [torch.device("cuda", 2)]
    for bad in ((a, types.SimpleNamespace(device=torch.device("cuda", 0))),
                (types.SimpleNamespace(device=CPU),), ()):
        with pytest.raises(ValueError):
            with build.on_device("k", *bad):
                pass
    for k in kernels.KERNELS:
        src = inspect.getsource(sys.modules[k.__module__])
        assert "build.on_device(" in src and "current_stream" not in src, k.__name__


def test_launch_loop_waits_for_nothing(split8, monkeypatch):
    """A split encode launches every block's core before the first copy to
    the host; the fused Profile 1 encode then waits once a block for its
    EGR row sums and once for the words; a split decode waits once."""
    events = []
    real_to_host = tpolicy.to_host
    monkeypatch.setattr(tpolicy, "to_host",
                        lambda *t: events.append("wait") or real_to_host(*t))
    for name in ("mask_thres", "power_quant", "dequant", "overlap_add"):
        real = getattr(tbatch, name)
        monkeypatch.setattr(tbatch, name,
                            lambda *a, _f=real, _n=name: events.append(_n) or _f(*a))
    pcm = _lossy_track(23)
    stream = ft.batch_encode(pcm, 1, SRATE, 16, N, compute_dtype="float32", i16_upload=True,
                             device=CPU)
    first_wait = events.index("wait")
    assert events[:first_wait].count("power_quant") == NDEV
    assert events[first_wait:].count("wait") == NDEV + 1 + 1   # + the tail frame's fetch
    events.clear()
    ft.batch_decode(stream, compute_dtype="float32", i16_transfer=True, device=CPU)
    assert events[:2 * NDEV + 1] == ["dequant"] * NDEV + ["overlap_add"] * NDEV + ["wait"]
    assert events.count("wait") == 2                   # the run, then the tail frame


PUSH = 32768


def test_engines_split_their_micro_batches(monkeypatch):
    """`Encoder` and `Decoder` micro-batches of >= 8 frames split over 4
    devices (none on one device); the streams and PCM equal the unsplit
    engines'."""
    pcm = (_lossy_track(40) * 32767).astype("<i2")
    raw = pcm.tobytes()

    def run():
        enc = ft.Encoder(1, SRATE, 2, 16, N, "s16le", device=CPU)
        enc.set_overlap_ratio(16)
        s = b"".join(enc.process(raw[i:i + PUSH]).buf for i in range(0, len(raw), PUSH))
        s += enc.flush().buf
        dec = ft.Decoder(device=CPU)
        out = [dec.process(s[i:i + PUSH]).pcm for i in range(0, len(s), PUSH)]
        out.append(dec.flush().pcm)
        return s, np.concatenate([o for o in out if o.size])

    want = run()
    monkeypatch.setattr(tbatch, "_data_devices", lambda d: [CPU] * 4)
    seen = _blocks_seen(monkeypatch)
    got = run()
    assert any(n >= 8 and nb == 4 for n, nb, _ in seen), seen
    assert all(nb == 1 for n, nb, _ in seen if n < 8)
    assert got[0] == want[0] and np.array_equal(got[1], want[1])


WORKER = """
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)
rank, d = int(sys.argv[1]), Path(sys.argv[2])
sys.path.insert(0, sys.argv[3])
import torch.distributed as dist
from frad_python_tpu_torch.models import batch
from frad_python_tpu_torch.parallel import multihost

torch.cuda.device_count = lambda: 4
torch.cuda.current_device = lambda: rank
before = batch._data_devices(torch.device("cuda"))
multihost.init_distributed(f"file://{d / 'store'}", 2, rank, device="cpu")
during = batch._data_devices(torch.device("cuda"))
dist.destroy_process_group()
after = batch._data_devices(torch.device("cuda"))
(d / f"rank{rank}.txt").write_text(" ".join(str(len(x)) + ":" + str(x[0].index)
                                            for x in (before, during, after)))
"""


def test_ranks_of_a_process_group_keep_to_their_own_card(tmp_path):
    """While a group of 2 gloo ranks is up, `_data_devices('cuda')` is the
    rank's own current card, not all four: the ranks must not each split
    over every card. Before and after, all four."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(tmp_path), str(REPO)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    errors = []
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=RANK_TIMEOUT_S)
            if p.returncode != 0:
                errors.append(f"rank {r} exited {p.returncode}:\n{err[-3000:]}")
    finally:
        for p in procs:
            p.kill()
            p.wait()
    if errors:
        pytest.fail("\n".join(errors))
    for r in range(2):
        assert (tmp_path / f"rank{r}.txt").read_text() == f"4:0 1:{r} 4:0"


def test_jax_package_splits_the_same_batches():
    """The JAX package's mesh splits a batch from 16 rows (2 a device) as
    the port's patched device list does; below, neither does."""
    assert jbatch.data_sharding(15) is None and jbatch.data_sharding(16) is not None
