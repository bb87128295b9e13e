"""`pipeline.STAGES` of the port against the JAX package's, on the CPU at a
small size: the same call through both `batch_encode` / `batch_decode`
with a `StageTimer` set in each.

What is held, and why it is not more:

* every stage name the port records is one the JAX pipeline's source uses
  or one of `PORT_ONLY`; for the same call the port's names are those of
  the JAX package plus the ones in `EXTRA` and `PORT_ONLY`: the JAX package
  leaves Profile 2's encode core, its copy back and its per-frame pack
  untimed, times the lossy profiles' uploads as part of `enc:core` /
  `dec:core` where the port opens `enc:h2d` / `dec:h2d` inside them, and
  records `enc:pack` only when a
  copy-back slice completes a frame, where the port times its one pack
  pass; Profile 2's decode ends in the port's device overlap-add
  (`dec:d2h`, `dec:host-conv`) where the JAX package fetches frames and
  overlaps on the host (`dec:overlap`);
* counts are equal where both record a stage, but for `enc:pack` (above)
  and the 48-bit encode's `enc:core`, which the JAX package enters again
  inside its deep-transform routing;
* the byte meters equal the `nbytes` of what `policy.to_device` /
  `policy.to_host` moved, and the upload meters equal the JAX package's
  where it meters the same arrays;
* streams and PCM are identical with and without a timer, and the module
  adds no synchronisation;
* each stage that opens inside another (`CHILDREN`) lies within it, no
  stage opens inside one of its own name (a `StageTimer` sums walls by
  name), and a Profile 1 decode leaves no more than its run loop's
  bookkeeping outside every stage.
"""

import contextlib
import inspect
import re
import sys
import time

import numpy as np
import pytest
import torch

import chip_smoke
import frad_python_tpu_torch as ft
from frad_python_tpu.parallel import pipeline as jpipeline
from frad_python_tpu.utils.tracing import StageTimer as JStageTimer
from frad_python_tpu_torch.ops import policy as tpolicy
from frad_python_tpu_torch.parallel import pipeline as tpipeline
from frad_python_tpu_torch.utils.tracing import StageTimer

STEREO = chip_smoke.make_audio(0.5, 44100, 2)
MONO = chip_smoke.make_audio(0.5, 44100, 1)
F32 = {"compute_dtype": "float32"}

#: name: (pcm, (profile, srate, bits, frame size), encode options, decode options)
CASES = {
    "p1_i16": (STEREO, (1, 44100, 16, 2048), dict(F32, i16_upload=True),
               dict(F32, i16_transfer=True)),
    "p1_f64": (STEREO, (1, 44100, 16, 2048), {"compute_dtype": "float64"},
               {"compute_dtype": "float64"}),
    "p1_ecc": (STEREO, (1, 44100, 16, 2048), dict(F32, enable_ecc=True),
               dict(F32, fix_error=True)),
    "p2": (STEREO, (2, 44100, 16, 2048), F32, F32),
    "p0_24": (STEREO, (0, 44100, 24, 2048), F32, F32),
    "p0_24_i24": (STEREO, (0, 44100, 24, 2048), dict(F32, i24_upload=True),
                  dict(F32, i24_transfer=True)),
    "p0_48": (STEREO, (0, 44100, 48, 2048), F32, F32),
    "p0_12": (STEREO, (0, 44100, 12, 2048), F32, F32),
    "p4": (MONO, (4, 44100, 16, 2048), F32, F32),
}
#: the port's own stage names, outside the JAX package's vocabulary: the
#: C++ payload passes' wrappers inside `enc:pack` / `dec:unpack`, the framing
#: and unarmor passes' inside `enc:frame` / `dec:ecc`, the lossy
#: encode's native pass that casts the frames from the track into the
#: upload's buffer (inside `enc:core`, where the JAX package gathers them in
#: `enc:gather` and times the cast as part of its upload) and the numpy
#: route's cast, and `batch_decode`'s emit of the PCM (fragment heads, the
#: join of the runs), which the JAX package leaves untimed
PORT_ONLY = {"enc:pack-native", "dec:unpack-native", "enc:frame-native", "dec:unarmor-native",
             "enc:stage", "enc:host-conv", "dec:emit"}
#: stages the port records where the JAX package, for this call, records none
EXTRA = {
    "p1_i16": {"enc:pack", "enc:h2d", "dec:h2d"}, "p1_ecc": {"enc:pack", "enc:h2d", "dec:h2d"},
    "p1_f64": {"enc:pack", "enc:h2d", "dec:h2d"},
    "p2": {"enc:core", "enc:h2d", "enc:d2h", "enc:pack", "dec:h2d", "dec:d2h",
           "dec:host-conv"},
}
#: child stage: the stage it opens inside, in every call that records it
CHILDREN = {"enc:pack-native": "enc:pack", "dec:unpack-native": "dec:unpack",
            "enc:frame-native": "enc:frame", "dec:unarmor-native": "dec:ecc"}
#: the same in the lossy profiles, whose cores upload inside themselves (the
#: lossless fast paths time their uploads beside the core, as the JAX
#: package does)
LOSSY_CHILDREN = {"enc:stage": "enc:core", "enc:h2d": "enc:core", "dec:h2d": "dec:core"}
#: stages whose counts differ by design (see the module docstring)
COUNTS_DIFFER = {"enc:pack", "enc:core"}
#: calls whose upload the JAX package meters from the same arrays
SAME_UPLOAD = ("p1_i16", "p1_f64", "p1_ecc", "p0_24", "p0_24_i24", "p0_12")


def jax_stage_names() -> set:
    """Every stage name in the JAX pipeline's source."""
    src = inspect.getsource(jpipeline)
    names = set(re.findall(r'_stage\("([a-z0-9:\-]+)"\)', src))
    for suffix in re.findall(r'_stage\(f"\{stage_prefix\}:([a-z0-9\-]+)"\)', src):
        names |= {f"enc:{suffix}", f"dec:{suffix}"}
    return names


class Intervals:
    """A stage timer that keeps each stage's (name, start, end), as the
    benchmark's recorder does."""

    def __init__(self) -> None:
        self.items: list[tuple[str, float, float]] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.items.append((name, t0, time.perf_counter()))

    def add_bytes(self, direction: str, n: int) -> None:
        pass


def run_port(case: str, timer=StageTimer):
    """(stream, encode timer, pcm, decode timer) of the port with a timer set."""
    x, args, ekw, dkw = CASES[case]
    try:
        tpipeline.STAGES = enc = timer()
        stream = ft.batch_encode(x, *args, device="cpu", **ekw)
        tpipeline.STAGES = dec = timer()
        pcm, _ = ft.batch_decode(stream, device="cpu", **dkw)
    finally:
        tpipeline.STAGES = None
    return stream, enc, pcm, dec


def run_jax(case: str):
    x, args, ekw, dkw = CASES[case]
    try:
        jpipeline.STAGES = enc = JStageTimer()
        stream = jpipeline.batch_encode(x, *args, **ekw)
        jpipeline.STAGES = dec = JStageTimer()
        jpipeline.batch_decode(stream, **dkw)
    finally:
        jpipeline.STAGES = None
    return enc, dec


def test_stages_default_is_off_and_costs_a_null_context():
    assert tpipeline.STAGES is None
    assert tpipeline._stage("enc:core") is tpipeline._stage("dec:core")   # one shared nullcontext
    tpipeline._meter("h2d", 10)                                           # no timer: no-op
    assert "synchronize" not in inspect.getsource(tpipeline)


@pytest.mark.parametrize("case", list(CASES))
def test_stage_names_and_counts_against_jax(case):
    _, enc, _, dec = run_port(case)
    jenc, jdec = run_jax(case)
    vocabulary = jax_stage_names()
    for got, want in ((enc, jenc), (dec, jdec)):
        assert got.counts and set(got.counts) <= vocabulary | PORT_ONLY
        assert set(got.counts) <= set(want.counts) | EXTRA.get(case, set()) | PORT_ONLY, \
            (dict(got.counts), dict(want.counts))
        for name in set(got.counts) & set(want.counts) - COUNTS_DIFFER:
            assert got.counts[name] == want.counts[name], name
        assert set(got.totals) == set(got.counts) and all(t >= 0 for t in got.totals.values())
    if case in SAME_UPLOAD:
        assert enc.bytes["h2d"] == jenc.bytes["h2d"] and dec.bytes["h2d"] == jdec.bytes["h2d"]
        assert dec.bytes["d2h"] == jdec.bytes["d2h"]


@pytest.mark.parametrize("case", list(CASES))
def test_byte_meters_equal_the_arrays_nbytes(case, monkeypatch):
    moved = {"h2d": 0, "d2h": 0}
    to_device, to_host = tpolicy.to_device, tpolicy.to_host

    def up(arr, device):
        moved["h2d"] += arr.nbytes
        return to_device(arr, device)

    def down(*tensors):
        outs = to_host(*tensors)
        moved["d2h"] += sum(o.nbytes for o in outs)
        return outs

    monkeypatch.setattr(tpolicy, "to_device", up)
    monkeypatch.setattr(tpolicy, "to_host", down)
    _, enc, _, dec = run_port(case)
    assert enc.bytes.get("h2d", 0) + dec.bytes.get("h2d", 0) == moved["h2d"]
    assert enc.bytes.get("d2h", 0) + dec.bytes.get("d2h", 0) == moved["d2h"]
    if case != "p4":                          # profile 4 touches no device
        assert moved["h2d"] > 0 and moved["d2h"] > 0
    assert "link h2d" in enc.summary() or case == "p4"


@pytest.mark.parametrize("case", list(CASES))
def test_output_is_the_same_with_and_without_a_timer(case):
    x, args, ekw, dkw = CASES[case]
    stream, _, pcm, _ = run_port(case)
    assert tpipeline.STAGES is None
    assert ft.batch_encode(x, *args, device="cpu", **ekw) == stream
    np.testing.assert_array_equal(ft.batch_decode(stream, device="cpu", **dkw)[0], pcm)


@pytest.mark.parametrize("case", ["p1_i16", "p1_f64", "p1_ecc", "p2"])
def test_lossy_encode_stages_its_frames_once(case, monkeypatch):
    """With the native module every lossy encode call (the uniform run and
    the tail frame) stages its frames in one `enc:stage` pass and records
    no `enc:gather` or `enc:host-conv`; the numpy route keeps those two and
    records no `enc:stage`. The streams are the same either way."""
    x, args, ekw, _ = CASES[case]
    streams = []
    for numpy_route in (False, True):
        if numpy_route:
            monkeypatch.setenv("FRAD_TORCH_NO_NATIVE", "1")
        try:
            tpipeline.STAGES = timer = StageTimer()
            streams.append(ft.batch_encode(x, *args, device="cpu", **ekw))
        finally:
            tpipeline.STAGES = None
        staged = {n: timer.counts.get(n, 0) for n in ("enc:stage", "enc:gather", "enc:host-conv")}
        calls = timer.counts["enc:core"]
        assert calls == 2, dict(timer.counts)                      # the uniform run, the tail
        want = ({"enc:stage": 0, "enc:gather": calls, "enc:host-conv": calls} if numpy_route
                else {"enc:stage": calls, "enc:gather": 0, "enc:host-conv": 0})
        assert staged == want, dict(timer.counts)
    assert streams[0] == streams[1]


@pytest.mark.parametrize("profile", [1, 2])
def test_engines_add_to_the_timer(profile):
    """The push engines run the pipeline's calls, so their stages land in
    the same timer: one `enc:core` per micro-batch, one `dec:core` per run."""
    raw = chip_smoke.to_s16le(STEREO)
    enc = ft.Encoder(1, 44100, 2, 16, 2048, "s16le", device="cpu")
    enc.set_overlap_ratio(16)
    enc.load_state_dict(dict(enc.state_dict(), profile=profile))
    try:
        tpipeline.STAGES = timer = StageTimer()
        stream = b"".join(enc.process(raw[i:i + 32768]).buf
                          for i in range(0, len(raw), 32768)) + enc.flush().buf
        n_enc = timer.counts["enc:core"]
        dec = ft.Decoder(device=torch.device("cpu"))
        pcm = [dec.process(stream[i:i + 32768]).pcm for i in range(0, len(stream), 32768)]
        pcm.append(dec.flush().pcm)
    finally:
        tpipeline.STAGES = None
    assert n_enc >= 2 and timer.counts["enc:frame"] == n_enc
    assert timer.counts["dec:core"] >= 1 and timer.counts["dec:unpack"] == timer.counts["dec:core"]
    assert timer.bytes["h2d"] > 0 and timer.bytes["d2h"] > 0
    assert sum(len(p) for p in pcm) >= len(STEREO)


@pytest.mark.parametrize("case", list(CASES))
def test_child_stages_lie_inside_their_parents(case):
    _, enc, _, dec = run_port(case, Intervals)
    lossy = CASES[case][1][0] in (1, 2)
    children = {**CHILDREN, **(LOSSY_CHILDREN if lossy else {})}
    for timer in (enc, dec):
        for name in {n for n, _, _ in timer.items}:
            spans = sorted((a, b) for n, a, b in timer.items if n == name)
            assert all(a1 >= b0 for (_, b0), (a1, _) in zip(spans, spans[1:])), name
        for child, a, b in timer.items:
            if child in children:
                assert any(n == children[child] and p0 <= a and b <= p1
                           for n, p0, p1 in timer.items), (child, a, b)
    if case in ("p1_i16", "p1_ecc"):
        names = {n for t in (enc, dec) for n, _, _ in t.items}
        armored = {"dec:unarmor-native"} if case == "p1_ecc" else set()
        assert set(children) - {"dec:unarmor-native"} | armored | {"dec:emit"} <= names
        assert not armored ^ (names & {"dec:unarmor-native"})


def test_decode_host_time_lies_in_stages(monkeypatch):
    """Outside every stage a Profile 1 decode keeps only its run loop's
    bookkeeping (run keys, slices of the header lists): under 3% of the
    call's wall in the best of five calls (the best, so that a worker of a
    loaded test machine descheduled between two stages does not count), on
    a 10 s clip, whose walls the fixed cost of a call does not set. And
    every join of the PCM and every fragment head lies inside `dec:emit`:
    on the CPU the join is too small a share for the 3% alone to see it."""
    _, args, ekw, dkw = CASES["p1_i16"]
    x = chip_smoke.make_audio(10, 44100, 2)
    stream = ft.batch_encode(x, *args, device="cpu", **ekw)
    emits = []
    concatenate, frag_head = np.concatenate, tpipeline._frag_head

    def timed(fn, caller=None):
        def call(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if caller is None or sys._getframe(1).f_code.co_name == caller:
                emits.append((t0, time.perf_counter()))
            return out
        return call

    monkeypatch.setattr(np, "concatenate", timed(concatenate, "batch_decode"))
    monkeypatch.setattr(tpipeline, "_frag_head", timed(frag_head))
    shares = []
    for _ in range(5):
        emits.clear()
        try:
            tpipeline.STAGES = timer = Intervals()
            t0 = time.perf_counter()
            ft.batch_decode(stream, device="cpu", **dkw)
            t1 = time.perf_counter()
        finally:
            tpipeline.STAGES = None
        assert emits and all(any(n == "dec:emit" and a <= e0 and e1 <= b
                                 for n, a, b in timer.items) for e0, e1 in emits), emits
        edges = sorted((a, b) for _, a, b in timer.items)
        covered, end = 0.0, t0
        for a, b in edges:
            covered += max(0.0, b - max(a, end))
            end = max(end, b)
        shares.append(1.0 - covered / (t1 - t0))
    assert min(shares) < 0.03, shares
