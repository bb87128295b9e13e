"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `frad_python_tpu_torch/csrc/` and its
C++ host module from `frad_python_tpu_torch/native/`, holds each kernel
against its plain PyTorch version at the main path's shapes, then drives
the Profile 1 main path (44.1 kHz stereo, 16-bit, 2048-sample frames,
overlap ratio 16) end to end on the card through `batch_encode` /
`batch_decode`, decodes the card's stream again on the CPU for
comparison, and drives the same track with ECC armor at (96, 24) through
damage, `batch_repair` and an error-correcting `batch_decode`. Then the
streaming phase feeds the track as s16le bytes through the push engines:
`Encoder` in 32 KiB pushes and in one deep push, `Decoder` in 32 KiB
pushes and in `exact` mode, and the (96, 24) stream, damaged, through
`Repairer` and an error-correcting `Decoder`, with the kernels held
against their plain versions at the streaming shapes first. Last, the
lossless phase: `trunc_pack` and `trunc_unpack` held byte for byte against
their plain versions at its shapes and on the truncation edges, then
`p0_stereo_44k1` (profile 0, 24-bit, the float32 fast path, and its int24
transfer variant, the card's stream decoded again on the CPU),
`p4_mono_44k1` (profile 4, 16-bit: the card's stream equals the CPU's),
`p0_stereo_48b` and `p0_stereo_64b` (the float64 FFT form on the card
against the CPU), `hires_96k_8ch` (96 kHz, 8 channels, 8192-sample frames,
cut to 10 s), Profile 1 at 8192-sample frames (the DCT GEMM cut along its
contraction) and at 16384 (the FFT form), and the `p0_stereo_44k1` track
as s32le bytes through `Encoder` and `Decoder`. Then the Profile 2 phase:
`tns_iir` and `tns_levinson` held bit for bit against their plain versions
at the batch and the streaming shapes, float32 and float64, with the
float64 and no-divisor forms of `power_quant` and the float64 form of
`overlap_add` (the phase fails if one of its runs launches a kernel at a
shape, dtype or option that was not held so); the track as profile 2 through `batch_encode` /
`batch_decode` (the card's stream decoded again on the CPU) and through
`Decoder` in 32 KiB pushes; and 5 s of it as profiles 1 and 2 at
`compute_dtype="float64"`. `egr_pack` and `dequant` are held against
their plain versions first, at every shape, dtype and option that any of
these runs launches them at (a tally over all the runs fails the script on
a form that was not held). Last, the command-line phase: the track as an
s16le file through `frad_python_tpu_torch.app.main` on the card: `encode`
(the file must be the metadata header plus `batch_encode`'s bytes),
`decode`, `--no-turbo` through the engines, profile 0 at 24 bits, `repair`
of a damaged armored file, the `meta` actions, and one
`python3 -m frad_python_tpu_torch encode` subprocess.
Every phase prints one line; any failure exits non-zero. The
second-to-last line is a JSON object with one entry per kernel, the last
line `{"ok": true, "device": {...}}`. Needs a CUDA device, nvcc and g++,
and refuses to run with FRAD_TORCH_NO_NATIVE set; imports neither jax
nor the JAX package.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

#: SNR floor of the 30 s main-path run. The JAX package's float32 path
#: (batch_encode(..., compute_dtype="float32", i16_upload=True) ->
#: batch_decode(..., compute_dtype="float32", i16_transfer=True)) reaches
#: 17.224032936 dB on this content on the CPU
#: (tests/test_torch_slice.py::test_chip_smoke_snr_floor measures it);
#: the floor is that minus 0.1 dB.
SNR_FLOOR_DB = 17.124

#: the card's decode against the CPU's decode of the same stream: the
#: IDCT GEMM sums in another order on each, so an int16 sample may round
#: one step the other way; two steps bound it
CARD_VS_CPU_MAX_ABS = 2.0 / 32768.0

SECONDS, SRATE, CHANNELS, BITS, FSIZE = 30.0, 44100, 2, 16, 2048
#: Profile 2 on the main path's geometry. SNR floor: the JAX package's
#: float32 Profile 2 SNR on the 30 s content on the CPU, P2_JAX_SNR_DB,
#: minus 0.1 dB (tests/test_torch_p2.py::test_chip_smoke_p2_snr_floors
#: measures it, and the float64 ones)
P2_JAX_SNR_DB = 17.0244
P2_SNR_FLOOR_DB = 16.924
#: profiles 1 and 2 at compute_dtype="float64" over F64_SECONDS of the
#: content: the JAX package's float64 SNR there minus 0.1 dB
F64_SECONDS = 5.0
F64_JAX_SNR_DB = {1: 17.1241, 2: 16.9243}
F64_SNR_FLOOR_DB = {1: 17.024, 2: 16.824}
#: float64 decodes of one stream on the card and on the CPU (cuFFT against
#: the CPU's FFT, the last bits of f64 through the TNS filter's gain)
F64_LOSSY_CARD_VS_CPU_MAX_ABS = 1e-9
#: the float32 Profile 2 decode of one stream on the card and on the CPU:
#: powf and the GEMMs differ in the last ulps on each, and the TNS
#: synthesis filter amplifies that before the IDCT (1.5e-6 measured on an
#: H100 on this content)
P2_CARD_VS_CPU_MAX_ABS = 1e-5
#: the TNS kernels' shapes [lanes = frames * channels, samples]. float32:
#: the 30 s batch decode (689 frames), its encode's 688 uniform frames and
#: its tail frame, and the engines' micro-batches of 8, 4, 2 and 1 frames.
#: float64: the first and the micro-batch of 4 again, then the F64_SECONDS
#: track's 114 uniform frames and its tail frame, padded to 1792 samples
TNS_SHAPES = {"float32": ((1378, 2048), (1376, 2048), (16, 2048), (8, 2048), (4, 2048),
                          (2, 2048)),
              "float64": ((1378, 2048), (8, 2048), (228, 2048), (2, 1792))}
#: power_quant's forms on the Profile 2 and float64 paths, (dtype, with a
#: divisor, shapes): Profile 2 has no divisor, Profile 1 at float64 has one
P2_POWER_QUANT_FORMS = (
    ("float32", False, ((1376, 2048), (8, 2048), (4, 2048), (2, 2048))),
    ("float64", False, ((1376, 2048), (228, 2048), (2, 1792))),
    ("float64", True, ((1376, 2048), (228, 2048), (2, 1792))))
#: overlap_add's forms there, (dtype, [B, C, N], olap, int16 emit): float64
#: at the main path's shape and at the F64_SECONDS track's two decode runs,
#: float32 at the Decoder's micro-batches of 4 and 8 frames (2 and 256 are
#: held in the streaming phase)
P2_OVERLAP_FORMS = (
    ("float64", (689, 2, 2048), 128, False), ("float64", (689, 2, 2048), 128, True),
    ("float64", (114, 2, 2048), 128, False), ("float64", (1, 2, 1792), 112, False),
    ("float32", (4, 2, 2048), 128, False), ("float32", (8, 2, 2048), 128, False))
#: the card's memory rate and float32 / float64 peak (NVIDIA H100 SXM data
#: sheet), for each kernel's bound
HBM_BYTES_PER_S = 3.35e12
# the data sheet gives no rate for 32-bit integer operations outside the
# tensor cores: the float32 rate of the same units stands in as their ceiling
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12, "int32": 67e12}

#: SNR floor of the lossless p0_stereo_44k1 run (24-bit, float32 fast
#: path): the JAX package's float32 SNR on this content, 97.5471 dB on the
#: CPU (its i24 transfer variant 97.5469 dB), minus 0.1 dB
#: (tests/test_torch_lossless.py::test_chip_smoke_lossless_snr_floor)
P0_BITS = 24
P0_SNR_FLOOR_DB = 97.447
#: Profile 1 at 16384-sample frames, through the FFT form: the JAX
#: package's float32 SNR here, 2.4436 dB on the CPU, minus 0.1 dB
#: (tests/test_torch_lossless.py::test_chip_smoke_profile1_16384_snr_floor)
P1_LONG_FSIZE = 16384
P1_LONG_SNR_FLOOR_DB = 2.344
#: Profile 1 at 8192-sample frames, the DCT GEMM cut along K: the JAX
#: package's float32 SNR here, 7.7632 dB on the CPU, minus 0.1 dB
#: (tests/test_torch_lossless.py::test_chip_smoke_profile1_8192_snr_floor)
P1_MID_FSIZE = 8192
P1_MID_SNR_FLOOR_DB = 7.663
#: the float32 lossless decode of one stream on the card and on the CPU:
#: the IDCT GEMM sums in another order on each, a few float32 ulps of
#: |pcm| < 2
LOSSLESS_CARD_VS_CPU_MAX_ABS = 2e-6
#: the float64 decode of one stream on the card and on the CPU: cuFFT and
#: the CPU's FFT differ in the last bits of f64
F64_CARD_VS_CPU_MAX_ABS = 1e-12
#: the archival SNR bounds of the JAX package's tests
#: (tests/test_deep_depth.py:49)
DEEP_SNR_DB = {48: 195.0, 64: 250.0}
HIRES = dict(seconds=10.0, srate=96000, channels=8, bits=24, fsize=8192)
#: hires_96k_8ch's floor over its first HIRES_FLOOR_FRAMES frames (a
#: profile 0 frame is coded on its own): the JAX package's float32 SNR
#: there, 97.4934 dB on the CPU, minus 0.1 dB
#: (tests/test_torch_lossless.py::test_chip_smoke_hires_snr_floor)
HIRES_FLOOR_FRAMES = 16
HIRES_SNR_FLOOR_DB = 97.393
#: the lossless trunc kernels' shapes: the p0_stereo_44k1 run's uniform
#: frames and its 2040-sample tail frame, the streaming run's
#: micro-batches of 2, and the hires run's frames and 1536-sample tail
TRUNC_SHAPES = ((645, 2, 2048), (1, 2, 2040), (2, 2, 2048), (117, 8, 8192), (1, 8, 1536))
# the main path's shapes for 30 s: 688 uniform frames + a tail frame
# padded to 2048, encoded as two batches and decoded as one run
POWER_QUANT_SHAPE = (1376, 2048)         # R = uniform frames * channels, N bins
OVERLAP_SHAPE = (689, 2, 2048)           # IDCT output [B, C, N]
OLAP, CUT = 128, 1920
ECC_RATIO = (96, 24)
DEVICE = "cuda"
#: the kernels of the Profile 1 paths
P1_KERNELS = ("power_quant", "overlap_add", "egr_pack", "dequant")
#: the kernels of the Profile 2 paths
P2_KERNELS = ("power_quant", "overlap_add", "dequant", "tns_iir", "tns_levinson")
# the streaming engines' shapes: one frame per call on the per-frame path,
# 2..256 frames per micro-batch; the decoder's micro-batches emit float32
STREAM_POWER_QUANT_SHAPES = ((2, 2048), (512, 2048))
STREAM_OVERLAP_CASES = ((2, OLAP, CUT), (256, OLAP, CUT), (256, 0, 2048))   # (B, olap, cut)
PUSH = 32768
#: the streaming decode against batch_decode(..., i16_transfer=False) of
#: the same stream: other batch sizes reach the IDCT GEMM, so float32
#: sums differ by a few ulps of |pcm| < 2
STREAM_VS_BATCH_MAX_ABS = 2e-6


#: egr_pack's forms, (rows, symbols a row): the batch encode's 688 uniform
#: frames (a tail frame is one row and takes the host coder) and the 1 s
#: warm-up's 22, the engines' micro-batches (2 and 4 frames in 32 KiB
#: pushes; 256, 128, 32 and 16 in one deep push or an 8 MiB read), and
#: Profile 1's uniform frames at 8192 and 16384 samples with their
#: warm-ups' 4; max_words is symbols * 12 // 32
EGR_FORMS = ((688, 4096), (2, 4096), (4, 4096), (16, 4096), (22, 4096), (32, 4096),
             (128, 4096), (256, 4096), (172, 16384), (4, 16384), (86, 32768), (4, 32768))
#: dequant's forms, (symbol dtype, [B, N, C], with a divisor): Profile 1
#: has a divisor, Profile 2 none. int16 symbols in batches, runs and
#: micro-batches (689 frames, the warm-ups' 23, runs of 1, 2, 4 and 8; at
#: 8192 samples 172 and the 6144-sample tail frame, at 16384 samples 86,
#: and the warm-ups' 4 and 5), float32 on the per-frame path (one frame),
#: float64 at compute_dtype="float64" (the F64_SECONDS track's 114 uniform
#: frames and its tail frame padded to 1792 samples)
DEQUANT_FORMS = (
    ("int16", (689, 2048, 2), True), ("int16", (1, 2048, 2), True),
    ("int16", (2, 2048, 2), True), ("int16", (4, 2048, 2), True),
    ("int16", (8, 2048, 2), True), ("int16", (23, 2048, 2), True),
    ("float32", (1, 2048, 2), True), ("int16", (172, 8192, 2), True),
    ("int16", (1, 6144, 2), True), ("int16", (4, 8192, 2), True),
    ("int16", (86, 16384, 2), True), ("int16", (5, 16384, 2), True),
    ("int16", (689, 2048, 2), False), ("int16", (2, 2048, 2), False),
    ("int16", (4, 2048, 2), False), ("int16", (8, 2048, 2), False),
    ("int16", (23, 2048, 2), False), ("float32", (1, 2048, 2), False),
    ("float64", (114, 2048, 2), True), ("float64", (1, 1792, 2), True),
    ("float64", (114, 2048, 2), False), ("float64", (1, 1792, 2), False))
#: the command-line phase: the track as an s16le file. Profile 1 at the
#: CLI's default loss level, decoded to s16le: the JAX package's float32
#: SNR there, 17.6704 dB on the CPU, minus 0.1 dB; profile 0 at 24 bits
#: decoded to f64be, against the file's samples: 97.5227 dB minus 0.1 dB
#: (tests/test_torch_app_floors.py measures both)
CLI_P1_SNR_FLOOR_DB = 17.570
CLI_P0_SNR_FLOOR_DB = 97.423

#: every form (`kernel_form`) at which a kernel was held against its plain
#: version in this run
CHECKED: set[tuple] = set()


def kernel_form(name: str, *args) -> tuple:
    """What tells one launch of a kernel from another of another form: the
    wrapper's name, its first tensor's shape and dtype, and for power_quant
    and dequant whether it has a divisor, for overlap_add the overlap, cut
    and emit, for egr_pack max_words."""
    x = args[0]
    form = (name, tuple(x.shape), str(x.dtype).removeprefix("torch."))
    if name == "power_quant":
        return form + (args[1] is not None,)
    if name == "overlap_add":
        return form + (int(args[1].numel()), int(args[2]), bool(args[3]))
    if name == "egr_pack":
        return form + (int(args[1]),)
    if name == "dequant":
        return form + (args[1] is not None,)
    return form


def held(kernels, name: str, *args):
    """(kernel's result, plain version's result) of `name` on `args`, both
    as tuples of tensors; the form goes into CHECKED (the caller raises
    where the two differ)."""
    got = getattr(kernels, name)(*args)
    want = getattr(kernels, name + "_plain")(*args)
    CHECKED.add(kernel_form(name, *args))
    return tuple(r if isinstance(r, tuple) else (r,) for r in (got, want))


class FormTally:
    """The forms at which the port's modules call the kernels' wrappers,
    counted over its `with` blocks by wrapping the names the modules hold
    them under."""

    def __init__(self, only: tuple[str, ...] | None = None, device_type: str = "cuda"):
        """`only`: the wrappers to count (None: all). `device_type`: where
        a call's first tensor must lie to count: "cuda" counts launches and
        leaves the plain versions' calls out, "cpu" serves the CPU tests."""
        from frad_python_tpu_torch.models import batch
        from frad_python_tpu_torch.ops import tns
        from frad_python_tpu_torch.parallel import pipeline

        self.targets = [(mod, name) for mod, name in (
            (batch, "power_quant"), (batch, "overlap_add"), (tns, "tns_iir"),
            (tns, "tns_levinson"), (pipeline, "egr_pack"), (batch, "dequant"))
            if only is None or name in only]
        self.device_type = device_type
        self.seen: dict[tuple, int] = {}
        #: words of the compacted streams that egr_pack returned
        self.egr_words = 0

    def __enter__(self):
        self.saved = [getattr(mod, name) for mod, name in self.targets]

        def wrap(fn, name):
            def counted(*args):
                out = fn(*args)
                if args[0].device.type == self.device_type:
                    form = kernel_form(name, *args)
                    self.seen[form] = self.seen.get(form, 0) + 1
                    if name == "egr_pack":
                        self.egr_words += int(out[0].numel())
                return out
            return counted

        for (mod, name), fn in zip(self.targets, self.saved):
            setattr(mod, name, wrap(fn, name))
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in zip(self.targets, self.saved):
            setattr(mod, name, fn)

    def unchecked(self) -> list[tuple]:
        """The forms launched in the block that no check of this run held
        against a plain version."""
        return sorted((f for f in self.seen if f not in CHECKED), key=str)

    def require_held(self, what: str) -> None:
        if self.unchecked():
            raise AssertionError(f"{what} launched kernels at forms that no check held "
                                 f"against a plain version: {self.unchecked()}")


def make_audio(seconds: float, srate: int, ch: int) -> np.ndarray:
    """The benchmark's content: four harmonics of 220 Hz plus noise
    (a copy of bench.make_audio)."""
    rng = np.random.default_rng(0)
    t = np.arange(int(seconds * srate)) / srate
    sig = sum(0.3 / (i + 1) * np.sin(2 * np.pi * (220 * (i + 1)) * t[:, None] + i)
              for i in range(4)) * np.ones((1, ch))
    return sig + 0.01 * rng.standard_normal((len(t), ch))


def snr_db(ref: np.ndarray, out: np.ndarray) -> float:
    m = len(ref)
    err = out[:m] - ref
    return float(10 * np.log10(np.sum(ref ** 2) / np.sum(err ** 2)))


def cuda_ms(torch, fn, reps: int = 11, inner: int = 20) -> float:
    """Median over `reps` of the mean device time of `inner` calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound(nbytes: float, flops: float, dtype: str = "float32") -> tuple[float, str]:
    """(least time in ms the card could take, what bounds it): the bytes
    the function must move (each input read once, each output written
    once) over the memory rate, or its operations over the peak rate of
    their type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def profiled_device_ms(torch, calls: dict) -> dict:
    """Device time in ms of each hand kernel from ONE `torch.profiler`
    call that launches every entry of `calls` ({kernel function name:
    thunk}) once; None where the trace shows no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fn in calls.values():
            fn()
        torch.cuda.synchronize()
    out = {}
    for name in calls:
        us = [max(getattr(e, a, 0.0) or 0.0 for a in (
                  "self_device_time_total", "device_time_total",
                  "self_cuda_time_total", "cuda_time_total"))
              for e in prof.key_averages() if name in e.key]
        out[name] = sum(us) / 1e3 if us and sum(us) > 0 else None
    return out


def check_native_pack(native) -> None:
    """p1_pack_batch against the Python payload layout on main-path-sized
    frames: its DEFLATE must equal this machine's zlib.compress byte for
    byte."""
    import struct
    import zlib

    import torch

    from frad_python_tpu_torch.ops import bitpack, golomb

    rng = np.random.default_rng(7)
    fq = np.rint(rng.laplace(0, 1, (16, FSIZE * CHANNELS))
                 * np.linspace(0.5, 40, 16)[:, None]).astype(np.int32)
    tq = rng.integers(0, 60, (16, 27 * CHANNELS))
    words, nbits, ks, ovf = (t.numpy() for t in bitpack.egr_pack_frames(
        torch.from_numpy(fq), FSIZE * CHANNELS * 12 // 32))
    words = words.astype(np.uint32)
    got = native.p1_pack_batch(words, nbits, ks, ovf, tq)
    for i, p in enumerate(got):
        thres = golomb.encode(tq[i])
        frad = (struct.pack(">I", len(thres)) + thres
                + bitpack.words_to_stream(words[i], nbits[i], ks[i]))
        if ovf[i] or p != zlib.compress(frad, wbits=-15):
            raise AssertionError(f"native p1_pack_batch differs from zlib.compress at frame {i}")


def check_stream_shapes(torch, kernels, crossfade_window, dev) -> tuple[float, float]:
    """Each kernel against its plain version at the streaming engines'
    shapes, exactly; returns (power_quant max |d|, overlap_add max |d|)."""
    rng = np.random.default_rng(4321)
    pq_err = oa_err = 0.0
    for shape in STREAM_POWER_QUANT_SHAPES:
        freqs = (rng.standard_normal(shape) * 1e-2).astype(np.float32)
        div = (np.exp(rng.standard_normal(shape) * 2.0) * 0.1).astype(np.float32)
        div[:, -128:] = 0.0
        f_d, d_d = torch.from_numpy(freqs).to(dev), torch.from_numpy(div).to(dev)
        (got,), (want,) = held(kernels, "power_quant", f_d, d_d, 2.0 ** 15)
        torch.cuda.synchronize()
        err = float((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        pq_err = max(pq_err, err)
        if not torch.equal(got, want):
            raise AssertionError(f"power_quant {shape} differs from its plain version: "
                                 f"max |d| {err}")
        ms = cuda_ms(torch, lambda: kernels.power_quant(f_d, d_d, 2.0 ** 15))
        plain = cuda_ms(torch, lambda: kernels.power_quant_plain(f_d, d_d, 2.0 ** 15))
        print(f"kernel power_quant {shape}: equal, max|d| {err}, {ms:.4f} ms vs plain "
              f"{plain:.4f} ms")
    for b, olap, cut in STREAM_OVERLAP_CASES:
        pcm_k = torch.from_numpy(
            rng.standard_normal((b, CHANNELS, FSIZE)).astype(np.float32) * 0.3).to(dev)
        w = crossfade_window(olap, dev)
        (out_k, frag_k), (out_p, frag_p) = held(kernels, "overlap_add", pcm_k, w, cut, False)
        torch.cuda.synchronize()
        err = float((out_k - out_p).abs().max())
        if olap:
            err = max(err, float((frag_k - frag_p).abs().max()))
        oa_err = max(oa_err, err)
        if not (torch.equal(out_k, out_p) and torch.equal(frag_k, frag_p)):
            raise AssertionError(f"overlap_add B={b} olap={olap} differs from its plain "
                                 f"version: max |d| {err}")
        ms = cuda_ms(torch, lambda: kernels.overlap_add(pcm_k, w, cut, False))
        plain = cuda_ms(torch, lambda: kernels.overlap_add_plain(pcm_k, w, cut, False))
        print(f"kernel overlap_add ({b}, {CHANNELS}, {FSIZE}) olap={olap} cut={cut} f32 emit: "
              f"equal, max|d| {err}, {ms:.4f} ms vs plain {plain:.4f} ms")
    return pq_err, oa_err


def to_s16le(pcm: np.ndarray) -> bytes:
    """PCM as s16le bytes (the same rounding as batch_encode's i16 upload)."""
    return np.clip(np.rint(pcm * 32768.0), -32768, 32767).astype("<i2").tobytes()


class FrameTally:
    """Frames per call of the engines' batch and per-frame routes, counted
    by wrapping the module functions they call for the `with` block.
    `profile` is the per-frame codec module; a micro-batch span of `n`
    samples holds (n - olap) // hop frames."""

    def __init__(self, pipeline, profile, hop: int = CUT, olap: int = OLAP):
        self.targets = [(pipeline, "batch_encode", "enc_batch"),
                        (pipeline, "_decode_run", "dec_batch"),
                        (profile, "analogue", "enc_frame"),
                        (profile, "digital", "dec_frame")]
        self.hop, self.olap = hop, olap
        self.seen: dict[str, dict[int, int]] = {}

    def __enter__(self):
        self.saved = [getattr(mod, name) for mod, name, _ in self.targets]
        self.seen = {key: {} for _, _, key in self.targets}

        def wrap(fn, key):
            def counted(arg, *args, **kwargs):
                # frames: span length on the frame grid, or header count
                k = ((len(arg) - self.olap) // self.hop if key == "enc_batch"
                     else len(arg) if key == "dec_batch" else 1)
                self.seen[key][k] = self.seen[key].get(k, 0) + 1
                return fn(arg, *args, **kwargs)
            return counted

        for (mod, name, key), fn in zip(self.targets, self.saved):
            setattr(mod, name, wrap(fn, key))
        return self

    def __exit__(self, *exc):
        for (mod, name, _), fn in zip(self.targets, self.saved):
            setattr(mod, name, fn)

    def used(self) -> dict[str, dict[int, int]]:
        """{route: {frames per call: calls}} of the routes that ran."""
        return {key: dict(sorted(v.items())) for key, v in self.seen.items() if v}


def stream_encode(ft, torch, raw: bytes, push: int, dev, ecc=None) -> bytes:
    enc = ft.Encoder(1, SRATE, CHANNELS, BITS, FSIZE, "s16le", device=dev)
    enc.set_overlap_ratio(16)
    if ecc:
        enc.set_ecc(True, ecc)
    out = [enc.process(raw[i:i + push]).buf for i in range(0, len(raw), push)]
    out.append(enc.flush().buf)
    torch.cuda.synchronize()
    return b"".join(out)


def to_s32le(pcm: np.ndarray) -> bytes:
    """PCM as s32le bytes (x2^31, rounded and clamped)."""
    return np.clip(np.rint(pcm * 2.0 ** 31), -2 ** 31, 2 ** 31 - 1).astype("<i4").tobytes()


def stream_encode_p0(ft, torch, raw: bytes, push: int, dev) -> bytes:
    """s32le bytes through a profile 0 `Encoder` (p0_stereo_44k1) in `push`-byte pushes."""
    enc = ft.Encoder(0, SRATE, CHANNELS, P0_BITS, FSIZE, "s32le", device=dev)
    out = [enc.process(raw[i:i + push]).buf for i in range(0, len(raw), push)]
    out.append(enc.flush().buf)
    torch.cuda.synchronize()
    return b"".join(out)


def stream_decode(ft, torch, stream: bytes, push: int, dev, **kw) -> tuple[np.ndarray, float]:
    """(decoded PCM, seconds to the first non-empty DecodeResult)."""
    dec = ft.Decoder(device=dev, **kw)
    parts = []
    first = None
    t0 = time.perf_counter()
    for i in range(0, len(stream), push):
        p = dec.process(stream[i:i + push]).pcm
        if p.size:
            if first is None:
                first = time.perf_counter() - t0
            parts.append(p)
    parts.append(dec.flush().pcm)
    torch.cuda.synchronize()
    return np.concatenate([p for p in parts if p.size]), first


def timed(torch, fn):
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def trunc_inputs(shape: tuple[int, int, int], seed: int) -> np.ndarray:
    """[B, C, N] float32 DCT-like output with the truncation edges in frame
    0 (the f16 range, rounding to inf from 65520, f16 and f32 subnormals,
    signed zeros) and a NaN in the last frame when there are several."""
    y = (np.random.default_rng(seed).standard_normal(shape) * 0.3).astype(np.float32)
    edges = [65504.0, 65519.99, 65520.0, -65520.0, 6e-8, -3e-8, 6.1e-5, -0.0, 0.0, 1e-40]
    y[0, 0, :len(edges)] = edges
    if shape[0] > 1:
        y[-1, -1, 5] = np.nan
    return y


def nan_words(torch, y, bits: int):
    """The payload words of trunc_pack(y, bits) that hold a NaN of y
    [B, C, N]: value t*C + c of frame b is word t*C + c at 16 and 32 bits,
    and one of the three words of its group of four at 24."""
    b = y.shape[0]
    nan = torch.isnan(y.transpose(1, 2).reshape(b, -1))
    if bits == 24:
        return nan.reshape(b, -1, 4).any(-1).repeat_interleave(3, dim=1)
    return nan


def check_trunc_kernels(torch, kernels, dev) -> dict:
    """trunc_pack and trunc_unpack against their plain versions on the card
    at TRUNC_SHAPES, every depth and byte order: every payload word equal
    but the one (16, 32 bits) or three (24 bits) that hold the NaN (its f16
    bits are the converter's own, and its frame leaves the fast path on its
    NaN max|x|), max|x| equal with the NaN in place, unpacked floats
    equal. Returns the max |d| and the CUDA-event times of kernel and plain
    at the p0_stereo_44k1 shape, with a call of each there (`thunks`)."""
    out = {"pack_err": 0.0, "unpack_err": 0.0}
    for si, shape in enumerate(TRUNC_SHAPES):
        b, c, n = shape
        y = torch.from_numpy(trunc_inputs(shape, 99 + si)).to(dev)
        for bits in (16, 24, 32):
            keep = ~nan_words(torch, y, bits)
            if int((~keep).sum()) != (0 if b == 1 else 3 if bits == 24 else 1):
                raise AssertionError(f"trunc check {shape}: NaN words {int((~keep).sum())}")
            for little in (False, True):
                w_k, m_k = kernels.trunc_pack(y, bits, little)
                w_p, m_p = kernels.trunc_pack_plain(y, bits, little)
                u_k = kernels.trunc_unpack(w_k, bits, little, n, c)
                u_p = kernels.trunc_unpack_plain(w_k, bits, little, n, c)
                torch.cuda.synchronize()
                d_w = float((w_k[keep].to(torch.int64) - w_p[keep].to(torch.int64)).abs().max())
                d_u = float((u_k - u_p).abs().max())
                out["pack_err"] = max(out["pack_err"], d_w)
                out["unpack_err"] = max(out["unpack_err"], d_u)
                if not (torch.equal(w_k[keep], w_p[keep])
                        and torch.equal(m_k.nan_to_num(-1.0), m_p.nan_to_num(-1.0))
                        and (b == 1 or bool(torch.isnan(m_k[-1])))):
                    raise AssertionError(f"trunc_pack {shape} bits={bits} little={little} "
                                         f"differs from its plain version: max |d| {d_w}")
                if not torch.equal(u_k, u_p):
                    raise AssertionError(f"trunc_unpack {shape} bits={bits} little={little} "
                                         f"differs from its plain version: max |d| {d_u}")
        if si == 0:
            w, _ = kernels.trunc_pack(y, P0_BITS, False)
            out["pack_ms"] = cuda_ms(torch, lambda: kernels.trunc_pack(y, P0_BITS, False))
            out["pack_plain_ms"] = cuda_ms(
                torch, lambda: kernels.trunc_pack_plain(y, P0_BITS, False))
            out["unpack_ms"] = cuda_ms(
                torch, lambda: kernels.trunc_unpack(w, P0_BITS, False, n, c))
            out["unpack_plain_ms"] = cuda_ms(
                torch, lambda: kernels.trunc_unpack_plain(w, P0_BITS, False, n, c))
            out["thunks"] = {
                "trunc_pack_kernel": lambda y=y: kernels.trunc_pack(y, P0_BITS, False),
                "trunc_unpack_kernel": lambda w=w, n=n, c=c: kernels.trunc_unpack(
                    w, P0_BITS, False, n, c)}
    print(f"kernels trunc_pack / trunc_unpack at {list(TRUNC_SHAPES)}, bits 16/24/32, both "
          f"byte orders: equal to plain (max|d| {out['pack_err']} / {out['unpack_err']}); "
          f"at {TRUNC_SHAPES[0]} {P0_BITS}-bit: trunc_pack {out['pack_ms']:.4f} ms vs plain "
          f"{out['pack_plain_ms']:.4f} ms, trunc_unpack {out['unpack_ms']:.4f} ms vs plain "
          f"{out['unpack_plain_ms']:.4f} ms")
    return out


def run_batch(ft, torch, name: str, pcm: np.ndarray, profile: int, srate: int, bits: int,
                 fsize: int, dev, **kw) -> tuple[bytes, np.ndarray, float, float]:
    """Warm-up on a cut of the same track with the same tail frame, then
    one timed batch_encode and batch_decode on the card. Returns (stream,
    decoded PCM, encode wall, decode wall); the decode holds every sample
    (Profile 1 pads the last frame)."""
    enc_kw = {k: v for k, v in kw.items() if k != "i24_transfer"}
    dec_kw = {k: v for k, v in kw.items() if k == "i24_transfer"}
    warm = pcm[: 4 * fsize + len(pcm) % fsize]
    ft.batch_decode(ft.batch_encode(warm, profile, srate, bits, fsize, device=dev, **enc_kw),
                    device=dev, **dec_kw)
    torch.cuda.synchronize()
    stream, t_enc = timed(torch, lambda: ft.batch_encode(pcm, profile, srate, bits, fsize,
                                                         device=dev, **enc_kw))
    (out, sr), t_dec = timed(torch, lambda: ft.batch_decode(stream, device=dev, **dec_kw))
    n_ok = len(out) == len(pcm) if profile in (0, 4) else len(out) >= len(pcm)
    if sr != srate or out.shape[1] != pcm.shape[1] or not n_ok or not np.isfinite(out).all():
        raise AssertionError(f"{name}: decoded {out.shape} at {sr} Hz, expected {pcm.shape} "
                             f"at {srate}, or not finite")
    return stream, np.asarray(out, dtype=np.float64), t_enc, t_dec


def lossless_walls(name: str, frames: int, t_enc: float, t_dec: float) -> str:
    return (f"{name}: {frames} frames, enc {frames / t_enc:.1f} frames/s ({t_enc:.4f} s), "
            f"dec {frames / t_dec:.1f} frames/s ({t_dec:.4f} s)")


def lossless_phase(ft, torch, kernels, native, dev) -> dict:
    """The lossless configurations on the card (see the module docstring).
    Returns the trunc kernels' checks and the launches of the
    p0_stereo_44k1 main run."""
    from frad_python_tpu_torch.models import profile0
    from frad_python_tpu_torch.ops.packing import DEPTHS
    from frad_python_tpu_torch.ops.pcm import to_f64
    from frad_python_tpu_torch.parallel import pipeline
    from frad_python_tpu_torch.parallel.pipeline import _parse_frames

    res = check_trunc_kernels(torch, kernels, dev)
    pcm = make_audio(SECONDS, SRATE, CHANNELS)
    n_frames = -(-len(pcm) // FSIZE)

    # p0_stereo_44k1: the float32 fast path, then its int24 transfer variant
    warm = pcm[: 4 * FSIZE + len(pcm) % FSIZE]
    ft.batch_decode(ft.batch_encode(warm, 0, SRATE, P0_BITS, FSIZE, device=dev), device=dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    native.reset_calls()
    stream, t_enc = timed(torch, lambda: ft.batch_encode(pcm, 0, SRATE, P0_BITS, FSIZE,
                                                         device=dev))
    (out, sr), t_dec = timed(torch, lambda: ft.batch_decode(stream, device=dev))
    res["launches"] = {k.__name__: k.launches for k in kernels.KERNELS}
    calls = {w.__name__: w.calls for w in native.WRAPPERS}
    headers, payloads, tail = _parse_frames(stream)
    if (len(headers), tail, {h.profile for h in headers}) != (n_frames, b"", {0}) \
            or {h.bit_depth_index for h in headers} != {DEPTHS.index(P0_BITS)}:
        raise AssertionError(f"p0_stereo_44k1: {len(headers)} frames of profiles "
                             f"{ {h.profile for h in headers} }, plan {n_frames}")
    if out.shape != pcm.shape or sr != SRATE or not np.isfinite(out).all():
        raise AssertionError(f"p0_stereo_44k1: decoded {out.shape} at {sr} Hz")
    snr = snr_db(pcm, out)
    if snr < P0_SNR_FLOOR_DB:
        raise AssertionError(f"p0_stereo_44k1 SNR {snr:.4f} dB below {P0_SNR_FLOOR_DB} dB")
    for k in ("trunc_pack", "trunc_unpack"):
        if res["launches"][k] <= 0:
            raise AssertionError(f"kernel {k} was not launched by the p0_stereo_44k1 path")
    for k in ("frame_pack_batch", "frame_parse_batch"):
        if calls[k] <= 0:
            raise AssertionError(f"native {k} was not called by the p0_stereo_44k1 path")
    out_cpu, _ = ft.batch_decode(stream, device="cpu")
    d_cpu = float(np.abs(out_cpu - out).max())
    if d_cpu > LOSSLESS_CARD_VS_CPU_MAX_ABS:
        raise AssertionError(f"p0_stereo_44k1 card vs CPU decode {d_cpu}")
    s24, out24, t_enc24, t_dec24 = run_batch(ft, torch, "p0_stereo_44k1 i24", pcm, 0, SRATE,
                                                P0_BITS, FSIZE, dev, i24_upload=True,
                                                i24_transfer=True)
    snr24 = snr_db(pcm, out24)
    if snr24 < P0_SNR_FLOOR_DB:
        raise AssertionError(f"p0_stereo_44k1 i24 SNR {snr24:.4f} dB below {P0_SNR_FLOOR_DB}")
    print(f"{lossless_walls('p0_stereo_44k1', n_frames, t_enc, t_dec)}, {len(stream)} bytes, "
          f"SNR {snr:.4f} dB (floor {P0_SNR_FLOOR_DB}), card vs cpu decode max|d| {d_cpu} "
          f"(tolerance {LOSSLESS_CARD_VS_CPU_MAX_ABS}); i24 upload/transfer: enc "
          f"{t_enc24:.4f} s, dec {t_dec24:.4f} s, SNR {snr24:.4f} dB; launches "
          f"{res['launches']}, native calls {calls}")

    # p4_mono_44k1: host work only, so the card's stream is the CPU's
    mono = make_audio(SECONDS, SRATE, 1)
    s4, out4, t_enc4, t_dec4 = run_batch(ft, torch, "p4_mono_44k1", mono, 4, SRATE, 16,
                                            FSIZE, dev)
    s4_cpu = ft.batch_encode(mono, 4, SRATE, 16, FSIZE, device="cpu")
    out4_cpu, _ = ft.batch_decode(s4_cpu, device="cpu")
    if s4 != s4_cpu or not np.array_equal(out4, out4_cpu) \
            or not np.array_equal(out4, mono.astype(np.float16).astype(np.float64)):
        raise AssertionError("p4_mono_44k1: the card's stream or decode differs from the CPU's "
                             "or from the f16 values of the input")
    print(f"{lossless_walls('p4_mono_44k1', n_frames, t_enc4, t_dec4)}, {len(s4)} bytes, "
          f"stream equal to the CPU's, decode equal to the CPU's and to the f16 input")

    # p0_stereo_48b / 64b: the float64 FFT form on the card
    for bits in (48, 64):
        s_d, out_d, t_e, t_d = run_batch(ft, torch, f"p0_stereo_{bits}b", pcm, 0, SRATE,
                                            bits, FSIZE, dev)
        s_cpu = ft.batch_encode(pcm, 0, SRATE, bits, FSIZE, device="cpu")
        _, p_card, _ = _parse_frames(s_d)
        _, p_cpu, _ = _parse_frames(s_cpu)
        differ = sum(a != b for a, b in zip(p_card, p_cpu))
        out_c, _ = ft.batch_decode(s_d, device="cpu")
        d = float(np.abs(out_c - out_d).max())
        snr_d = snr_db(pcm, out_d)
        if len(p_card) != len(p_cpu) or d > F64_CARD_VS_CPU_MAX_ABS or snr_d <= DEEP_SNR_DB[bits]:
            raise AssertionError(f"p0_stereo_{bits}b: {len(p_card)} vs {len(p_cpu)} frames, "
                                 f"card vs cpu decode {d}, SNR {snr_d:.2f} dB")
        print(f"{lossless_walls(f'p0_stereo_{bits}b', n_frames, t_e, t_d)}, SNR {snr_d:.2f} dB "
              f"(bound {DEEP_SNR_DB[bits]}), payloads differing from the CPU stream {differ} "
              f"of {len(p_card)}, card vs cpu decode max|d| {d} "
              f"(tolerance {F64_CARD_VS_CPU_MAX_ABS})")

    # hires_96k_8ch, cut to 10 s: N = 8192, the GEMM's largest matrix
    h = HIRES
    hi = make_audio(h["seconds"], h["srate"], h["channels"])
    kernels.reset_launches()
    s_h, out_h, t_eh, t_dh = run_batch(ft, torch, "hires_96k_8ch", hi, 0, h["srate"],
                                          h["bits"], h["fsize"], dev)
    l_h = {k.__name__: k.launches for k in kernels.KERNELS}
    out_hc, _ = ft.batch_decode(s_h, device="cpu")
    snr_h, snr_hc = snr_db(hi, out_h), snr_db(hi, out_hc)
    m = HIRES_FLOOR_FRAMES * h["fsize"]
    snr_hf = snr_db(hi[:m], out_h[:m])
    if snr_hf < HIRES_SNR_FLOOR_DB or snr_h < snr_hc - 0.1 \
            or min(l_h["trunc_pack"], l_h["trunc_unpack"]) <= 0:
        raise AssertionError(f"hires_96k_8ch: SNR {snr_hf:.4f} dB over the first "
                             f"{HIRES_FLOOR_FRAMES} frames (floor {HIRES_SNR_FLOOR_DB}), "
                             f"{snr_h:.4f} dB against the CPU decode's {snr_hc:.4f}, "
                             f"launches {l_h}")
    print(f"{lossless_walls('hires_96k_8ch (cut to 10 s)', -(-len(hi) // h['fsize']), t_eh, t_dh)}"
          f", SNR {snr_hf:.4f} dB over the first {HIRES_FLOOR_FRAMES} frames (floor "
          f"{HIRES_SNR_FLOOR_DB}), {snr_h:.4f} dB over all (CPU decode of the same stream "
          f"{snr_hc:.4f} dB), card vs cpu decode max|d| {float(np.abs(out_hc - out_h).max())}, "
          f"launches {l_h}")

    # Profile 1 above the main path's 2048 samples: at 8192 the DCT GEMM
    # cut along K, at 16384 the float32 FFT form; both kernels
    for fsize, floor in ((P1_MID_FSIZE, P1_MID_SNR_FLOOR_DB),
                         (P1_LONG_FSIZE, P1_LONG_SNR_FLOOR_DB)):
        frames_l, _ = pipeline.plan_frames(len(pcm), fsize, 16, True)
        pq_shape = (2 * (len(frames_l) - 1), fsize)
        res[f"p1_{fsize}"] = long_kernels(torch, kernels, dev, pq_shape,
                                          (len(frames_l), CHANNELS, fsize), fsize // 16)
        kernels.reset_launches()
        s_l, out_l, t_el, t_dl = run_batch(ft, torch, f"p1_{fsize}", pcm, 1, SRATE, BITS,
                                              fsize, dev, i16_upload=True)
        l_l = {k.__name__: k.launches for k in kernels.KERNELS}
        snr_l = snr_db(pcm, out_l)
        if snr_l < floor or min(l_l["power_quant"], l_l["overlap_add"]) <= 0:
            raise AssertionError(f"Profile 1 at {fsize}: SNR {snr_l:.4f} dB (floor {floor}), "
                                 f"launches {l_l}")
        print(f"{lossless_walls(f'p1 at {fsize} samples', len(frames_l), t_el, t_dl)}, "
              f"SNR {snr_l:.4f} dB (floor {floor}), launches {l_l}")

    # the p0_stereo_44k1 track as s32le bytes through the push engines
    raw = to_s32le(pcm)
    pcm32 = to_f64(np.frombuffer(raw, "<i4").reshape(-1, CHANNELS), np.dtype("<i4"))
    batch32 = ft.batch_encode(pcm32, 0, SRATE, P0_BITS, FSIZE, device=dev)
    warm_raw = raw[: (4 * FSIZE + 1000) * CHANNELS * 4]
    stream_decode(ft, torch, stream_encode_p0(ft, torch, warm_raw, PUSH, dev), PUSH, dev)
    kernels.reset_launches()
    with FrameTally(pipeline, profile0, hop=FSIZE, olap=0) as enc_t:
        s_s, t_se = timed(torch, lambda: stream_encode_p0(ft, torch, raw, PUSH, dev))
    with FrameTally(pipeline, profile0, hop=FSIZE, olap=0) as dec_t:
        (out_s, ttfa), t_sd = timed(torch, lambda: stream_decode(ft, torch, s_s, PUSH, dev))
    l_s = {k.__name__: k.launches for k in kernels.KERNELS}
    _, p_s, tail_s = _parse_frames(s_s)
    _, p_b, _ = _parse_frames(batch32)
    differ = sum(a != b for a, b in zip(p_s, p_b))
    out_b, _ = ft.batch_decode(s_s, device=dev)
    d_sb = float(np.abs(out_s - out_b).max()) if out_s.shape == out_b.shape else np.inf
    snr_s = snr_db(pcm32, out_s)
    if len(p_s) != len(p_b) or tail_s or d_sb > STREAM_VS_BATCH_MAX_ABS \
            or snr_s < P0_SNR_FLOOR_DB or min(l_s["trunc_pack"], l_s["trunc_unpack"]) <= 0:
        raise AssertionError(f"lossless streaming: {len(p_s)} vs {len(p_b)} frames, stream vs "
                             f"batch decode {d_sb}, SNR {snr_s:.4f} dB, launches {l_s}")
    print(f"stream p0_stereo_44k1 s32le: enc {PUSH}-byte pushes {t_se:.3f} s "
          f"({n_frames / t_se:.1f} frames/s), dec {PUSH}-byte pushes {t_sd:.3f} s "
          f"({n_frames / t_sd:.1f} frames/s, first audio after {ttfa * 1e3:.2f} ms); payloads "
          f"differing from the batch stream {differ} of {len(p_s)}; max|stream - batch| {d_sb} "
          f"(tolerance {STREAM_VS_BATCH_MAX_ABS}), SNR {snr_s:.4f} dB; frames per call: enc "
          f"{enc_t.used()}, dec {dec_t.used()}; launches {l_s}")
    return res


def long_kernels(torch, kernels, dev, pq_shape, oa_shape, olap: int) -> dict:
    """power_quant and overlap_add against their plain versions at the
    shapes of Profile 1 with oa_shape[2]-sample frames; CUDA-event times."""
    from frad_python_tpu_torch.kernels.overlap_add import crossfade_window

    rng = np.random.default_rng(777)
    freqs = torch.from_numpy((rng.standard_normal(pq_shape) * 1e-2).astype(np.float32)).to(dev)
    div = np.exp(rng.standard_normal(pq_shape) * 2.0) * 0.1
    div[:, -pq_shape[1] // 16:] = 0.0
    div = torch.from_numpy(div.astype(np.float32)).to(dev)
    pcm = torch.from_numpy(rng.standard_normal(oa_shape).astype(np.float32) * 0.3).to(dev)
    w = crossfade_window(olap, dev)
    cut = oa_shape[2] - olap
    got, want = kernels.power_quant(freqs, div, 2.0 ** 15), kernels.power_quant_plain(
        freqs, div, 2.0 ** 15)
    o_k, f_k = kernels.overlap_add(pcm, w, cut, True)
    o_p, f_p = kernels.overlap_add_plain(pcm, w, cut, True)
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(o_k, o_p) and torch.equal(f_k, f_p)):
        raise AssertionError(f"power_quant {pq_shape} or overlap_add {oa_shape} differs from "
                             "its plain version")
    out = {"pq_shape": pq_shape, "oa_shape": oa_shape,
           "pq_ms": cuda_ms(torch, lambda: kernels.power_quant(freqs, div, 2.0 ** 15)),
           "pq_plain_ms": cuda_ms(torch, lambda: kernels.power_quant_plain(freqs, div, 2.0 ** 15)),
           "oa_ms": cuda_ms(torch, lambda: kernels.overlap_add(pcm, w, cut, True)),
           "oa_plain_ms": cuda_ms(torch, lambda: kernels.overlap_add_plain(pcm, w, cut, True))}
    print(f"kernels at Profile 1 N={oa_shape[2]}: power_quant {pq_shape} equal, "
          f"{out['pq_ms']:.4f} ms vs plain {out['pq_plain_ms']:.4f} ms; overlap_add {oa_shape} "
          f"olap={olap} i16 equal, {out['oa_ms']:.4f} ms vs plain {out['oa_plain_ms']:.4f} ms")
    return out


def tns_inputs(lanes: int, n: int, dtype: str, seed: int):
    """(x [lanes, n], coeffs [lanes, 13], ac [lanes, 13]) for the TNS
    kernels. Lanes cycle through: an active stable filter (quantised
    coefficients with sum |a| < 1) on a spectrum-like x; a bypass
    ([1, 0, ...]); a dead lane (zero spectrum, zero autocorrelation); a
    tonal lane (autocorrelation of a slow cosine: the first reflection
    clamps at 0.96); a lane whose output passes 1e6 (a = [1, -1, 0, ...]
    summing x of size 1e5); a lane of lags 1.1e-10 * [1, 1, 2, 1, ...],
    whose first two reflections clamp at -0.96 and whose prediction error
    then falls under 1e-12 (the freeze: coefficients 3.. stay 0); and raw
    random lags."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((lanes, n)) * np.exp(rng.standard_normal((lanes, 1)))
    q = np.zeros((lanes, 13))
    q[:, 1] = rng.integers(-7, 8, lanes)
    q[:, 2] = rng.integers(-3, 4, lanes)
    q[:, 3:6] = rng.integers(-1, 2, (lanes, 3))
    coeffs = q / 15.0
    lag = np.arange(13)
    sig = rng.standard_normal((lanes, 256))
    sig = np.cumsum(sig, axis=1) * 0.2 + sig
    sig /= np.linalg.norm(sig, axis=1, keepdims=True)
    ac = np.stack([(sig[:, :256 - l] * sig[:, l:]).sum(1) for l in lag], axis=1)
    kind = np.arange(lanes) % 7
    coeffs[kind == 1, 1:] = 0.0
    x[kind == 2] = 0.0
    ac[kind == 2] = 0.0
    ac[kind == 3] = np.cos(0.01 * lag) * np.exp(-0.5 * (0.01 * lag) ** 2)
    coeffs[kind == 4, 1:] = 0.0
    coeffs[kind == 4, 1] = -1.0
    x[kind == 4] = rng.standard_normal((int((kind == 4).sum()), n)) * 1e5
    ac[kind == 5] = 1.1e-10
    ac[kind == 5, 2] = 2.2e-10
    ac[kind == 6] = rng.standard_normal((int((kind == 6).sum()), 13))
    coeffs[:, 0] = 1.0
    return tuple(np.ascontiguousarray(a, dtype=dtype) for a in (x, coeffs, ac))


def bits_equal(torch, a, b) -> bool:
    """Equal bit for bit (a NaN equals the same NaN, -0 differs from +0)."""
    it = {4: torch.int32, 8: torch.int64, 2: torch.int16}[a.element_size()]
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(it), b.view(it))


def check_tns_kernels(torch, kernels, dev) -> dict:
    """tns_iir and tns_levinson against their plain versions, bit for bit,
    at TNS_SHAPES, float32 and float64; power_quant at
    P2_POWER_QUANT_FORMS and overlap_add at P2_OVERLAP_FORMS likewise:
    every form the Profile 2 and float64 runs launch. CUDA-event times of
    the kernels; of the plain versions at the main path's shape (the plain
    IIR, a Python loop over time, with one call, at float32 only)."""
    from frad_python_tpu_torch.kernels.overlap_add import crossfade_window

    res = {"iir_err": 0.0, "lev_err": 0.0, "pq_err": 0.0, "oa_err": 0.0, "thunks": {}}
    for dtype, shapes in TNS_SHAPES.items():
        for si, (lanes, n) in enumerate(shapes):
            x, coeffs, ac = (torch.from_numpy(a).to(dev)
                             for a in tns_inputs(lanes, n, dtype, 31 + lanes))
            (y_k,), (y_p,) = held(kernels, "tns_iir", x, coeffs)
            (l_k,), (l_p,) = held(kernels, "tns_levinson", ac)
            torch.cuda.synchronize()
            kind = torch.arange(lanes, device=dev) % 7
            d_iir = float((y_k - y_p).abs().nan_to_num(float("inf")).max())
            d_lev = float((l_k - l_p).abs().nan_to_num(float("inf")).max())
            res["iir_err"], res["lev_err"] = max(res["iir_err"], d_iir), max(res["lev_err"], d_lev)
            if not bits_equal(torch, y_k, y_p):
                raise AssertionError(f"tns_iir {(lanes, n)} {dtype} differs from its plain "
                                     f"version: max |d| {d_iir}")
            if not bits_equal(torch, l_k, l_p):
                raise AssertionError(f"tns_levinson {(lanes, 13)} {dtype} differs from its "
                                     f"plain version: max |d| {d_lev}")
            # lanes of every kind from 7 lanes on; fewer hold the first kinds
            peak = y_k[kind == 4].abs().amax(dim=-1)
            unit = torch.zeros(13, dtype=l_k.dtype, device=dev)
            unit[0] = 1.0
            if not (bits_equal(torch, y_k[kind == 1], x[kind == 1])
                    and bool(torch.isfinite(y_k).all()) and bool((peak > 1e6).all())
                    and bool((l_k[kind == 2] == unit).all())
                    and bool((l_k[kind == 5][:, 2] == torch.tensor(-0.96, dtype=l_k.dtype)).all())
                    and bool((l_k[kind == 5][:, 3:] == 0).all())):
                raise AssertionError(f"TNS kernel inputs {(lanes, n)} {dtype} miss a case: "
                                     f"bypass, blow-up {peak.tolist()[:3]}, dead, clamp or freeze")
            t = {"iir": cuda_ms(torch, lambda: kernels.tns_iir(x, coeffs)),
                 "lev": cuda_ms(torch, lambda: kernels.tns_levinson(ac))}
            line = (f"kernels tns_iir {(lanes, n)} / tns_levinson {(lanes, 13)} {dtype}: equal "
                    f"bit for bit, tns_iir {t['iir']:.4f} ms, tns_levinson {t['lev']:.4f} ms")
            if si == 0:
                t["lev_plain"] = cuda_ms(torch, lambda: kernels.tns_levinson_plain(ac), 3, 1)
                line += f" vs plain {t['lev_plain']:.3f} ms"
                if dtype == "float32":
                    t["iir_plain"] = cuda_ms(torch, lambda: kernels.tns_iir_plain(x, coeffs), 1, 1)
                    line += f", plain tns_iir {t['iir_plain']:.1f} ms"
                    res["thunks"] = {
                        "tns_iir_kernel": lambda x=x, c=coeffs: kernels.tns_iir(x, c),
                        "tns_levinson_kernel": lambda ac=ac: kernels.tns_levinson(ac)}
            res[(lanes, dtype)] = t
            print(line)

    # power_quant without a divisor and at float64, overlap_add at float64
    rng = np.random.default_rng(2468)
    for dtype, with_div, shapes in P2_POWER_QUANT_FORMS:
        for si, shape in enumerate(shapes):
            freqs = rng.standard_normal(shape) * 1e-2
            div = np.exp(rng.standard_normal(shape) * 2.0) * 0.1
            div[:, -shape[1] // 16:] = 0.0
            # no divisor: the spectrum as Profile 2 hands it over, divided
            fv = torch.from_numpy((freqs if with_div else freqs * 30.0).astype(dtype)).to(dev)
            dv = torch.from_numpy(div.astype(dtype)).to(dev) if with_div else None
            (got,), (want,) = held(kernels, "power_quant", fv, dv, 2.0 ** 15)
            torch.cuda.synchronize()
            err = float((got.to(torch.int64) - want.to(torch.int64)).abs().max())
            res["pq_err"] = max(res["pq_err"], err)
            if not bits_equal(torch, got, want) or int(got.abs().max()) < 1000:
                raise AssertionError(f"power_quant {shape} {dtype} divisor={with_div} differs "
                                     f"from its plain version: max |d| {err}")
            if si == 0:
                res[f"pq_{'div' if with_div else 'nodiv'}_{dtype}"] = (
                    cuda_ms(torch, lambda: kernels.power_quant(fv, dv, 2.0 ** 15)),
                    cuda_ms(torch, lambda: kernels.power_quant_plain(fv, dv, 2.0 ** 15)))
    for dtype, shape, olap, i16 in P2_OVERLAP_FORMS:
        pcm_k = torch.from_numpy((rng.standard_normal(shape) * 0.3).astype(dtype)).to(dev)
        w = crossfade_window(olap, dev, pcm_k.dtype)
        cut = shape[2] - olap
        (o_k, f_k), (o_p, f_p) = held(kernels, "overlap_add", pcm_k, w, cut, i16)
        torch.cuda.synchronize()
        err = max(float((o_k.double() - o_p.double()).abs().max()),
                  float((f_k - f_p).abs().max()))
        res["oa_err"] = max(res["oa_err"], err)
        if not (bits_equal(torch, o_k, o_p) and bits_equal(torch, f_k, f_p)
                and f_k.dtype == pcm_k.dtype):
            raise AssertionError(f"overlap_add {shape} {dtype} olap={olap} i16={i16} differs "
                                 f"from its plain version: max |d| {err}")
        if "oa_f64" not in res:
            res["oa_f64"] = (
                cuda_ms(torch, lambda: kernels.overlap_add(pcm_k, w, cut, i16)),
                cuda_ms(torch, lambda: kernels.overlap_add_plain(pcm_k, w, cut, i16)))
    shape = P2_POWER_QUANT_FORMS[0][2][0]
    print(f"kernels power_quant at {[f[:2] + (list(f[2]),) for f in P2_POWER_QUANT_FORMS]} and "
          f"overlap_add at {list(P2_OVERLAP_FORMS)}: all equal bit for bit; power_quant {shape} "
          f"no divisor f32 {res['pq_nodiv_float32'][0]:.4f} ms vs plain "
          f"{res['pq_nodiv_float32'][1]:.4f} ms, f64 {res['pq_nodiv_float64'][0]:.4f} vs "
          f"{res['pq_nodiv_float64'][1]:.4f} ms, f64 with divisor {res['pq_div_float64'][0]:.4f} "
          f"vs {res['pq_div_float64'][1]:.4f} ms; overlap_add {P2_OVERLAP_FORMS[0][1]} f64 emit "
          f"{res['oa_f64'][0]:.4f} vs {res['oa_f64'][1]:.4f} ms")
    return res


def egr_inputs(rows: int, m: int, seed: int) -> np.ndarray:
    """[rows, m] int32 symbol frames: Laplace rows of several scales, with
    a row of zeros (k = 0, every code one bit), a row whose only non-zero
    symbol is 1, the extremes -2^23 and 2^23 - 1, and from three rows on a
    row of wide symbols that overflows max_words in the middle."""
    rng = np.random.default_rng(seed)
    s = np.rint(rng.laplace(0, 1, (rows, m)) * np.exp(rng.standard_normal((rows, 1)) * 1.5 + 1))
    s[0] = 0
    s[1] = 0
    s[1, m // 3] = 1
    if rows > 2:
        s[2] = rng.integers(-(1 << 22), 1 << 22, m)
        s[-1, 0], s[-1, -1] = -(1 << 23), (1 << 23) - 1
    return s.astype(np.int32)


def check_egr_dequant(torch, kernels, dev) -> dict:
    """egr_pack at EGR_FORMS and dequant at DEQUANT_FORMS against their
    plain versions on the card. egr_pack: the compacted words, used,
    total_bits, k and overflow equal on every row, the padded words on
    every row that does not overflow. dequant: equal bit for bit; were it
    not, the count of differing elements and their distance in ulps is
    printed before the failure. CUDA-event times of both at the main
    path's forms, a call of each there (`thunks`), and each one's bound
    from the sizes of those inputs."""
    res = {"egr_err": 0, "deq_err": 0.0, "thunks": {}, "bounds": {}}
    for fi, (rows, m) in enumerate(EGR_FORMS):
        max_words = max(m * 12 // 32, 16)
        sym = torch.from_numpy(egr_inputs(rows, m, 500 + fi)).to(dev)
        got, want = held(kernels, "egr_pack", sym, max_words)
        got_w = kernels.egr_pack(sym, max_words, True)[5]
        want_w = kernels.egr_pack_plain(sym, max_words, True)[5]
        torch.cuda.synchronize()
        keep = want[4] == 0
        names = ("flat", "used", "total_bits", "k", "overflow")
        bad = [n for n, g, w in zip(names, got, want)
               if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w)]
        if not torch.equal(got_w[keep], want_w[keep]):
            bad.append("words")
        if bad or (rows > 2 and int(want[4][2]) != 1) or bool(want[4][:2].any()):
            res["egr_err"] = 1
            raise AssertionError(f"egr_pack {(rows, m)} differs from its plain version in "
                                 f"{bad}; overflow rows {int((~keep).sum())}")
        if fi == 0:
            res["egr_ms"] = cuda_ms(torch, lambda: kernels.egr_pack(sym, max_words))
            res["egr_plain_ms"] = cuda_ms(torch, lambda: kernels.egr_pack_plain(sym, max_words),
                                          5, 5)
            res["thunks"]["egr_"] = lambda sym=sym, mw=max_words: kernels.egr_pack(sym, mw)
            nbytes = sym.numel() * 4 + got[0].numel() * 4 + 4 * rows * 4
            res["bounds"]["egr_pack"] = bound(nbytes, sym.numel() * 14, "int32")
            res["egr_words"] = int(got[0].numel())
        elif (rows, m) == (4, 4096):
            res["egr_ms_4"] = cuda_ms(torch, lambda: kernels.egr_pack(sym, max_words))
            res["egr_plain_ms_4"] = cuda_ms(
                torch, lambda: kernels.egr_pack_plain(sym, max_words), 5, 5)
    print(f"kernel egr_pack at {list(EGR_FORMS)} (zero, dmax = 1, extreme and overflowing rows "
          f"in each): equal to plain word for word; {EGR_FORMS[0]} {res['egr_ms']:.4f} ms vs "
          f"plain {res['egr_plain_ms']:.4f} ms ({res['egr_words']} words compacted: "
          f"{res['egr_words'] * 4} bytes to copy back as int32, {res['egr_words'] * 8} as the "
          f"plain version's int64); (4, 4096) {res['egr_ms_4']:.4f} vs "
          f"{res['egr_plain_ms_4']:.4f} ms")

    rng = np.random.default_rng(600)
    edges = [0, -0.0, 1, -1, 2, -3, 32767, -32768]
    for fi, (dtype, shape, with_div) in enumerate(DEQUANT_FORMS):
        b, n, c = shape
        compute = "float64" if dtype == "float64" else "float32"
        sym = np.rint(rng.laplace(0, 20, shape))
        sym[0, :len(edges), 0] = edges
        div = np.exp(rng.standard_normal((b, c, n)) * 2.0) * 0.1
        div[:, :, -n // 16:] = 0.0
        s_d = torch.from_numpy(sym.astype(dtype)).to(dev)
        d_d = torch.from_numpy(div.astype(compute)).to(dev) if with_div else None
        for factor in (2.0 ** 15, 2.0 ** 23):
            (got,), (want,) = held(kernels, "dequant", s_d, d_d, factor)
            torch.cuda.synchronize()
            if not bits_equal(torch, got, want.contiguous()):
                it = torch.int64 if compute == "float64" else torch.int32
                d = (got.view(it).to(torch.int64)
                     - want.contiguous().view(it).to(torch.int64)).abs()
                res["deq_err"] = float((got - want).abs().nan_to_num(float("inf")).max())
                raise AssertionError(
                    f"dequant {dtype} {shape} divisor={with_div} factor={factor} differs from "
                    f"its plain version in {int((d != 0).sum())} of {got.numel()} elements, "
                    f"by at most {int(d.max())} ulp (max |d| {res['deq_err']})")
        if fi == 0 or (dtype, shape) == ("int16", (4, 2048, 2)) and with_div:
            key = "deq" if fi == 0 else "deq_4"
            res[f"{key}_ms"] = cuda_ms(torch, lambda: kernels.dequant(s_d, d_d, 2.0 ** 15))
            res[f"{key}_plain_ms"] = cuda_ms(
                torch, lambda: kernels.dequant_plain(s_d, d_d, 2.0 ** 15))
        if fi == 0:
            res["thunks"]["dequant_kernel"] = lambda s=s_d, d=d_d: kernels.dequant(s, d, 2.0 ** 15)
            n_el = s_d.numel()
            res["bounds"]["dequant"] = bound(n_el * (2 + 4 + 4), n_el * 40)
    print(f"kernel dequant at {len(DEQUANT_FORMS)} forms {list(DEQUANT_FORMS)}, factors 2^15 "
          f"and 2^23 (zeros, signs and the int16 extremes in each): equal to plain bit for "
          f"bit; {DEQUANT_FORMS[0]} {res['deq_ms']:.4f} ms vs plain {res['deq_plain_ms']:.4f} "
          f"ms; (4, 2048, 2) {res['deq_4_ms']:.4f} vs {res['deq_4_plain_ms']:.4f} ms")
    return res


def tns_lane_share(stream: bytes) -> tuple[int, int]:
    """(lanes with a non-zero LPC row, lanes) over the Profile 2 payloads."""
    from frad_python_tpu_torch.models import profile2
    from frad_python_tpu_torch.parallel.pipeline import _parse_frames

    headers, payloads, _ = _parse_frames(stream)
    active = lanes = 0
    for h, p in zip(headers, payloads):
        if p is None:
            continue
        lpc = profile2.untrim_streams(profile2.unpack_streams(p), h.fsize, h.channels)[2]
        active += int((lpc.reshape(profile2.ORDER1, h.channels) != 0).any(axis=0).sum())
        lanes += h.channels
    return active, lanes


def tns_phase(ft, torch, kernels, native, dev) -> dict:
    """Profile 2 on the card (see the module docstring). Returns the
    kernel checks, the launches of the batch and of the streaming runs, and
    a call of each TNS kernel at the main path's shape (`thunks`)."""
    from frad_python_tpu_torch.models import profile2
    from frad_python_tpu_torch.parallel import pipeline
    from frad_python_tpu_torch.parallel.pipeline import _parse_frames

    res = check_tns_kernels(torch, kernels, dev)
    pcm = make_audio(SECONDS, SRATE, CHANNELS)
    frames, terms = pipeline.plan_frames(len(pcm), FSIZE, 16, True)
    n = len(frames)

    # batch: one encode and one decode of the 30 s track
    warm = make_audio(1.0, SRATE, CHANNELS)
    warm_s = ft.batch_encode(warm, 2, SRATE, BITS, FSIZE, device=dev)
    ft.batch_decode(warm_s, device=dev)
    stream_decode(ft, torch, warm_s, PUSH, dev)
    torch.cuda.synchronize()
    forms = FormTally()
    kernels.reset_launches()
    native.reset_calls()
    with forms:
        stream, t_enc = timed(torch, lambda: ft.batch_encode(pcm, 2, SRATE, BITS, FSIZE,
                                                             device=dev))
        (out, sr), t_dec = timed(torch, lambda: ft.batch_decode(stream, device=dev))
    res["launches"] = {k.__name__: k.launches for k in kernels.KERNELS}
    calls = {w.__name__: w.calls for w in native.WRAPPERS}
    headers, payloads, tail = _parse_frames(stream)
    if (sum(p is not None for p in payloads), sum(p is None for p in payloads), tail,
            {h.profile for h in headers}) != (n, terms, b"", {2}):
        raise AssertionError(f"profile 2 stream: {len(headers)} headers of profiles "
                             f"{ {h.profile for h in headers} }, plan {n} + {terms}")
    if sr != SRATE or out.shape[1] != CHANNELS or len(out) < len(pcm) \
            or not np.isfinite(out).all():
        raise AssertionError(f"profile 2: decoded {out.shape} at {sr} Hz, or not finite")
    snr = snr_db(pcm, out)
    active, lanes = tns_lane_share(stream)
    if snr < P2_SNR_FLOOR_DB or active <= 0:
        raise AssertionError(f"profile 2: SNR {snr:.4f} dB (floor {P2_SNR_FLOOR_DB}), TNS ran "
                             f"on {active} of {lanes} lanes")
    for name in P2_KERNELS:
        if res["launches"][name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the profile 2 batch path")
    if calls["p1_unpack_batch"] <= 0:
        raise AssertionError("native p1_unpack_batch was not called by the profile 2 decode")
    out_cpu, _ = ft.batch_decode(stream, device="cpu")
    d_cpu = float(np.abs(out_cpu - out).max()) if out_cpu.shape == out.shape else float("inf")
    if d_cpu > P2_CARD_VS_CPU_MAX_ABS:
        raise AssertionError(f"profile 2 card vs CPU decode differ by {d_cpu} > "
                             f"{P2_CARD_VS_CPU_MAX_ABS}")
    print(f"p2_stereo_44k1: {n} frames + {terms} terminators, {len(stream)} bytes, TNS ran on "
          f"{active} of {lanes} lanes ({active / lanes:.4f}), SNR {snr:.4f} dB (floor "
          f"{P2_SNR_FLOOR_DB}), enc {n / t_enc:.1f} frames/s ({t_enc:.3f} s), dec "
          f"{n / t_dec:.1f} frames/s ({t_dec:.3f} s), card vs cpu decode max|d| {d_cpu} "
          f"(tolerance {P2_CARD_VS_CPU_MAX_ABS}), launches {res['launches']}, native calls "
          f"{calls}")

    # streaming: the Decoder in 32 KiB pushes over the same stream
    kernels.reset_launches()
    with forms, FrameTally(pipeline, profile2) as dec_tally:
        (out_s, ttfa), t_s = timed(torch, lambda: stream_decode(ft, torch, stream, PUSH, dev))
    res["stream_launches"] = {k.__name__: k.launches for k in kernels.KERNELS}
    d_sb = float(np.abs(out_s - out).max()) if out_s.shape == out.shape else float("inf")
    if d_sb > STREAM_VS_BATCH_MAX_ABS or snr_db(pcm, out_s) < P2_SNR_FLOOR_DB \
            or min(res["stream_launches"][k] for k in ("tns_iir", "overlap_add")) <= 0:
        raise AssertionError(f"profile 2 streaming decode: max|stream - batch| {d_sb}, SNR "
                             f"{snr_db(pcm, out_s):.4f} dB, launches {res['stream_launches']}")
    # the Encoder refuses profile 2 in its gauntlet, as the JAX package's
    # does; an engine whose loaded state names profile 2 encodes it
    enc = ft.Encoder(1, SRATE, CHANNELS, BITS, FSIZE, "s16le", device=dev)
    enc.set_overlap_ratio(16)
    state = enc.state_dict()
    state["profile"] = 2
    enc.load_state_dict(state)
    raw = to_s16le(pcm)
    kernels.reset_launches()
    with forms:
        s_enc, t_se = timed(torch, lambda: b"".join(
            [enc.process(raw[i:i + PUSH]).buf for i in range(0, len(raw), PUSH)]
            + [enc.flush().buf]))
    l_enc = {k.__name__: k.launches for k in kernels.KERNELS}
    for k in l_enc:
        res["stream_launches"][k] += l_enc[k]
    out_e, _ = ft.batch_decode(s_enc, device=dev)
    h_e, p_e, _ = _parse_frames(s_enc)
    if {h.profile for h in h_e} != {2} or sum(p is not None for p in p_e) != n \
            or snr_db(pcm, out_e) < P2_SNR_FLOOR_DB \
            or min(l_enc[k] for k in ("power_quant", "tns_levinson")) <= 0:
        raise AssertionError(f"profile 2 streaming encode: {len(h_e)} headers, SNR "
                             f"{snr_db(pcm, out_e):.4f} dB, launches {l_enc}")
    print(f"stream p2: dec {PUSH}-byte pushes {t_s:.3f} s ({n / t_s:.1f} frames/s, first audio "
          f"after {ttfa * 1e3:.2f} ms), max|stream - batch| {d_sb} (tolerance "
          f"{STREAM_VS_BATCH_MAX_ABS}), SNR {snr_db(pcm, out_s):.4f} dB, frames per call "
          f"{dec_tally.used()}; enc (state dict with profile 2) {t_se:.3f} s "
          f"({n / t_se:.1f} frames/s), SNR {snr_db(pcm, out_e):.4f} dB; launches "
          f"{res['stream_launches']}")

    # profiles 1 and 2 at float64 (the JAX package's default off the TPU)
    short = make_audio(F64_SECONDS, SRATE, CHANNELS)
    n64 = len(pipeline.plan_frames(len(short), FSIZE, 16, True)[0])
    for profile in (1, 2):
        # first-use set-up (cuFFT plans are per batch shape): the same track
        ft.batch_decode(ft.batch_encode(short, profile, SRATE, BITS, FSIZE,
                                        compute_dtype="float64", device=dev),
                        compute_dtype="float64", device=dev)
        torch.cuda.synchronize()
        kernels.reset_launches()
        with forms:
            s64, t_e = timed(torch, lambda: ft.batch_encode(
                short, profile, SRATE, BITS, FSIZE, compute_dtype="float64", device=dev))
            (o64, _), t_d = timed(torch, lambda: ft.batch_decode(
                s64, compute_dtype="float64", device=dev))
        l64 = {k.__name__: k.launches for k in kernels.KERNELS}
        o_cpu, _ = ft.batch_decode(s64, compute_dtype="float64", device="cpu")
        s_cpu = ft.batch_encode(short, profile, SRATE, BITS, FSIZE, compute_dtype="float64",
                                device="cpu")
        differ = sum(a != b for a, b in zip(_parse_frames(s64)[1], _parse_frames(s_cpu)[1]))
        d64 = float(np.abs(o_cpu - o64).max()) if o_cpu.shape == o64.shape else float("inf")
        snr64 = snr_db(short, o64)
        # float64 symbols are int64 and take the host EGR coder: no egr_pack
        need = P2_KERNELS if profile == 2 else tuple(k for k in P1_KERNELS if k != "egr_pack")
        if d64 > F64_LOSSY_CARD_VS_CPU_MAX_ABS or snr64 < F64_SNR_FLOOR_DB[profile] \
                or min(l64[k] for k in need) <= 0:
            raise AssertionError(f"profile {profile} float64: card vs cpu decode {d64}, SNR "
                                 f"{snr64:.4f} dB (floor {F64_SNR_FLOOR_DB[profile]}), "
                                 f"launches {l64}")
        print(f"profile {profile} float64, {F64_SECONDS:g} s: {n64} frames, enc {t_e:.3f} s, "
              f"dec {t_d:.3f} s, SNR {snr64:.4f} dB (floor {F64_SNR_FLOOR_DB[profile]}), "
              f"payloads differing from the CPU stream {differ} of {n64}, card vs cpu decode "
              f"max|d| {d64} (tolerance {F64_LOSSY_CARD_VS_CPU_MAX_ABS}), launches {l64}")
    forms.require_held("the Profile 2 and float64 runs")
    print(f"forms launched by the Profile 2 and float64 runs, each held against its plain "
          f"version above (form: launches): "
          + ", ".join(f"{f}: {c}" for f, c in sorted(forms.seen.items(), key=str)))
    return res


def cli_phase(ft, torch, kernels, dev, pcm: np.ndarray, smi: str) -> dict:
    """The command line on the card, in a temporary directory: every
    action through `app.main.main` with no `--device` (CUDA), and one
    `python3 -m frad_python_tpu_torch encode` subprocess. Returns the walls
    per action."""
    from frad_python_tpu_torch.app.encode import loss_level_from_cli
    from frad_python_tpu_torch.app.main import main as cli_main
    from frad_python_tpu_torch.container import head
    from frad_python_tpu_torch.ops.pcm import to_f64
    from frad_python_tpu_torch.utils.damage import damage_stream

    repo = Path(__file__).resolve().parent
    png = b"\x89PNG\r\n\x1a\n" + bytes(range(256)) * 8
    raw = to_s16le(pcm)
    s16 = np.dtype("<i2")
    content = to_f64(np.frombuffer(raw, s16).reshape(-1, CHANNELS), s16)
    geometry = ["--srate", str(SRATE), "--ch", str(CHANNELS), "--pcm", "s16le",
                "--bits", str(BITS), "--fr", str(FSIZE)]
    walls = {}
    here = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)                    # `meta parse` exports beside the working directory
        try:
            Path("track.pcm").write_bytes(raw)
            Path("cover.png").write_bytes(png)

            def run(name: str, argv: list[str]) -> None:
                _, walls[name] = timed(torch, lambda: cli_main(["frad-torch"] + argv))

            def read_s16(path: str) -> np.ndarray:
                return np.frombuffer(Path(path).read_bytes(), s16).reshape(-1, CHANNELS) / 32768.0

            # Profile 1: encode (batch path), the file's bytes, decode
            kernels.reset_launches()
            run("encode", ["encode", "track.pcm", "--profile", "1", "--tag", "TITLE", "smoke",
                           "--img", "cover.png", "-o", "track.frad", "-y"] + geometry)
            run("decode", ["decode", "track.frad", "--pcm", "s16le", "-o", "back", "-y"])
            launches = {k.__name__: k.launches for k in kernels.KERNELS}
            header = head.builder([("TITLE", b"smoke")], png)
            stream = ft.batch_encode(content, 1, SRATE, BITS, FSIZE,
                                     loss_level=loss_level_from_cli(0), device=dev)
            file = Path("track.frad").read_bytes()
            if file != header + stream:
                raise AssertionError("cli encode: the file is not head.builder(...) + the bytes "
                                     "of batch_encode on the same input")
            out, _ = ft.batch_decode(stream, device=dev)
            want = np.frombuffer(
                (np.asarray(out) * 32768.0).astype(s16).tobytes(), s16).reshape(-1, CHANNELS)
            back = read_s16("back.pcm")
            snr = snr_db(pcm, back)
            if not np.array_equal(back * 32768.0, want) or snr < CLI_P1_SNR_FLOOR_DB:
                raise AssertionError(f"cli decode: PCM differs from batch_decode's through the "
                                     f"same cast, or SNR {snr:.4f} dB below {CLI_P1_SNR_FLOOR_DB}")
            for name in P1_KERNELS:
                if launches[name] <= 0:
                    raise AssertionError(f"kernel {name} was not launched by the cli's encode "
                                         f"and decode: {launches}")

            # the engines: --no-turbo encode, and a decode fed in the pipe's reads
            kernels.reset_launches()
            run("encode_no_turbo", ["encode", "track.pcm", "--profile", "1", "--no-turbo",
                                    "-o", "engine.frad", "-y"] + geometry)

            class Pipe:
                def __init__(self, data: bytes = b""):
                    self.buffer = io.BytesIO(data)

                def isatty(self) -> bool:
                    return False

            stdin, stdout = sys.stdin, sys.stdout
            piped = Pipe()
            sys.stdin, sys.stdout = Pipe(Path("engine.frad").read_bytes()), piped
            try:
                run("decode_pipe", ["decode", "-", "--pcm", "s16le", "-o", "-"])
            finally:
                sys.stdin, sys.stdout = stdin, stdout
            l_engine = {k.__name__: k.launches for k in kernels.KERNELS}
            back_e = np.frombuffer(piped.buffer.getvalue(), s16).reshape(-1, CHANNELS) / 32768.0
            snr_e = snr_db(pcm, back_e)
            if len(back_e) != len(back) or snr_e < CLI_P1_SNR_FLOOR_DB \
                    or min(l_engine[k] for k in P1_KERNELS) <= 0:
                raise AssertionError(f"cli engines: {len(back_e)} samples, SNR {snr_e:.4f} dB, "
                                     f"launches {l_engine}")

            # profile 0 at 24 bits
            run("encode_p0", ["encode", "track.pcm", "--profile", "0", "-o", "p0.frad", "-y"]
                + geometry[:6] + ["--bits", str(P0_BITS), "--fr", str(FSIZE)])
            run("decode_p0", ["decode", "p0.frad", "--pcm", "f64le", "-o", "p0back", "-y"])
            back0 = np.frombuffer(Path("p0back.pcm").read_bytes(), "<f8").reshape(-1, CHANNELS)
            snr0 = snr_db(content, back0)
            if back0.shape != content.shape or snr0 < CLI_P0_SNR_FLOOR_DB:
                raise AssertionError(f"cli profile 0: {back0.shape}, SNR {snr0:.4f} dB below "
                                     f"{CLI_P0_SNR_FLOOR_DB}")

            # repair of a damaged armored file
            run("encode_ecc", ["encode", "track.pcm", "--profile", "1", "--ecc",
                               str(ECC_RATIO[0]), str(ECC_RATIO[1]), "-o", "armored.frad", "-y"]
                + geometry)
            armored = Path("armored.frad").read_bytes()
            n_head = len(head.builder([], b""))
            Path("damaged.frad").write_bytes(armored[:n_head] + damage_stream(armored[n_head:]))
            run("repair", ["repair", "damaged.frad", "--ecc", str(ECC_RATIO[0]),
                           str(ECC_RATIO[1]), "-o", "repaired.frad", "-y"])
            if Path("damaged.frad").read_bytes() == armored \
                    or Path("repaired.frad").read_bytes() != armored:
                raise AssertionError("cli repair of the damaged armored file differs from the "
                                     "armored file")

            # meta: add, parse, remove
            run("meta_add", ["meta", "add", "track.frad", "--meta", "ARTIST", "chip"])
            run("meta_parse", ["meta", "parse", "track.frad"])
            keys = [m["key"] for m in json.loads(Path("track.json").read_text())]
            run("meta_remove", ["meta", "remove", "track.frad", "--meta", "TITLE"])
            cli_main(["frad-torch", "meta", "parse", "track.frad"])
            keys2 = [m["key"] for m in json.loads(Path("track.json").read_text())]
            after = Path("track.frad").read_bytes()
            if keys != ["TITLE", "ARTIST"] or keys2 != ["ARTIST"] \
                    or Path("track.png").read_bytes() != png \
                    or after != head.builder([("ARTIST", b"chip")], png) + stream:
                raise AssertionError(f"cli meta: keys {keys} then {keys2}, or the audio moved")

            # the real entry point: a process of its own, the build at first
            # use (cached from this run), its exit code
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-m", "frad_python_tpu_torch", "encode", "track.pcm",
                 "--profile", "1", "--tag", "TITLE", "smoke", "--img", "cover.png", "-o",
                 "sub.frad", "-y", "--log", "1"] + geometry,
                env=dict(os.environ, PYTHONPATH=str(repo)), capture_output=True, text=True,
                timeout=600)
            walls["subprocess_encode"] = time.perf_counter() - t0
            if res.returncode != 0 or Path("sub.frad").read_bytes() != file \
                    or "size=" not in res.stderr:
                raise AssertionError(f"python3 -m frad_python_tpu_torch encode: exit code "
                                     f"{res.returncode}, or another file than in process:\n"
                                     f"{res.stderr[-2000:]}")
        finally:
            os.chdir(here)
    n = len(_frames_of(pcm))
    print(f"cli ({smi}): " + ", ".join(f"{k} {v:.4f} s" for k, v in walls.items())
          + f"; encode = header + batch_encode's bytes ({len(file)} bytes, {n} frames), decode "
          f"= batch_decode's PCM, SNR {snr:.4f} dB (floor {CLI_P1_SNR_FLOOR_DB}); engines SNR "
          f"{snr_e:.4f} dB; profile 0 {P0_BITS}-bit SNR {snr0:.4f} dB (floor "
          f"{CLI_P0_SNR_FLOOR_DB}); repair equal to the armored file; meta {keys} -> {keys2}; "
          f"subprocess equal to the in-process file; launches encode + decode {launches}, "
          f"engines {l_engine}")
    return walls


def _frames_of(pcm: np.ndarray) -> list:
    from frad_python_tpu_torch.parallel.pipeline import plan_frames
    return plan_frames(len(pcm), FSIZE, 16, True)[0]


def kernel_yardsticks(torch, thunks: dict, more_bounds: dict) -> dict:
    """For the eight kernels at their main-path shapes (float32): the device
    time of one launch of each on its check's inputs (`thunks`, {kernel
    function name: call}; `egr_` sums egr_pack's three kernels) from one
    `torch.profiler` call, and each kernel's bound from the bytes it must
    move and the operations it does (`more_bounds`: those worked out
    beside the checks)."""
    device_ms = profiled_device_ms(torch, thunks)
    device_ms = {("egr_pack_kernel" if k == "egr_" else k): v for k, v in device_ms.items()}
    b, c, nn = OVERLAP_SHAPE
    tb, tc, tn = TRUNC_SHAPES[0]
    lanes, n = TNS_SHAPES["float32"][0]
    pq_n = POWER_QUANT_SHAPE[0] * POWER_QUANT_SHAPE[1]
    tr_n = tb * tc * tn
    bounds = {
        "power_quant": bound(pq_n * 12, pq_n * 8),
        "overlap_add": bound(b * c * nn * 4 + OLAP * 4 + b * CUT * c * 2 + OLAP * c * 4,
                             b * c * CUT * 2 + (b - 1) * c * OLAP * 3),
        "trunc_pack": bound(tr_n * 4 + tr_n * P0_BITS // 8 + tb * 4, tr_n * 2),
        "trunc_unpack": bound(tr_n * P0_BITS // 8 + tr_n * 4, tr_n),
        "tns_iir": bound(2 * lanes * n * 4 + lanes * 13 * 4, lanes * n * 25),
        "tns_levinson": bound(2 * lanes * 13 * 4, lanes * 360),
        **more_bounds,
    }
    print("device time of one launch each on its check's inputs, not the runs' data, one "
          "torch.profiler call (ms): "
          + ", ".join(f"{k.removesuffix('_kernel')} {v:.4f}" if v is not None
                      else f"{k.removesuffix('_kernel')} not in the trace"
                      for k, v in device_ms.items())
          + "; bounds (ms): " + ", ".join(f"{k} {v[0]:.5f} by {v[1]}" for k, v in bounds.items()))
    return {"device_ms": {k.removesuffix("_kernel"): v for k, v in device_ms.items()},
            "bounds": bounds}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import frad_python_tpu_torch as ft
    from frad_python_tpu_torch import kernels, native
    from frad_python_tpu_torch.kernels import build
    from frad_python_tpu_torch.kernels.overlap_add import crossfade_window
    from frad_python_tpu_torch.models.profiles import compact
    from frad_python_tpu_torch.native import build as native_build
    from frad_python_tpu_torch.parallel.pipeline import _parse_frames, plan_frames
    from frad_python_tpu_torch.utils.damage import damage_stream

    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"card: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    dev = torch.device(DEVICE)

    # 2. build
    t0 = time.perf_counter()
    path, compiled = build.build()
    build.library()
    print(f"build: {'compiled' if compiled else 'cached'} {path.name} in "
          f"{time.perf_counter() - t0:.2f} s")

    # 2b. the C++ host module: every symbol binds, and its DEFLATE output
    # equals this machine's zlib.compress
    if not native.enabled():
        raise RuntimeError("FRAD_TORCH_NO_NATIVE is set: the main path must run the native module")
    t0 = time.perf_counter()
    npath, ncompiled = native_build.build()
    native.library()
    t_native = time.perf_counter() - t0
    check_native_pack(native)
    print(f"native: {'compiled' if ncompiled else 'cached'} {npath.name} in {t_native:.2f} s, "
          f"{len(native.SIGNATURES)} symbols bound, p1_pack_batch equals zlib.compress")

    # 3. kernels against their plain versions at the main path's shapes
    rng = np.random.default_rng(1234)
    freqs = (rng.standard_normal(POWER_QUANT_SHAPE) * 1e-2).astype(np.float32)
    # divisors over five decades, so symbols run from 0 to ~1e4 and many
    # land near a rounding boundary; the top bins divide by 0 as bins past
    # the last active band do
    div = (np.exp(rng.standard_normal(POWER_QUANT_SHAPE) * 2.0) * 0.1).astype(np.float32)
    div[:, -128:] = 0.0
    f_d, d_d = torch.from_numpy(freqs).to(dev), torch.from_numpy(div).to(dev)
    factor = 2.0 ** 15
    (got,), (want,) = held(kernels, "power_quant", f_d, d_d, factor)
    torch.cuda.synchronize()
    pq_err = float((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"power_quant differs from its plain version: max |d| {pq_err}")
    pq_ms = cuda_ms(torch, lambda: kernels.power_quant(f_d, d_d, factor))
    pq_plain_ms = cuda_ms(torch, lambda: kernels.power_quant_plain(f_d, d_d, factor))
    print(f"kernel power_quant {POWER_QUANT_SHAPE}: equal, max|d| {pq_err}, "
          f"{pq_ms:.4f} ms vs plain {pq_plain_ms:.4f} ms")

    pcm_k = torch.from_numpy(rng.standard_normal(OVERLAP_SHAPE).astype(np.float32) * 0.3).to(dev)
    w = crossfade_window(OLAP, dev)
    oa = {}
    oa_err = 0.0
    for i16 in (True, False):
        (out_k, frag_k), (out_p, frag_p) = held(kernels, "overlap_add", pcm_k, w, CUT, i16)
        torch.cuda.synchronize()
        err = max(float((out_k.double() - out_p.double()).abs().max()),
                  float((frag_k - frag_p).abs().max()))
        oa_err = max(oa_err, err)
        if not (torch.equal(out_k, out_p) and torch.equal(frag_k, frag_p)):
            raise AssertionError(f"overlap_add (i16={i16}) differs from its plain version: "
                                 f"max |d| {err}")
        oa[i16] = (cuda_ms(torch, lambda: kernels.overlap_add(pcm_k, w, CUT, i16)),
                   cuda_ms(torch, lambda: kernels.overlap_add_plain(pcm_k, w, CUT, i16)))
        print(f"kernel overlap_add {OVERLAP_SHAPE} i16={i16}: equal, max|d| {err}, "
              f"{oa[i16][0]:.4f} ms vs plain {oa[i16][1]:.4f} ms")

    # 3b. egr_pack and dequant at every form the runs below launch them at;
    # from here to the end a tally of their launches holds the runs to that
    new = check_egr_dequant(torch, kernels, dev)
    tally_stack = contextlib.ExitStack()
    new_forms = tally_stack.enter_context(FormTally(only=("egr_pack", "dequant")))

    # 4. the slice end to end on the card
    pcm = make_audio(SECONDS, SRATE, CHANNELS)
    warm = make_audio(1.0, SRATE, CHANNELS)          # first-use set-up outside the timing
    ft.batch_decode(ft.batch_encode(warm, 1, SRATE, BITS, FSIZE, i16_upload=True, device=dev),
                    i16_transfer=True, device=dev)
    torch.cuda.synchronize()

    kernels.reset_launches()
    native.reset_calls()
    egr_words_before = new_forms.egr_words
    t0 = time.perf_counter()
    stream = ft.batch_encode(pcm, 1, SRATE, BITS, FSIZE, i16_upload=True, device=dev)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    out, srate = ft.batch_decode(stream, i16_transfer=True, device=dev)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    calls = {w.__name__: w.calls for w in native.WRAPPERS}
    main_egr_words = new_forms.egr_words - egr_words_before

    frames, terms = plan_frames(len(pcm), FSIZE, 16, True)
    headers, payloads, tail = _parse_frames(stream)
    n_payload = sum(p is not None for p in payloads)
    n_term = sum(p is None for p in payloads)
    if (n_payload, n_term, tail) != (len(frames), terms, b""):
        raise AssertionError(f"stream holds {n_payload} frames + {n_term} terminators, "
                             f"plan says {len(frames)} + {terms}")
    dlens = [compact.get_samples_min_ge(ln) for _, ln in frames]
    expect = sum(d * 15 // 16 for d in dlens) + (dlens[-1] - dlens[-1] * 15 // 16)
    if out.shape != (expect, CHANNELS) or srate != SRATE:
        raise AssertionError(f"decoded {out.shape} at {srate} Hz, expected ({expect}, {CHANNELS})")
    if not np.isfinite(out).all():
        raise AssertionError("decoded PCM is not finite")
    snr = snr_db(pcm, out)
    if snr < SNR_FLOOR_DB:
        raise AssertionError(f"SNR {snr:.4f} dB below the floor {SNR_FLOOR_DB} dB")
    for name in P1_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the main path")
    for name in ("p1_pack_batch", "frame_pack_batch", "frame_parse_batch", "p1_unpack_batch"):
        if calls[name] <= 0:
            raise AssertionError(f"native {name} was not called by the main path")
    print(f"slice: {len(frames)} frames + {terms} terminators, {len(stream)} bytes, "
          f"{out.shape[0]} samples, SNR {snr:.4f} dB (floor {SNR_FLOOR_DB}), "
          f"enc {len(frames) / t_enc:.1f} frames/s ({t_enc:.3f} s), "
          f"dec {len(frames) / t_dec:.1f} frames/s ({t_dec:.3f} s), launches {launches}, "
          f"native calls {calls}; egr_pack's compacted words copied back: {main_egr_words} "
          f"({main_egr_words * 4} bytes as int32)")

    # 5. the card's stream decoded on the CPU (plain versions)
    out_cpu, _ = ft.batch_decode(stream, i16_transfer=True, device="cpu")
    d = float(np.abs(out_cpu - out).max()) if out_cpu.shape == out.shape else float("inf")
    if d > CARD_VS_CPU_MAX_ABS:
        raise AssertionError(f"card vs CPU decode differ by {d} > {CARD_VS_CPU_MAX_ABS}")
    print(f"card vs cpu decode: max|d| {d} (tolerance {CARD_VS_CPU_MAX_ABS}), "
          f"cpu SNR {snr_db(pcm, out_cpu):.4f} dB")

    # 6. the same track armored, damaged, repaired and decoded with repair
    kernels.reset_launches()
    native.reset_calls()
    t0 = time.perf_counter()
    armored = ft.batch_encode(pcm, 1, SRATE, BITS, FSIZE, i16_upload=True, enable_ecc=True,
                              ecc_ratio=ECC_RATIO, device=dev)
    torch.cuda.synchronize()
    t_enc_e = time.perf_counter() - t0
    damaged = damage_stream(armored)
    t0 = time.perf_counter()
    repaired = ft.batch_repair(damaged, ECC_RATIO)
    t_rep = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_fixed, _ = ft.batch_decode(damaged, fix_error=True, i16_transfer=True, device=dev)
    torch.cuda.synchronize()
    t_dec_e = time.perf_counter() - t0
    out_clean, _ = ft.batch_decode(armored, i16_transfer=True, device=dev)
    torch.cuda.synchronize()
    launches_e = {k.__name__: k.launches for k in kernels.KERNELS}
    calls_e = {w.__name__: w.calls for w in native.WRAPPERS}

    headers, payloads, tail = _parse_frames(armored)
    n_payload = sum(p is not None for p in payloads)
    n_term = sum(p is None for p in payloads)
    if (n_payload, n_term, tail) != (len(frames), terms, b""):
        raise AssertionError(f"armored stream holds {n_payload} frames + {n_term} "
                             f"terminators, plan says {len(frames)} + {terms}")
    if not all(h.ecc for h in headers) or {(h.ecc_dsize, h.ecc_codesize) for h, p in
                                           zip(headers, payloads) if p is not None} != {ECC_RATIO}:
        raise AssertionError(f"armored stream headers do not all carry ECC at {ECC_RATIO}")
    if damaged == armored or len(damaged) != len(armored):
        raise AssertionError("damage_stream must change bytes and keep the length")
    if repaired != armored:
        raise AssertionError("batch_repair of the damaged stream differs from the armored stream")
    if out_fixed.shape != out_clean.shape or not np.array_equal(out_fixed, out_clean):
        raise AssertionError("fix_error decode of the damaged stream differs from the clean decode")
    snr_e = snr_db(pcm, out_fixed)
    if snr_e < SNR_FLOOR_DB:
        raise AssertionError(f"ECC SNR {snr_e:.4f} dB below the floor {SNR_FLOOR_DB} dB")
    for name in P1_KERNELS:
        if launches_e[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the ECC path")
    for name in ("unarmor_batch", "frame_pack_batch"):
        if calls_e[name] <= 0:
            raise AssertionError(f"native {name} was not called by the ECC path")
    print(f"ecc {ECC_RATIO}: {len(armored)} bytes ({len(armored) / len(stream):.4f}x), "
          f"damaged {sum(a != b for a, b in zip(armored, damaged))} bytes, repaired equal, "
          f"fix_error decode equal to clean, SNR {snr_e:.4f} dB, "
          f"enc {len(frames) / t_enc_e:.1f} frames/s ({t_enc_e:.3f} s), "
          f"repair {len(frames) / t_rep:.1f} frames/s ({t_rep:.3f} s), "
          f"dec fix_error {len(frames) / t_dec_e:.1f} frames/s ({t_dec_e:.3f} s), "
          f"launches {launches_e}, native calls {calls_e}")

    # 7. the streaming engines: kernels at their shapes, then the track as
    # s16le bytes through Encoder, Decoder and Repairer
    from frad_python_tpu_torch.models import profile1
    from frad_python_tpu_torch.parallel import pipeline

    pq_s_err, oa_s_err = check_stream_shapes(torch, kernels, crossfade_window, dev)
    raw = to_s16le(pcm)
    warm_raw = to_s16le(warm)                  # first-use set-up outside the timing
    for push in (PUSH, len(warm_raw)):
        warm_s = stream_encode(ft, torch, warm_raw, push, dev)
    stream_decode(ft, torch, warm_s, PUSH, dev)
    stream_decode(ft, torch, warm_s, PUSH, dev, exact=True)

    kernels.reset_launches()
    with FrameTally(pipeline, profile1) as enc_tally:
        s32, t_s_enc = timed(torch, lambda: stream_encode(ft, torch, raw, PUSH, dev))
    launches_s_enc = {k.__name__: k.launches for k in kernels.KERNELS}
    sdeep, t_s_deep = timed(torch, lambda: stream_encode(ft, torch, raw, len(raw), dev))
    h32, p32, tail32 = _parse_frames(s32)
    hdeep, pdeep, taildeep = _parse_frames(sdeep)
    if ([p is None for p in p32] != [p is None for p in pdeep] or tail32 or taildeep
            or sum(p is not None for p in p32) != len(frames)
            or sum(p is None for p in p32) != terms):
        raise AssertionError("streaming encodes do not follow the frame plan")
    differ = sum(a != b for a, b in zip(p32, pdeep) if a is not None)

    kernels.reset_launches()
    with FrameTally(pipeline, profile1) as dec_tally:
        (out_s, ttfa), t_s_dec = timed(torch, lambda: stream_decode(ft, torch, s32, PUSH, dev))
    launches_s_dec = {k.__name__: k.launches for k in kernels.KERNELS}
    (out_x, ttfa_x), t_s_exact = timed(
        torch, lambda: stream_decode(ft, torch, s32, PUSH, dev, exact=True))
    out_b, _ = ft.batch_decode(s32, i16_transfer=False, device=dev)
    if out_s.shape != out_b.shape or out_x.shape != out_b.shape:
        raise AssertionError(f"streaming decodes {out_s.shape}, {out_x.shape} against "
                             f"batch {out_b.shape}")
    d_sb = float(np.abs(out_s - out_b).max())
    if d_sb > STREAM_VS_BATCH_MAX_ABS:
        raise AssertionError(f"streaming decode differs from batch_decode by {d_sb} > "
                             f"{STREAM_VS_BATCH_MAX_ABS}")
    snr_s, snr_x = snr_db(pcm, out_s), snr_db(pcm, out_x)
    if not (np.isfinite(out_s).all() and np.isfinite(out_x).all()):
        raise AssertionError("streaming decode is not finite")
    if min(snr_s, snr_x) < SNR_FLOOR_DB:
        raise AssertionError(f"streaming SNR {snr_s:.4f} / exact {snr_x:.4f} dB below the "
                             f"floor {SNR_FLOOR_DB} dB")
    if launches_s_enc["power_quant"] <= 0 or launches_s_dec["overlap_add"] <= 0:
        raise AssertionError(f"streaming phase launches: encode {launches_s_enc}, "
                             f"decode {launches_s_dec}")
    n = len(frames)
    print(f"stream: enc {PUSH}-byte pushes {t_s_enc:.3f} s ({n / t_s_enc:.1f} frames/s), "
          f"enc one push {t_s_deep:.3f} s ({n / t_s_deep:.1f} frames/s), payloads differing "
          f"{differ} of {n}; dec {PUSH}-byte pushes {t_s_dec:.3f} s ({n / t_s_dec:.1f} "
          f"frames/s, first audio after {ttfa * 1e3:.2f} ms), dec exact {t_s_exact:.3f} s "
          f"({n / t_s_exact:.1f} frames/s, first audio after {ttfa_x * 1e3:.2f} ms); "
          f"max|stream - batch| {d_sb} (tolerance {STREAM_VS_BATCH_MAX_ABS}), SNR "
          f"{snr_s:.4f} / exact {snr_x:.4f} dB; frames per call: enc {enc_tally.used()}, "
          f"dec {dec_tally.used()}; launches enc {launches_s_enc}, dec {launches_s_dec}")

    kernels.reset_launches()
    armored_s, t_s_enc_e = timed(
        torch, lambda: stream_encode(ft, torch, raw, PUSH, dev, ecc=ECC_RATIO))
    damaged_s = damage_stream(armored_s)

    def repair_pushes() -> bytes:
        rep = ft.Repairer(ECC_RATIO)
        parts = [rep.process(damaged_s[i:i + PUSH]) for i in range(0, len(damaged_s), PUSH)]
        return b"".join(parts) + rep.flush()

    repaired_s, t_s_rep = timed(torch, repair_pushes)
    (fixed_s, _), t_s_fix = timed(
        torch, lambda: stream_decode(ft, torch, damaged_s, PUSH, dev, fix_error=True))
    clean_s, _ = stream_decode(ft, torch, armored_s, PUSH, dev, fix_error=True)
    launches_s_ecc = {k.__name__: k.launches for k in kernels.KERNELS}
    if damaged_s == armored_s or repaired_s != armored_s \
            or repaired_s != ft.batch_repair(damaged_s, ECC_RATIO):
        raise AssertionError("Repairer of the damaged stream differs from batch_repair or "
                             "from the armored stream")
    if fixed_s.shape != clean_s.shape or not np.array_equal(fixed_s, clean_s):
        raise AssertionError("fix_error streaming decode of the damaged stream differs from "
                             "the clean streaming decode")
    if snr_db(pcm, fixed_s) < SNR_FLOOR_DB or min(launches_s_ecc[k] for k in P1_KERNELS) <= 0:
        raise AssertionError(f"ECC streaming: SNR {snr_db(pcm, fixed_s):.4f} dB, launches "
                             f"{launches_s_ecc}")
    stream_launches = {k: launches_s_enc[k] + launches_s_dec[k] + launches_s_ecc[k]
                       for k in launches_s_enc}
    print(f"stream ecc {ECC_RATIO}: enc {t_s_enc_e:.3f} s ({n / t_s_enc_e:.1f} frames/s), "
          f"damaged {sum(a != b for a, b in zip(armored_s, damaged_s))} bytes, Repairer "
          f"{t_s_rep:.3f} s ({n / t_s_rep:.1f} frames/s) equal to batch_repair and the "
          f"armored stream, dec fix_error {t_s_fix:.3f} s ({n / t_s_fix:.1f} frames/s) equal "
          f"to the clean streaming decode, SNR {snr_db(pcm, fixed_s):.4f} dB, launches "
          f"{launches_s_ecc}")

    # 8. the lossless profiles 0 and 4, and Profile 1 above the GEMM's cap
    lossless = lossless_phase(ft, torch, kernels, native, dev)
    mid, long = lossless[f"p1_{P1_MID_FSIZE}"], lossless[f"p1_{P1_LONG_FSIZE}"]

    # 9. Profile 2 (TNS), and the lossy profiles at float64
    p2 = tns_phase(ft, torch, kernels, native, dev)
    tns_lanes = TNS_SHAPES["float32"][0][0]
    big = p2[(tns_lanes, "float32")]

    # 10. the command line, then the tally of egr_pack's and dequant's forms
    cli_phase(ft, torch, kernels, dev, pcm, smi)
    tally_stack.close()
    new_forms.require_held("the runs")
    print("forms at which the runs launched egr_pack and dequant, each held against its plain "
          "version above (form: launches): "
          + ", ".join(f"{f}: {c}" for f, c in sorted(new_forms.seen.items(), key=str)))

    yards = kernel_yardsticks(torch, {
        "power_quant_kernel": lambda: kernels.power_quant(f_d, d_d, factor),
        "overlap_add_kernel": lambda: kernels.overlap_add(pcm_k, w, CUT, True),
        **lossless["thunks"], **p2["thunks"], **new["thunks"]}, new["bounds"])

    def yard(name: str) -> dict:
        """The keys every kernel's entry carries beside its own times:
        its bound, `library_ms` (no single PyTorch call computes any of the
        eight functions), `device_ms_synthetic` (one launch on the check's
        inputs under the profiler, not the runs' data), and for the four
        kernels of the Profile 2 path their launches there."""
        out = {"bound_ms": yards["bounds"][name][0], "bound_by": yards["bounds"][name][1],
               "library_ms": None, "device_ms_synthetic": yards["device_ms"][name]}
        if name in P2_KERNELS:
            out.update(launches_p2=p2["launches"][name],
                       streaming_launches_p2=p2["stream_launches"][name])
        return out

    print(json.dumps({"kernels": [
        {"name": "power_quant", "route": "cuda",
         "source": "frad_python_tpu_torch/csrc/power_quant.cu",
         "replaces": "frad_python_tpu/research/pallas_kernels.py:58",
         "launches": launches["power_quant"], "max_abs_err": max(pq_err, pq_s_err),
         "ms": pq_ms, "plain_ms": pq_plain_ms,
         "streaming_launches": stream_launches["power_quant"],
         "ms_8192": mid["pq_ms"], "plain_ms_8192": mid["pq_plain_ms"],
         "ms_16384": long["pq_ms"], "plain_ms_16384": long["pq_plain_ms"],
         "ms_nodiv": p2["pq_nodiv_float32"][0], "plain_ms_nodiv": p2["pq_nodiv_float32"][1],
         "ms_f64": p2["pq_div_float64"][0], "plain_ms_f64": p2["pq_div_float64"][1],
         **yard("power_quant")},
        {"name": "overlap_add", "route": "cuda",
         "source": "frad_python_tpu_torch/csrc/overlap_add.cu",
         "replaces": "frad_python_tpu/research/pallas_kernels.py:90",
         "launches": launches["overlap_add"], "max_abs_err": max(oa_err, oa_s_err),
         "ms": oa[True][0], "plain_ms": oa[True][1],
         "ms_f32": oa[False][0], "plain_ms_f32": oa[False][1],
         "streaming_launches": stream_launches["overlap_add"],
         "ms_8192": mid["oa_ms"], "plain_ms_8192": mid["oa_plain_ms"],
         "ms_16384": long["oa_ms"], "plain_ms_16384": long["oa_plain_ms"],
         "ms_f64": p2["oa_f64"][0], "plain_ms_f64": p2["oa_f64"][1], **yard("overlap_add")},
        {"name": "trunc_pack", "route": "cuda",
         "source": "frad_python_tpu_torch/csrc/trunc_pack.cu",
         "replaces": "frad_python_tpu/ops/bitpack.py:184",
         "launches": lossless["launches"]["trunc_pack"], "max_abs_err": lossless["pack_err"],
         "ms": lossless["pack_ms"], "plain_ms": lossless["pack_plain_ms"],
         **yard("trunc_pack")},
        {"name": "trunc_unpack", "route": "cuda",
         "source": "frad_python_tpu_torch/csrc/trunc_unpack.cu",
         "replaces": "frad_python_tpu/ops/bitpack.py:218",
         "launches": lossless["launches"]["trunc_unpack"],
         "max_abs_err": lossless["unpack_err"],
         "ms": lossless["unpack_ms"], "plain_ms": lossless["unpack_plain_ms"],
         **yard("trunc_unpack")},
        {"name": "tns_iir", "route": "cuda",
         "source": "frad_python_tpu_torch/csrc/tns_iir.cu",
         "replaces": "frad_python_tpu/ops/tns_jax.py:96",
         "launches": p2["launches"]["tns_iir"], "max_abs_err": p2["iir_err"],
         "ms": big["iir"], "plain_ms": big["iir_plain"],
         "ms_f64": p2[(tns_lanes, "float64")]["iir"],
         "ms_8_lanes": p2[(8, "float32")]["iir"], **yard("tns_iir")},
        {"name": "tns_levinson", "route": "cuda",
         "source": "frad_python_tpu_torch/csrc/tns_levinson.cu",
         "replaces": "frad_python_tpu/ops/tns_jax.py:45",
         "launches": p2["launches"]["tns_levinson"], "max_abs_err": p2["lev_err"],
         "ms": big["lev"], "plain_ms": big["lev_plain"],
         "ms_f64": p2[(tns_lanes, "float64")]["lev"],
         "ms_8_lanes": p2[(8, "float32")]["lev"], **yard("tns_levinson")},
        {"name": "egr_pack", "route": "cuda",
         "source": "frad_python_tpu_torch/csrc/egr_pack.cu",
         "replaces": "frad_python_tpu/ops/bitpack.py:34",
         "launches": launches["egr_pack"], "max_abs_err": new["egr_err"],
         "ms": new["egr_ms"], "plain_ms": new["egr_plain_ms"],
         "ms_4_rows": new["egr_ms_4"], "plain_ms_4_rows": new["egr_plain_ms_4"],
         "streaming_launches": stream_launches["egr_pack"],
         "words_copied_back": main_egr_words, **yard("egr_pack")},
        {"name": "dequant", "route": "cuda",
         "source": "frad_python_tpu_torch/csrc/dequant.cu",
         "replaces": "frad_python_tpu/models/batch.py:350",
         "launches": launches["dequant"], "max_abs_err": new["deq_err"],
         "ms": new["deq_ms"], "plain_ms": new["deq_plain_ms"],
         "ms_4_frames": new["deq_4_ms"], "plain_ms_4_frames": new["deq_4_plain_ms"],
         "streaming_launches": stream_launches["dequant"], **yard("dequant")},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
