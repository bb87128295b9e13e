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
against their plain versions at the streaming shapes first. Every phase
prints one line; any failure exits non-zero. The second-to-last line is
a JSON object with one entry per kernel, the last line
`{"ok": true, "device": {...}}`. Needs a CUDA device, nvcc and g++, and
refuses to run with FRAD_TORCH_NO_NATIVE set; imports neither jax nor
the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
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
# the main path's shapes for 30 s: 688 uniform frames + a tail frame
# padded to 2048, encoded as two batches and decoded as one run
POWER_QUANT_SHAPE = (1376, 2048)         # R = uniform frames * channels, N bins
OVERLAP_SHAPE = (689, 2, 2048)           # IDCT output [B, C, N]
OLAP, CUT = 128, 1920
ECC_RATIO = (96, 24)
DEVICE = "cuda"
# the streaming engines' shapes: one frame per call on the per-frame path,
# 2..256 frames per micro-batch; the decoder's micro-batches emit float32
STREAM_POWER_QUANT_SHAPES = ((2, 2048), (512, 2048))
STREAM_OVERLAP_CASES = ((2, OLAP, CUT), (256, OLAP, CUT), (256, 0, 2048))   # (B, olap, cut)
PUSH = 32768
#: the streaming decode against batch_decode(..., i16_transfer=False) of
#: the same stream: other batch sizes reach the IDCT GEMM, so float32
#: sums differ by a few ulps of |pcm| < 2
STREAM_VS_BATCH_MAX_ABS = 2e-6


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
        got = kernels.power_quant(f_d, d_d, 2.0 ** 15)
        want = kernels.power_quant_plain(f_d, d_d, 2.0 ** 15)
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
        out_k, frag_k = kernels.overlap_add(pcm_k, w, cut, False)
        out_p, frag_p = kernels.overlap_add_plain(pcm_k, w, cut, False)
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
    by wrapping the module functions they call for the `with` block."""

    def __init__(self, pipeline, profile1):
        self.targets = [(pipeline, "batch_encode", "enc_batch"),
                        (pipeline, "_decode_run", "dec_batch"),
                        (profile1, "analogue", "enc_frame"),
                        (profile1, "digital", "dec_frame")]
        self.seen: dict[str, dict[int, int]] = {}

    def __enter__(self):
        self.saved = [getattr(mod, name) for mod, name, _ in self.targets]
        self.seen = {key: {} for _, _, key in self.targets}

        def wrap(fn, key):
            def counted(arg, *args, **kwargs):
                # frames: span length on the overlap grid, or header count
                k = ((len(arg) - OLAP) // CUT if key == "enc_batch"
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
    got = kernels.power_quant(f_d, d_d, factor)
    want = kernels.power_quant_plain(f_d, d_d, factor)
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
        out_k, frag_k = kernels.overlap_add(pcm_k, w, CUT, i16)
        out_p, frag_p = kernels.overlap_add_plain(pcm_k, w, CUT, i16)
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

    # 4. the slice end to end on the card
    pcm = make_audio(SECONDS, SRATE, CHANNELS)
    warm = make_audio(1.0, SRATE, CHANNELS)          # first-use set-up outside the timing
    ft.batch_decode(ft.batch_encode(warm, 1, SRATE, BITS, FSIZE, i16_upload=True, device=dev),
                    i16_transfer=True, device=dev)
    torch.cuda.synchronize()

    kernels.reset_launches()
    native.reset_calls()
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
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched by the main path")
    for name in ("p1_pack_batch", "frame_pack_batch", "frame_parse_batch", "p1_unpack_batch"):
        if calls[name] <= 0:
            raise AssertionError(f"native {name} was not called by the main path")
    print(f"slice: {len(frames)} frames + {terms} terminators, {len(stream)} bytes, "
          f"{out.shape[0]} samples, SNR {snr:.4f} dB (floor {SNR_FLOOR_DB}), "
          f"enc {len(frames) / t_enc:.1f} frames/s ({t_enc:.3f} s), "
          f"dec {len(frames) / t_dec:.1f} frames/s ({t_dec:.3f} s), launches {launches}, "
          f"native calls {calls}")

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
    for name, n in launches_e.items():
        if n <= 0:
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
    if snr_db(pcm, fixed_s) < SNR_FLOOR_DB or min(launches_s_ecc.values()) <= 0:
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

    print(json.dumps({"kernels": [
        {"name": "power_quant", "route": "cuda",
         "source": "frad_python_tpu_torch/csrc/power_quant.cu",
         "replaces": "frad_python_tpu/research/pallas_kernels.py:58",
         "launches": launches["power_quant"], "max_abs_err": max(pq_err, pq_s_err),
         "ms": pq_ms, "plain_ms": pq_plain_ms,
         "streaming_launches": stream_launches["power_quant"]},
        {"name": "overlap_add", "route": "cuda",
         "source": "frad_python_tpu_torch/csrc/overlap_add.cu",
         "replaces": "frad_python_tpu/research/pallas_kernels.py:90",
         "launches": launches["overlap_add"], "max_abs_err": max(oa_err, oa_s_err),
         "ms": oa[True][0], "plain_ms": oa[True][1],
         "ms_f32": oa[False][0], "plain_ms_f32": oa[False][1],
         "streaming_launches": stream_launches["overlap_add"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
