"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `frad_python_tpu_torch/csrc/` and its
C++ host module from `frad_python_tpu_torch/native/`, holds each kernel
against its plain PyTorch version at the main path's shapes, then drives
the Profile 1 main path (44.1 kHz stereo, 16-bit, 2048-sample frames,
overlap ratio 16) end to end on the card through `batch_encode` /
`batch_decode`, decodes the card's stream again on the CPU for
comparison, and drives the same track with ECC armor at (96, 24) through
damage, `batch_repair` and an error-correcting `batch_decode`. Every
phase prints one line; any failure exits non-zero. The second-to-last
line is a JSON object with one entry per kernel, the last line
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

    print(json.dumps({"kernels": [
        {"name": "power_quant", "route": "cuda",
         "source": "frad_python_tpu_torch/csrc/power_quant.cu",
         "replaces": "frad_python_tpu/research/pallas_kernels.py:58",
         "launches": launches["power_quant"], "max_abs_err": pq_err,
         "ms": pq_ms, "plain_ms": pq_plain_ms},
        {"name": "overlap_add", "route": "cuda",
         "source": "frad_python_tpu_torch/csrc/overlap_add.cu",
         "replaces": "frad_python_tpu/research/pallas_kernels.py:90",
         "launches": launches["overlap_add"], "max_abs_err": oa_err,
         "ms": oa[True][0], "plain_ms": oa[True][1],
         "ms_f32": oa[False][0], "plain_ms_f32": oa[False][1]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
