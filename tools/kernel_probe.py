"""Device times of the redesigned kernels on one CUDA card, warm, with the
SM clock they ran at and what the compiler made of them.

    python3 tools/kernel_probe.py [--tree DIR] [--parent DIR] [SECTION ...]

SECTIONs (default: all, in this order):

* `tns_iir`: at chip_smoke.py's TNS_SHAPES, float32 and float64,
  bit-equal to its plain version or not, and the mean device time of REPS
  launches from one `torch.profiler` call; then the SM clock and power
  draw `nvidia-smi` reads while `tns_iir` at [8, 2048] runs back to back,
  so that a time can be read as cycles a step (time * clock / samples);
* `egr_pack`: at chip_smoke.py's EGR_FORMS, words equal to plain or not,
  and the mean device time of each of its kernels over REPS launches (the
  symbols are in L2 from the launch before, unlike chip_smoke.py's single
  launch);
* `i24`: `i24_pack` (transposed view and contiguous) and `i24_unpack` at
  I24_SHAPES likewise;
* `trunc_pack`: at chip_smoke.py's TRUNC_SHAPES and TRUNC_ODD_SHAPES (the
  kernel's paths for C = 1 and for rows that are not whole 16-byte
  pieces; the codec shapes alone in an older tree), bits
  16/24/32 and both byte orders: every payload word but the NaN's and
  max|x| equal to plain or not; mean device time at 24 bits, big-endian;
* `trunc_unpack`: on `chip_smoke.trunc_random_words` at TRUNC_SHAPES and
  TRUNC_ODD_SHAPES, bits 16/24/32 and both byte orders: bit-equal to
  plain or not, and the mean device time at TRUNC_SHAPES, big-endian, of
  this tree's kernel through its wrapper, of the same source with each
  choice of `TRUNC_UNPACK_VARIANTS` turned the other way (at the channel
  counts it changes), of each build at `TRUNC_UNPACK_BLOCKS` threads a
  block (24 bits) and, with `--parent DIR`, of that tree's
  trunc_unpack.cu (each built alone, from a patched temporary copy for a
  variant); then ptxas's registers, stack and spill
  stores of every build's kernels and the SASS of this tree's and the
  parent's: operations, integer divisions by a run-time value
  (`INT_DIVISION`) and 16-byte loads and stores;
* `tns_autocorr`: at TNS_SHAPES, float32 and float64, with a divisor, at
  each dtype's first shape without, and on storage-offset views whose
  rows are not 16-byte aligned: x, ac and
  gate bit-equal to plain or not; mean device time of each;
* `autocorr_variants`: csrc/tns_autocorr.cu as built and with each of its
  choices turned the other way, alone and together (see
  `autocorr_sources`), each built by its own nvcc with `-Xptxas -v`:
  registers and spills of each kernel, bit-equality with plain and the
  mean device time at [8, 2048] and [1378, 2048] with a divisor, float32
  and float64, timed twice (variants in order, then in reverse order),
  beside the package's own library through its wrapper;
  then, from a second build of each with `clock64()` stamps at the
  kernel's barriers (thread 0 of every block), the mean cycles a block
  spends in each phase (`PHASES`) at float32, and in µs at the SM clock
  read while the kernel as built runs back to back;
* `fir_gate`: `tns_fir_gate` on `tns_autocorr`'s output at TNS_SHAPES,
  float32 and float64, on storage-offset views at each dtype's first
  shape and at 8 lanes, and at FIR_GATE_EXTRA_FORMS where the tree has
  them: out, lpc_out and run equal to plain or not, and the mean device
  time of a launch; in a tree whose Levinson recursion is a launch of its
  own (`kernels.tns_levinson`), of that launch and `tns_fir_gate` on its
  LPC, and their sum;
* `fir_gate_variants`: csrc/tns_fir_gate.cu as built and with runs of 8
  outputs a thread (FIR_TILE) or other residency hints (FIR_MIN_BLOCKS_F32
  / _F64; `FIR_VARIANTS`), each
  built by its own nvcc with `-Xptxas -v`: registers and spills of each
  kernel, bit-equality with plain and the mean device time at [8, 2048]
  and [1378, 2048], float32 and float64, timed twice (variants in order,
  then in reverse order), beside the package's library; then, from a build
  with `clock64()` stamps at the kernel's phases (thread 0 of every block,
  PHASE_STAMP), the mean cycles a block spends in each phase
  (`FIR_PHASES`) at float32, and in µs at the SM clock read while the
  kernel as built runs back to back;
* `thres`: `mask_thres` (spectra [R, 2048] -> divisor and symbols) at 8
  and 1376 rows and `thres_expand` (symbols -> divisor [B, 2, 2048]) at 4
  and 689 frames, float32 and float64: equal to plain or not, the mean
  device time of a call (every kernel it runs); `mask_thres` float32
  again at 128 to 1024 threads a block (the C entry takes them), and the
  cycles of a block's phases from a build with `clock64()` stamps
  (`MASK_PHASES`); with `--parent DIR` (a
  `git archive` of a tree whose chains were six and two launches), that
  tree's `mask_thres.cu` and `thres_expand.cu` built beside and its
  chains timed in this process on the same inputs: abs, * factor, the
  square, the band-sum GEMM, its `mask_thres` and the interpolation GEMM;
  its `thres_expand` and the interpolation GEMM;
* `thres_registers`: the registers and spills of every `mask_thres` and
  `thres_expand` kernel (`-Xptxas -v`);
* `flips` (needs `--parent`): chip_smoke.py's 30 s track framed as
  `batch_encode` frames it (688 uniform frames), through the DCT, then the
  parent's threshold chain and this tree's, each followed by the rest of
  the Profile 1 core (int16 upload, `power_quant`) and of the Profile 2
  core (float32, the TNS analysis, `power_quant` without a divisor): the
  symbols that differ between the two (threshold, frequency, LPC), and the
  largest relative difference of the divisors; the decoders' divisors of
  the same symbols through the parent's `thres_expand` + GEMM and this
  tree's `thres_expand`;
* `decode`: `dequant` with threshold symbols (int16 symbols at float32,
  and float64) and `overlap_add` (float32 with the int16 and the float32
  emit, float64) at 4 and 689 frames of [2048, 2]: equal to plain or
  not, the mean device time of a call, and `dequant` without thresholds;
  with `--parent DIR` (a `git archive` of a tree whose Profile 1 decode
  was `thres_expand` then `dequant` with the divisor), that tree's
  `dequant.cu`, `thres_expand.cu` and `overlap_add.cu` built beside, its
  pair and its `overlap_add` timed in this process on the same inputs,
  and their outputs held bit for bit against this tree's; then the SASS
  of every `dequant` and `overlap_add` kernel of both trees: operations,
  integer divisions by a run-time value (`INT_DIVISION`), calls, and
  16-byte loads and stores;
* `decode_variants`: csrc/dequant.cu and csrc/overlap_add.cu as built and
  with each choice of `DECODE_VARIANTS` turned the other way (the source
  text patched into a temporary copy, each built by its own nvcc, all
  started together), bit-equality with plain and the mean device
  time of the `decode` section's calls through the wrappers, timed twice
  (variants in order, then in reverse order);
* `decode_registers`: the registers and spills of every `dequant` and
  `overlap_add` kernel (`-Xptxas -v`);
* `trace`: six hand kernels on small inputs in one `torch.profiler`
  window, three windows of each way of opening it (one lead kernel, as
  an older `chip_smoke.profiled_device_ms` did, none, a synchronize, 1 or
  5 ms of host time after the start, a schedule's warmup step, and
  `chip_smoke.profiled_device_ms` as it is): which kernels each window
  recorded; then TRACE_WINDOWS recordings each after a warmup step, of
  the calls once or twice, with or without chip_smoke.py's lead kernels
  (`chip_smoke.profiled_device_ms`: the leads, the calls once): the
  kernels each lost; and TRACE_WINDOWS runs of `chip_smoke.kept_device_ms`
  (recorded again until every kernel is kept): the recordings each made
  and the kernels still lost;
* `sass`: the opcode counts of the float32 `tns_iir` kernel, the 24-bit
  C = 2 `trunc_pack` kernel, the float32 8-step `tns_autocorr` kernel
  and the float32 2048-sample `tns_fir_gate` kernel from
  `cuobjdump -sass`.

`--tree DIR` imports the port and chip_smoke.py from another checkout
(a parent's `git archive`), so that two trees are timed by the same
probe in one call; the sections above must exist there (`trunc_pack` and
`tns_autocorr` do in every tree of the port since their kernels came).

Prints the card's name and power limit first. Needs a CUDA device and
nvcc; any mismatch exits non-zero.
"""

from __future__ import annotations

import collections
import ctypes
import importlib
import itertools
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch

REPS = 10
SECTIONS = ("tns_iir", "egr_pack", "i24", "trunc_pack", "trunc_unpack", "tns_autocorr",
            "autocorr_variants", "fir_gate", "fir_gate_variants", "thres", "thres_registers",
            "flips", "decode", "decode_variants", "decode_registers", "trace", "sass")


def device_us(fn, names: tuple[str, ...]) -> dict:
    """{name: mean device time in µs of the kernels whose name holds it}
    over REPS calls of `fn` in one profiler call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        for n in names:
            if n in e.key:
                us = max(getattr(e, a, 0) or 0 for a in ("self_device_time_total",
                                                        "device_time_total"))
                out[n] = round(out.get(n, 0.0) + us / REPS, 2)
    return out


def call_us(fn) -> float:
    """Mean device time in µs of every kernel that one call of `fn` runs:
    REPS calls recorded after a profiler warmup step of REPS calls (a fresh
    recording drops its first kernels, `trace`); each kernel's mean over the
    launches the trace kept, times its launches a call (counted when more
    than REPS were kept), summed, so that a dropped record does not read as
    a faster call; a recording that kept none is taken again (up to three
    times) and reads 0 if none keeps any."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for _ in range(3):                      # a recording that kept no kernel is taken again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        kept = collections.defaultdict(list)
        for e in prof.events():
            # (the step's own span on the device timeline is no kernel)
            if e.device_type == DeviceType.CUDA \
                    and not e.name.startswith(("Memcpy", "Memset", "ProfilerStep")):
                kept[e.name].append(e.time_range.elapsed_us())
        if kept:
            break
    return round(sum(sum(v) / len(v) * max(1, round(len(v) / REPS)) for v in kept.values()), 2)


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def probe_tns_iir(cs, kernels, dev) -> bool:
    ok = True
    for dtype, shapes in cs.TNS_SHAPES.items():
        for lanes, n in shapes:
            x, c, _ = (torch.from_numpy(a).to(dev)
                       for a in cs.tns_inputs(lanes, n, dtype, 31 + lanes))
            same = cs.bits_equal(torch, kernels.tns_iir(x, c), kernels.tns_iir_plain(x, c))
            ok &= same
            print(f"tns_iir {dtype} {(lanes, n)}: {'equal' if same else 'DIFFERS'}, device "
                  f"{device_us(lambda: kernels.tns_iir(x, c), ('tns_iir',))} us")

    x, c, _ = (torch.from_numpy(a).to(dev) for a in cs.tns_inputs(8, 2048, "float32", 39))
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            for _ in range(200):
                kernels.tns_iir(x, c)
            torch.cuda.synchronize()

    worker = threading.Thread(target=spin)
    worker.start()
    time.sleep(0.5)
    for _ in range(3):
        print(f"under tns_iir [8, 2048] back to back: {smi('clocks.sm,power.draw')}")
        time.sleep(0.3)
    stop.set()
    worker.join()
    return ok


def probe_egr_pack(cs, kernels, dev) -> bool:
    ok = True
    for fi, (rows, m) in enumerate(cs.EGR_FORMS):
        max_words = max(m * 12 // 32, 16)
        sym = torch.from_numpy(cs.egr_inputs(rows, m, 500 + fi)).to(dev)
        got, want = kernels.egr_pack(sym, max_words), kernels.egr_pack_plain(sym, max_words)
        same = all(g.shape == w.shape and torch.equal(g, w) for g, w in zip(got, want))
        ok &= same
        us = device_us(lambda: kernels.egr_pack(sym, max_words),
                       ("egr_lengths", "egr_offsets", "egr_pack_kernel"))
        print(f"egr_pack {(rows, m)}: {'equal' if same else 'DIFFERS'}, device {us} us, "
              f"together {sum(us.values()):.2f}")
    return ok


def probe_i24(cs, kernels, dev) -> bool:
    ok = True
    for si, shape in enumerate(cs.I24_SHAPES):
        view = torch.from_numpy(cs.i24_inputs(shape, 240 + si)).to(dev).transpose(1, 2)
        for name, pcm in (("view", view), ("contiguous", view.contiguous())):
            words = kernels.i24_pack(pcm)
            same = torch.equal(words, kernels.i24_pack_plain(pcm))
            ok &= same
            print(f"i24_pack {shape} {name}: {'equal' if same else 'DIFFERS'}, device "
                  f"{device_us(lambda: kernels.i24_pack(pcm), ('i24_pack',))} us")
        same = cs.bits_equal(torch, kernels.i24_unpack(words), kernels.i24_unpack_plain(words))
        ok &= same
        print(f"i24_unpack {tuple(words.shape)}: {'equal' if same else 'DIFFERS'}, device "
              f"{device_us(lambda: kernels.i24_unpack(words), ('i24_unpack',))} us")
    return ok


def probe_trunc_pack(cs, kernels, dev) -> bool:
    ok = True
    for si, shape in enumerate(cs.TRUNC_SHAPES + getattr(cs, "TRUNC_ODD_SHAPES", ())):
        b, c, n = shape
        y = torch.from_numpy(cs.trunc_inputs(shape, 99 + si)).to(dev)
        bad = []
        for bits in (16, 24, 32):
            if bits == 24 and (c * n) % 4:
                continue
            keep = ~cs.nan_words(torch, y, bits)
            for little in (False, True):
                w_k, m_k = kernels.trunc_pack(y, bits, little)
                w_p, m_p = kernels.trunc_pack_plain(y, bits, little)
                if not (w_k.shape == w_p.shape and torch.equal(w_k[keep], w_p[keep])
                        and torch.equal(m_k.nan_to_num(-1.0), m_p.nan_to_num(-1.0))):
                    bad.append((bits, little))
        ok &= not bad
        us = device_us(lambda: kernels.trunc_pack(y, 24 if (c * n) % 4 == 0 else 16, False),
                       ("trunc_pack",))
        print(f"trunc_pack {shape}: {'equal' if not bad else f'DIFFERS at {bad}'} (bits 16/24/32, "
              f"both orders), device at {24 if (c * n) % 4 == 0 else 16} bits {us} us")
    return ok


def offset_view(a):
    """a copy of `a` that starts one element past a 16-byte boundary"""
    buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)
    buf[1:].view(a.shape).copy_(a)
    return buf[1:].view(a.shape)


def same_results(cs, got, want) -> bool:
    return all(torch.equal(g, w) if g.dtype == torch.bool else cs.bits_equal(torch, g, w)
               for g, w in zip(got, want))


def probe_tns_autocorr(cs, kernels, dev) -> bool:
    from frad_python_tpu_torch.ops import tns

    ok = True

    for dtype, shapes in cs.TNS_SHAPES.items():
        window = tns._lag_window(getattr(torch, dtype), dev)
        for si, (lanes, n) in enumerate(shapes):
            freqs, div = (torch.from_numpy(a).to(dev)
                          for a in cs.analysis_inputs(lanes, n, dtype, 900 + lanes))
            forms = [("divisor", freqs, div)]
            if si == 0:
                forms.append(("no divisor", freqs, None))
            if si == 0 or lanes == 8:
                forms.append(("divisor, offset views", offset_view(freqs), offset_view(div)))
            for name, f, d in forms:
                same = same_results(cs, kernels.tns_autocorr(f, d, window),
                                    kernels.tns_autocorr_plain(f, d, window))
                ok &= same
                us = device_us(lambda: kernels.tns_autocorr(f, d, window), ("tns_autocorr",))
                print(f"tns_autocorr {dtype} {(lanes, n)} {name}: "
                      f"{'equal' if same else 'DIFFERS'}, device {us} us")
    return ok


#: the phases of a tns_autocorr block, each ended by a barrier
PHASES = ("load, divide, x out", "sums of x, x^2, |x|, log", "centred energy, gate",
          "centre, normalise", "13 lags, their warp sums")
#: (anchors in the source, text put after the one it holds) for the
#: stamps of `with_stamps`; the stamp k > 0 closes PHASES[k - 1] (the
#: anchors of the load's end: the kernel's forms, the last with the bulk
#: copy)
STAMPS = (
    (("    const int tid = threadIdx.x;\n",),
     "    long long probe_t = 0;\n    probe_stamp(0, probe_t);\n"),
    (("        row[idx] = x;\n    }\n    __syncthreads();\n",
      "                row[idx] = x;\n            }\n        }\n    }\n    __syncthreads();\n",
      "        for (int v = tid; v < (int)(n * sizeof(T) / 16); v += NT) "
      "dst[v] = src[v];\n    }\n"),
     "    probe_stamp(1, probe_t);\n"),
    (("        warp_sums<T, 1>(s, sc1, 4, 3);\n    }\n    __syncthreads();\n",),
     "    probe_stamp(2, probe_t);\n"),
    (("        gate_out[r] = (uint8_t)(g && tree_sum(sc1, 4, 1) >= tiny);\n    }\n"
      "    __syncthreads();\n",),
     "    probe_stamp(3, probe_t);\n"),
    (("        row[idx] = scale ? div_rn(sig, norm) : sig;\n    }\n    __syncthreads();\n",),
     "    probe_stamp(4, probe_t);\n"),
    (("    warp_sums<T, LAGS0>(acc, sc3, LAG_KT, l0);\n    __syncthreads();\n",),
     "    probe_stamp(5, probe_t);\n"))
STAMP_HEAD = """
__device__ unsigned long long probe_clk[8];   // cycles of each phase; [7]: blocks
__device__ __forceinline__ void probe_stamp(int k, long long& t) {
    if (threadIdx.x != 0) return;
    const long long c = clock64();
    if (k > 0) atomicAdd(&probe_clk[k - 1], (unsigned long long)(c - t));
    else atomicAdd(&probe_clk[7], 1ull);
    t = c;
}
"""
STAMP_TAIL = """
extern "C" int probe_clocks(unsigned long long* host) {   // read, then zero
    cudaError_t e = cudaMemcpyFromSymbol(host, probe_clk, sizeof(probe_clk));
    if (e != cudaSuccess) return (int)e;
    const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    return (int)cudaMemcpyToSymbol(probe_clk, zero, sizeof(zero));
}
"""


def autocorr_sources(text: str) -> dict:
    """{label: source}: the tns_autocorr source `text` as built (the first
    entry) and with each of its choices that it holds turned the other way,
    alone and together: the block's residency hint (`__launch_bounds__` as
    built, or `(NT, 4)` where it is `(NT)` and `(NT)` otherwise),
    compile-time steps for 2048-sample rows (or every row's
    steps counted at run time), and the bulk copy of aligned rows (or
    element-wise loads for every row)."""
    hint = re.search(r"__launch_bounds__\((NT.*)\)\ntns_autocorr_kernel", text)
    steps = re.search(r"    if \(n >= 7 \* SUM_T \+ ORDER1 - 1 && n <= 8 \* SUM_T\)[^\n]*\n"
                      r"        return go<T, (?:BULK, )?8>\([^\n]*\n", text)
    steps = steps.group(0) if steps else None
    bulk = "    if (aligned && bulk <= SMEM_LIMIT)\n"
    axes = []
    if hint:
        other = "NT, 4" if hint.group(1) == "NT" else "NT"
        axes.append(((f"bounds ({hint.group(1)})", f"bounds ({other})"), hint.group(0),
                     hint.group(0).replace(hint.group(1), other)))
    if steps:
        axes.append((("8 steps", "run-time steps"), steps, ""))
    if bulk in text:
        axes.append((("bulk copy", "element-wise"), bulk, "    if (false)\n"))
    out = {}
    for flips in itertools.product((0, 1), repeat=len(axes)):
        src, labels = text, []
        for flip, (names, old, new) in zip(flips, axes):
            src = src.replace(old, new) if flip else src
            labels.append(names[flip])
        out[", ".join(labels)] = src
    return out


def with_stamps(src: str) -> str:
    """`src` with a clock64() stamp by thread 0 after each barrier that
    ends a phase (STAMPS) and the `probe_clocks` entry."""
    head = '#include "tns_reduce.cuh"\n'
    if src.count(head) != 1:
        raise AssertionError("autocorr_variants: the source's include moved")
    src = src.replace(head, head + STAMP_HEAD)
    for anchors, stamp in STAMPS:
        held = [a for a in anchors if src.count(a) == 1]
        if len(held) != 1 or any(src.count(a) > 1 for a in anchors):
            raise AssertionError(f"autocorr_variants: no stamp anchor held once: {anchors!r}")
        src = src.replace(held[0], held[0] + stamp)
    return src + STAMP_TAIL


def ptxas_registers(log: str) -> dict:
    """{"f32 S=8": "32 (spill 0)", ...} from `-Xptxas -v` output (a tree
    whose kernel has the bulk copy: "f32 bulk S=8", "f32 elem S=8", ...)."""
    out, name, spill = {}, None, "?"
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            name = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores", line):
            spill = m.group(1)
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            k = re.search(r"tns_autocorr_kernelI([fd])(?:Lb([01])E)?Li(\d+)E", name)
            if k:
                path = {"1": "bulk ", "0": "elem ", None: ""}[k[2]]
                out[f"{'f32' if k[1] == 'f' else 'f64'} {path}S={k[3]}"] = \
                    f"{m.group(1)} (spill {spill})"
    return out


def probe_autocorr_variants(cs, kernels, dev, build) -> bool:
    from frad_python_tpu_torch.ops import tns

    sources = autocorr_sources((build.CSRC_DIR / "tns_autocorr.cu").read_text())
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=build.BUILD_DIR))
    try:
        jobs = {}
        for i, (label, src) in enumerate(sources.items()):
            for stamped in (False, True):
                cu = tmp / f"ac{i}{'_stamped' if stamped else ''}.cu"
                cu.write_text(with_stamps(src) if stamped else src)
                cmd = [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
                       str(build.CSRC_DIR), "-o", str(cu.with_suffix(".so")), str(cu)]
                jobs[label, stamped] = (cu.with_suffix(".so"), subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        libs = {}
        for (label, stamped), (so, proc) in jobs.items():
            out, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc {label} stamped={stamped}:\n{err}")
            lib = ctypes.CDLL(str(so))
            lib.frad_tns_autocorr.argtypes = list(build.SIGNATURES["frad_tns_autocorr"])
            lib.frad_tns_autocorr.restype = ctypes.c_int
            if stamped:
                lib.probe_clocks.argtypes = [ctypes.c_void_p]
                lib.probe_clocks.restype = ctypes.c_int
            else:
                print(f"tns_autocorr [{label}] registers: {ptxas_registers(out + err)}")
            libs[label, stamped] = lib

        ok, forms = True, {}
        for dtype in ("float32", "float64"):
            window = tns._lag_window(getattr(torch, dtype), dev)
            for lanes in (8, 1378):
                f, d = (torch.from_numpy(a).to(dev)
                        for a in cs.analysis_inputs(lanes, 2048, dtype, 900 + lanes))
                want = kernels.tns_autocorr_plain(f, d, window)
                forms[dtype, lanes] = (f, d, window, want)

        def call(lib, f, d, window):
            x, ac = torch.empty_like(f), f.new_empty((f.shape[0], 13))
            gate = torch.empty(f.shape[0], dtype=torch.bool, device=dev)
            err = lib.frad_tns_autocorr(*(ctypes.c_void_p(t.data_ptr())
                                          for t in (f, d, window, x, ac, gate)),
                                        f.shape[0], f.shape[1], int(f.dtype == torch.float64),
                                        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            build.check("frad_tns_autocorr (variant)", err)
            return x, ac, gate

        runs = {label: lambda f, d, w, lib=libs[label, False]: call(lib, f, d, w)
                for label in sources}
        runs["the package's library"] = kernels.tns_autocorr
        times = collections.defaultdict(list)
        labels = list(runs)
        for order in (labels, labels[::-1]):
            for label in order:
                run = runs[label]
                for (dtype, lanes), (f, d, window, want) in forms.items():
                    got = run(f, d, window)
                    same = all(torch.equal(g, w) if g.dtype == torch.bool
                               else cs.bits_equal(torch, g, w) for g, w in zip(got, want))
                    ok &= same
                    if not same:
                        print(f"tns_autocorr [{label}] {dtype} [{lanes}, 2048] DIFFERS from plain")
                    us = device_us(lambda: run(f, d, window), ("tns_autocorr",))
                    times[label, dtype, lanes].append(us.get("tns_autocorr"))
        for (dtype, lanes) in forms:
            print(f"tns_autocorr {dtype} [{lanes}, 2048] + divisor, device us (in order; "
                  f"reversed): "
                  + "; ".join(f"[{label}] {times[label, dtype, lanes][0]}, "
                              f"{times[label, dtype, lanes][1]}" for label in labels))

        f, d, window, _ = forms["float32", 1378]
        mhz = sm_mhz_under(lambda: runs[labels[0]](f, d, window))
        clk = (ctypes.c_ulonglong * 8)()
        for label in sources:
            lib = libs[label, True]
            for lanes in (8, 1378):
                f, d, window, _ = forms["float32", lanes]
                call(lib, f, d, window)
                torch.cuda.synchronize()
                build.check("probe_clocks", lib.probe_clocks(clk))      # zeroes them
                for _ in range(REPS):
                    call(lib, f, d, window)
                torch.cuda.synchronize()
                build.check("probe_clocks", lib.probe_clocks(clk))
                blocks = clk[7]
                cyc = [clk[k] / blocks for k in range(len(PHASES))]
                print(f"tns_autocorr [{label}] float32 [{lanes}, 2048] phases, mean cycles a "
                      f"block (µs at {mhz} MHz), {blocks} blocks: "
                      + "; ".join(f"{p} {c:.0f} ({c / mhz:.3f})" for p, c in zip(PHASES, cyc))
                      + f"; all {sum(cyc):.0f} ({sum(cyc) / mhz:.3f})")
        return ok
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def fir_gate_inputs(cs, kernels, dtype: str, lanes: int, n: int, dev):
    """(x, ac, gate) of `tns_autocorr` on chip_smoke.py's analysis rows."""
    from frad_python_tpu_torch.ops import tns

    freqs, div = (torch.from_numpy(a).to(dev)
                  for a in cs.analysis_inputs(lanes, n, dtype, 900 + lanes))
    return kernels.tns_autocorr(freqs, div, tns._lag_window(freqs.dtype, dev))


def probe_fir_gate(cs, kernels, dev) -> bool:
    fused = not callable(getattr(kernels, "tns_levinson", None))
    ok = True
    forms = [(dtype, shape, si == 0 or shape[0] == 8)
             for dtype, shapes in cs.TNS_SHAPES.items() for si, shape in enumerate(shapes)]
    forms += [(dtype, shape, False) for dtype, shape in getattr(cs, "FIR_GATE_EXTRA_FORMS", ())]
    for dtype, (lanes, n), offset in forms:
        x, ac, gate = fir_gate_inputs(cs, kernels, dtype, lanes, n, dev)
        if fused:
            want = kernels.tns_fir_gate_plain(x, ac, gate)
            calls = [("aligned", lambda x=x: kernels.tns_fir_gate(x, ac, gate))]
            if offset:
                xo, aco, go = offset_view(x), offset_view(ac), offset_view(gate)
                calls.append(("offset views", lambda: kernels.tns_fir_gate(xo, aco, go)))
            names = ("tns_fir_gate",)
        else:
            lpc = kernels.tns_levinson_plain(ac)
            want = kernels.tns_fir_gate_plain(x, lpc, gate)
            calls = [("aligned",
                      lambda: kernels.tns_fir_gate(x, kernels.tns_levinson(ac), gate))]
            names = ("tns_levinson", "tns_fir_gate")
        for name, call in calls:
            same = same_results(cs, call(), want)
            ok &= same
            us = device_us(call, names)
            print(f"tns_fir_gate {dtype} {(lanes, n)} {name}{'' if fused else ' (two launches)'}: "
                  f"{'equal' if same else 'DIFFERS'}, device {us} us, together "
                  f"{sum(us.values()):.2f}")
    return ok


#: the phases of a tns_fir_gate block (PHASE_STAMP k closes FIR_PHASES[k - 1])
FIR_PHASES = ("lags and recursion", "quantise", "row wait", "FIR", "sums, max, finite",
              "centred energies", "gain and store")
#: the builds `fir_gate_variants` times beside the source as built: runs of
#: 8 outputs a thread, and other residency hints (blocks of 256 an SM, 1:
#: none) by dtype
FIR_VARIANTS = {
    "runs of 8": ["-DFIR_TILE=8"], "f32 no hint": ["-DFIR_MIN_BLOCKS_F32=1"],
    "f32 hint 5": ["-DFIR_MIN_BLOCKS_F32=5"], "f64 no hint": ["-DFIR_MIN_BLOCKS_F64=1"]}
FIR_STAMPS = """
__device__ unsigned long long probe_clk[16];  // [k]: cycles of phase k; [8 + k]: blocks
__device__ __forceinline__ void probe_stamp(int k) {
    __shared__ long long probe_last;
    if (threadIdx.x != 0) return;
    const long long c = clock64();
    if (k > 0) {
        atomicAdd(&probe_clk[k - 1], (unsigned long long)(c - probe_last));
        atomicAdd(&probe_clk[8 + k - 1], 1ull);
    }
    probe_last = c;
}
#define PHASE_STAMP(k) probe_stamp(k)
extern "C" int probe_clocks(unsigned long long* host) {   // read, then zero
    cudaError_t e = cudaMemcpyFromSymbol(host, probe_clk, sizeof(probe_clk));
    if (e != cudaSuccess) return (int)e;
    const unsigned long long zero[16] = {};
    return (int)cudaMemcpyToSymbol(probe_clk, zero, sizeof(zero));
}
"""


def fir_registers(log: str) -> dict:
    """{"f32 N=2048": "40 (spill 0)", ...} from `-Xptxas -v` output."""
    out, name, spill = {}, None, "?"
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            name = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores", line):
            spill = m.group(1)
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            k = re.search(r"tns_fir_gate_kernelI([fd])Li(\d+)E", name)
            if k:
                out[f"{'f32' if k[1] == 'f' else 'f64'} N={k[2]}"] = f"{m.group(1)} (spill {spill})"
    return out


def probe_fir_gate_variants(cs, kernels, dev, build) -> bool:
    src = build.CSRC_DIR / "tns_fir_gate.cu"
    variants = {"as built": [], **FIR_VARIANTS}
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=build.BUILD_DIR))
    try:
        (tmp / "stamps.cuh").write_text(FIR_STAMPS)
        jobs = {}
        for i, (label, flags) in enumerate(list(variants.items()) + [("stamped", None)]):
            extra = flags if flags is not None else ["-include", str(tmp / "stamps.cuh")]
            so = tmp / f"fg{i}.so"
            cmd = [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(build.CSRC_DIR),
                   *extra, "-o", str(so), str(src)]
            jobs[label] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True))
        libs = {}
        for label, (so, proc) in jobs.items():
            out, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc tns_fir_gate {label}:\n{err}")
            lib = ctypes.CDLL(str(so))
            lib.frad_tns_fir_gate.argtypes = list(build.SIGNATURES["frad_tns_fir_gate"])
            lib.frad_tns_fir_gate.restype = ctypes.c_int
            print(f"tns_fir_gate [{label}] registers: {fir_registers(out + err)}")
            libs[label] = lib
        libs["stamped"].probe_clocks.argtypes = [ctypes.c_void_p]
        libs["stamped"].probe_clocks.restype = ctypes.c_int

        def call(lib, x, ac, gate):
            out, lpc_out = torch.empty_like(x), torch.empty_like(ac)
            run = torch.empty_like(gate)
            err = lib.frad_tns_fir_gate(*(ctypes.c_void_p(t.data_ptr())
                                          for t in (x, ac, gate, out, lpc_out, run)),
                                        x.shape[0], x.shape[1], int(x.dtype == torch.float64),
                                        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            build.check("frad_tns_fir_gate (variant)", err)
            return out, lpc_out, run

        forms = {}
        for dtype in ("float32", "float64"):
            for lanes in (8, 1378):
                x, ac, gate = fir_gate_inputs(cs, kernels, dtype, lanes, 2048, dev)
                forms[dtype, lanes] = (x, ac, gate, kernels.tns_fir_gate_plain(x, ac, gate))
        runs = {label: lambda x, a, g, lib=libs[label]: call(lib, x, a, g) for label in variants}
        runs["the package's library"] = kernels.tns_fir_gate
        ok, times, labels = True, collections.defaultdict(list), list(runs)
        for order in (labels, labels[::-1]):
            for label in order:
                run = runs[label]
                for (dtype, lanes), (x, ac, gate, want) in forms.items():
                    same = same_results(cs, run(x, ac, gate), want)
                    ok &= same
                    if not same:
                        print(f"tns_fir_gate [{label}] {dtype} [{lanes}, 2048] DIFFERS from plain")
                    us = device_us(lambda: run(x, ac, gate), ("tns_fir_gate",))
                    times[label, dtype, lanes].append(us.get("tns_fir_gate"))
        for (dtype, lanes) in forms:
            print(f"tns_fir_gate {dtype} [{lanes}, 2048], device us (in order; reversed): "
                  + "; ".join(f"[{label}] {times[label, dtype, lanes][0]}, "
                              f"{times[label, dtype, lanes][1]}" for label in labels))

        x, ac, gate, _ = forms["float32", 1378]
        mhz = sm_mhz_under(lambda: kernels.tns_fir_gate(x, ac, gate))
        clk = (ctypes.c_ulonglong * 16)()
        lib = libs["stamped"]
        for lanes in (8, 1378):
            x, ac, gate, want = forms["float32", lanes]
            ok &= same_results(cs, call(lib, x, ac, gate), want)
            torch.cuda.synchronize()
            build.check("probe_clocks", lib.probe_clocks(clk))      # zeroes them
            for _ in range(REPS):
                call(lib, x, ac, gate)
            torch.cuda.synchronize()
            build.check("probe_clocks", lib.probe_clocks(clk))
            cyc = [clk[k] / max(clk[8 + k], 1) for k in range(len(FIR_PHASES))]
            print(f"tns_fir_gate float32 [{lanes}, 2048] phases, mean cycles of a block that "
                  f"reached each (µs at {mhz} MHz; blocks): "
                  + "; ".join(f"{p} {c:.0f} ({c / mhz:.3f}; {clk[8 + k] // REPS})"
                              for k, (p, c) in enumerate(zip(FIR_PHASES, cyc)))
                  + f"; all {sum(cyc):.0f} ({sum(cyc) / mhz:.3f})")
        return ok
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


#: (rows, samples) of the mask_thres probe and (frames, samples) of thres_expand's,
#: at the main path's sample rate
THRES_ROWS, EXPAND_FRAMES, THRES_N, THRES_SRATE = (8, 1376), (4, 689), 2048, 44100
#: the C entries of a parent tree whose threshold chains were six and two
#: launches, as they were declared there
PARENT_SIGNATURES = {
    "frad_mask_thres": (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 4 + (ctypes.c_double,) * 4
    + (ctypes.c_int, ctypes.c_void_p),
    "frad_thres_expand": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_double, ctypes.c_int, ctypes.c_void_p)}


def parent_chains(parent: Path, build, dev):
    """(encode chain, decode chain) of a parent tree whose threshold chains
    were six and two launches: its mask_thres.cu and thres_expand.cu built
    here, driven as its models/batch.py drove them (the band-indicator and
    interpolation matrices from this tree's tables, which equal its)."""
    import numpy as np
    from frad_python_tpu_torch.kernels.mask_thres import E_HALF
    from frad_python_tpu_torch.ops import psycho

    tmp = Path(tempfile.mkdtemp(dir=build.BUILD_DIR))
    so = tmp / "parent_thres.so"
    srcs = [str(parent / "frad_python_tpu_torch" / "csrc" / f) for f in
            ("mask_thres.cu", "thres_expand.cu")]
    res = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), *srcs],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc of the parent's threshold kernels:\n{res.stderr}")
    lib = ctypes.CDLL(str(so))
    for name, args in PARENT_SIGNATURES.items():
        getattr(lib, name).argtypes = list(args)
        getattr(lib, name).restype = ctypes.c_int

    def tables(n, dtype):
        starts, nb, _ = psycho._mask_consts(n, THRES_SRATE)
        ind = np.zeros((n, max(nb, 1)))
        for i in range(nb):
            ind[starts[i]:starts[i + 1], i] = 1.0
        b, frac, valid = psycho.mapping_consts(n, THRES_SRATE)
        w = np.zeros((psycho.SUBBANDS, n))
        np.add.at(w, (b, np.arange(n)), np.where(valid, 1.0 - frac, 0.0))
        np.add.at(w, (np.minimum(b + 1, psycho.SUBBANDS - 1), np.arange(n)),
                  np.where(valid, frac, 0.0))
        k = psycho.device_consts(n, THRES_SRATE, dev, dtype)
        return (torch.from_numpy(ind).to(dev, dtype), torch.from_numpy(w).to(dev, dtype),
                k["inv_w"], k["aht"], nb)

    def encode(freqs, factor, loss, ch):            # freqs [R, N]
        rows, n = freqs.shape
        ind, w, inv_w, aht, nb = tables(n, freqs.dtype)
        a = torch.abs(freqs) * factor
        sums = torch.matmul(a * a, ind)
        th = torch.empty((rows, psycho.SUBBANDS), dtype=freqs.dtype, device=dev)
        f64 = freqs.dtype == torch.float64
        tq = torch.empty((rows // ch, psycho.SUBBANDS, ch),
                         dtype=torch.int64 if f64 else torch.int32, device=dev)
        build.check("parent frad_mask_thres", lib.frad_mask_thres(
            *(ctypes.c_void_p(t.data_ptr()) for t in (sums, inv_w, aht, th, tq)), rows,
            sums.shape[1], nb, ch, float(loss), psycho.SPREAD_ALPHA, 1.0 / psycho.QUANT_ALPHA,
            E_HALF, int(f64), ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)))
        return torch.matmul(th, w), tq

    def decode(sym, n):                                  # sym [B, 27, C]
        b, _, c = sym.shape
        _, w, *_ = tables(n, sym.dtype)
        out = torch.empty((b, c, psycho.SUBBANDS), dtype=sym.dtype, device=dev)
        build.check("parent frad_thres_expand", lib.frad_thres_expand(
            ctypes.c_void_p(sym.data_ptr()), ctypes.c_void_p(out.data_ptr()), b, c, E_HALF,
            int(sym.dtype == torch.float64),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)))
        return torch.matmul(out.reshape(-1, psycho.SUBBANDS), w).reshape(b, c, n)

    return encode, decode


def probe_thres(cs, kernels, dev, parent: Path | None, build) -> bool:
    """See the module docstring: the two kernels against plain with their
    warm times, mask_thres's block sizes and phases, and a parent's
    chains on the same inputs."""
    import numpy as np

    ok = True
    factor, loss = 2.0 ** 15, 0.5
    chains = parent_chains(parent, build, dev) if parent else None
    for dtype in ("float32", "float64"):
        for rows in THRES_ROWS:
            x = torch.from_numpy(cs.mask_thres_inputs(rows, THRES_N, dtype, 5 + rows)).to(dev)
            args = (x, factor, loss, THRES_SRATE, 2)
            same = all(cs.bits_equal(torch, g, w) if g.is_floating_point() else torch.equal(g, w)
                       for g, w in zip(kernels.mask_thres(*args), kernels.mask_thres_plain(*args)))
            ok &= same
            print(f"mask_thres {dtype} [{rows}, {THRES_N}]: {'equal' if same else 'DIFFERS'}, "
                  f"device {call_us(lambda: kernels.mask_thres(*args))} us a call")
            if dtype == "float32":
                variants(build, x, factor, loss, kernels.mask_thres_plain(*args))
            if chains:
                enc, _ = chains
                print(f"mask_thres parent's chain {dtype} [{rows}, {THRES_N}]: device "
                      f"{call_us(lambda: enc(x, factor, loss, 2))} us a call (six launches)")
        for frames in EXPAND_FRAMES:
            sym = np.rint(np.random.default_rng(frames).laplace(0, 6, (frames, 27, 2)))
            t = torch.from_numpy(sym.astype(dtype)).to(dev)
            same = cs.bits_equal(torch, kernels.thres_expand(t, THRES_N, THRES_SRATE),
                                 kernels.thres_expand_plain(t, THRES_N, THRES_SRATE))
            ok &= same
            print(f"thres_expand {dtype} [{frames}, 27, 2] -> [{frames}, 2, {THRES_N}]: "
                  f"{'equal' if same else 'DIFFERS'}, device "
                  f"{call_us(lambda: kernels.thres_expand(t, THRES_N, THRES_SRATE))} us a call")
            if chains:
                _, dec = chains
                print(f"thres_expand parent's chain {dtype} [{frames}, 27, 2]: device "
                      f"{call_us(lambda: dec(t, THRES_N))} us a call (two launches)")
    return ok


#: the phases of a mask_thres block: thread 0's (PHASE_STAMP k closes
#: MASK_PHASES[k - 1]), then thread 32's time from thread 0's start to the end
#: of its divisor runs
MASK_PHASES = ("prefetch, band sums (warp 0)", "wait for every warp", "thresholds",
               "symbols (warp 0, beside the divisor)", "start to divisor done (thread 32)")
MASK_STAMPS = """
__device__ unsigned long long probe_clk[16];  // [k]: cycles of phase k; [8 + k]: blocks
__device__ __forceinline__ void probe_stamp(int k) {
    __shared__ long long probe_start, probe_last;
    const long long c = clock64();
    if (k == 5) {
        if (threadIdx.x == 32) {
            atomicAdd(&probe_clk[4], (unsigned long long)(c - probe_start));
            atomicAdd(&probe_clk[12], 1ull);
        }
        return;
    }
    if (threadIdx.x != 0) return;
    if (k == 0) probe_start = c;
    else {
        atomicAdd(&probe_clk[k - 1], (unsigned long long)(c - probe_last));
        atomicAdd(&probe_clk[8 + k - 1], 1ull);
    }
    probe_last = c;
}
#define PHASE_STAMP(k) probe_stamp(k)
extern "C" int probe_clocks(unsigned long long* host) {   // read, then zero
    cudaError_t e = cudaMemcpyFromSymbol(host, probe_clk, sizeof(probe_clk));
    if (e != cudaSuccess) return (int)e;
    const unsigned long long zero[16] = {};
    return (int)cudaMemcpyToSymbol(probe_clk, zero, sizeof(zero));
}
"""


def mask_call(lib, x, factor, loss, threads):
    """frad_mask_thres of library `lib` on float32 spectra x [R, N] of two
    channels, at `threads` a block."""
    from frad_python_tpu_torch.kernels import build
    from frad_python_tpu_torch.kernels.mask_thres import _EXPONENT, E_HALF
    from frad_python_tpu_torch.ops import psycho

    rows, n = x.shape
    starts, inv_w, aht, nb = psycho.kernel_tables(n, THRES_SRATE)
    k = psycho.device_consts(n, THRES_SRATE, x.device, x.dtype)
    div = torch.empty_like(x)
    tq = torch.empty((rows // 2, psycho.SUBBANDS, 2), dtype=torch.int32, device=x.device)
    build.check("frad_mask_thres (probe)", lib.frad_mask_thres(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(div.data_ptr()),
        ctypes.c_void_p(tq.data_ptr()), rows, n, 2, starts.ctypes.data_as(ctypes.c_void_p),
        inv_w.ctypes.data_as(ctypes.c_void_p), aht.ctypes.data_as(ctypes.c_void_p), nb,
        *(ctypes.c_void_p(k[t].data_ptr()) for t in ("band8", "w_lo", "w_hi")),
        factor, loss, psycho.SPREAD_ALPHA, _EXPONENT, E_HALF, 0, threads,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)))
    return div, tq


def variants(build, x, factor, loss, same_as) -> None:
    """mask_thres on float32 x at 128 to 1024 threads a block, through the
    C entry; then the phases of a block from a build with clock64() stamps
    at the threads the wrapper picks."""
    from frad_python_tpu_torch.kernels.mask_thres import geometry

    lib = build.library()
    out = []
    for threads in (128, 256, 512, 1024):
        div, tq = mask_call(lib, x, factor, loss, threads)
        same = torch.equal(div.view(torch.int32), same_as[0].view(torch.int32)) \
            and torch.equal(tq, same_as[1])
        out.append(f"{threads} threads {'equal' if same else 'DIFFERS'} "
                   f"{call_us(lambda: mask_call(lib, x, factor, loss, threads))}")
    rows, n = x.shape
    print(f"mask_thres float32 [{rows}, {n}] variants, device us a call: " + "; ".join(out))

    tmp = Path(tempfile.mkdtemp(dir=build.BUILD_DIR))
    try:
        (tmp / "stamps.cuh").write_text(MASK_STAMPS)
        so = tmp / "mt_stamped.so"
        res = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR),
                              "-include", str(tmp / "stamps.cuh"), "-o", str(so),
                              str(build.CSRC_DIR / "mask_thres.cu")], capture_output=True,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc mask_thres (stamped):\n{res.stderr}")
        lib = ctypes.CDLL(str(so))
        lib.frad_mask_thres.argtypes = list(build.SIGNATURES["frad_mask_thres"])
        lib.frad_mask_thres.restype = ctypes.c_int
        lib.probe_clocks.argtypes = [ctypes.c_void_p]
        lib.probe_clocks.restype = ctypes.c_int
        threads = geometry(rows)
        mhz = sm_mhz_under(lambda: mask_call(lib, x, factor, loss, threads))
        clk = (ctypes.c_ulonglong * 16)()
        mask_call(lib, x, factor, loss, threads)
        torch.cuda.synchronize()
        build.check("probe_clocks", lib.probe_clocks(clk))           # zeroes them
        for _ in range(REPS):
            mask_call(lib, x, factor, loss, threads)
        torch.cuda.synchronize()
        build.check("probe_clocks", lib.probe_clocks(clk))
        cyc = [clk[k] / max(clk[8 + k], 1) for k in range(len(MASK_PHASES))]
        print(f"mask_thres float32 [{rows}, {n}] ({threads} threads) phases, mean cycles a "
              f"block (µs at {mhz} MHz): "
              + "; ".join(f"{p} {c:.0f} ({c / mhz:.3f})" for p, c in zip(MASK_PHASES, cyc)))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def probe_flips(cs, kernels, dev, parent: Path | None, build) -> None:
    """See the module docstring (`flips`)."""
    import numpy as np
    from frad_python_tpu_torch.models import profile1
    from frad_python_tpu_torch.ops import tns
    from frad_python_tpu_torch.ops.dct import dct2
    from frad_python_tpu_torch.parallel import pipeline

    if parent is None:
        raise SystemExit("kernel_probe: the flips section needs --parent DIR")
    enc, dec = parent_chains(parent, build, dev)
    pcm = cs.make_audio(cs.SECONDS, cs.SRATE, cs.CHANNELS)
    frs, _ = pipeline.plan_frames(len(pcm), cs.FSIZE, 16, True)
    frs = [f for f in frs if f[1] == frs[0][1]]
    arr = pipeline._gather(pcm, frs, frs[0][1])
    _, srate, loss = profile1.prepare_frame(arr[0], cs.SRATE, 0.5)
    factor = profile1._scale_factor(cs.BITS)
    b, n, c = arr.shape

    def rel(a, w):
        return float(((a.double() - w.double()).abs() / w.double().abs().clamp_min(1e-300)).max())

    for profile, frames in ((1, torch.from_numpy(pipeline._to_i16(arr)).to(dev).float()
                             * (1.0 / 32768.0)),
                            (2, torch.from_numpy(arr.astype(np.float32)).to(dev))):
        freqs = dct2(frames.transpose(1, 2)).reshape(b * c, n).contiguous()
        div, tq = kernels.mask_thres(freqs, factor, loss, srate, c)
        div_p, tq_p = enc(freqs, factor, loss, c)
        if profile == 1:
            fq = kernels.power_quant(freqs, div, factor)
            fq_p = kernels.power_quant(freqs, div_p.contiguous(), factor)
            lpc = lpc_p = torch.zeros(1)
        else:
            masked, lpc = tns.tns_analysis(freqs, div)
            masked_p, lpc_p = tns.tns_analysis(freqs, div_p.contiguous())
            fq = kernels.power_quant(masked, None, factor)
            fq_p = kernels.power_quant(masked_p, None, factor)
        print(f"flips P{profile} float32, {b} frames of the {cs.SECONDS:g} s track, this tree "
              f"against the parent's chain: threshold symbols {int((tq != tq_p).sum())} of "
              f"{tq.numel()}, frequency symbols {int((fq != fq_p).sum())} of {fq.numel()}, "
              f"LPC symbols {int((lpc != lpc_p).sum())} of {lpc.numel()}; divisors differ on "
              f"{int((div != div_p).sum())} of {div.numel()} bins, by at most "
              f"{rel(div, div_p):.3g} relative")
        t = tq.to(torch.float32)
        got, want = kernels.thres_expand(t, n, srate), dec(t, n)
        print(f"flips P{profile} decode divisors from those symbols: {int((got != want).sum())} "
              f"of {got.numel()} bins differ, by at most {rel(got, want):.3g} relative")


#: frames of the decode probes (the streaming engines' micro-batch and the
#: 30 s track's run) at the main path's geometry
DECODE_FRAMES = (4, 689)
#: the C entries of a parent tree whose Profile 1 decode was `thres_expand`
#: then `dequant` with the divisor, as declared there
PARENT_DECODE_SIGNATURES = {
    "frad_dequant": (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3 + (ctypes.c_double,) * 2
    + (ctypes.c_int, ctypes.c_void_p),
    "frad_thres_expand": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_double, ctypes.c_int, ctypes.c_void_p),
    "frad_overlap_add": (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 7 + (ctypes.c_void_p,)}
#: SASS opcodes of an integer division by a value known only at run time
#: (the reciprocal's first step, 32- and 64-bit)
INT_DIVISION = ("I2F.U32.RP", "I2F.U64.RP")


def parent_decode(parent: Path, build, dev):
    """(Profile 1 pair, overlap_add, library path) of a parent tree whose
    Profile 1 decode was two launches: its dequant.cu, thres_expand.cu and
    overlap_add.cu built here, driven as its models/batch.py and wrappers
    drove them."""
    from frad_python_tpu_torch.kernels.mask_thres import E_HALF
    from frad_python_tpu_torch.ops import psycho

    tmp = Path(tempfile.mkdtemp(dir=build.BUILD_DIR))
    so = tmp / "parent_decode.so"
    srcs = [str(parent / "frad_python_tpu_torch" / "csrc" / f) for f in
            ("dequant.cu", "thres_expand.cu", "overlap_add.cu")]
    res = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), *srcs],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc of the parent's decode kernels:\n{res.stderr}")
    lib = ctypes.CDLL(str(so))
    for name, args in PARENT_DECODE_SIGNATURES.items():
        getattr(lib, name).argtypes = list(args)
        getattr(lib, name).restype = ctypes.c_int

    def stream():
        return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def pair(sym, thres, factor, srate):            # sym [B, N, C], thres [B, 27, C]
        b, n, c = sym.shape
        dtype = thres.dtype
        k = psycho.device_consts(n, srate, dev, dtype)
        div = torch.empty((b, c, n), dtype=dtype, device=dev)
        build.check("parent frad_thres_expand", lib.frad_thres_expand(
            ctypes.c_void_p(thres.data_ptr()), ctypes.c_void_p(div.data_ptr()), b, c, n,
            *(ctypes.c_void_p(k[t].data_ptr()) for t in ("band8", "w_lo", "w_hi")), E_HALF,
            int(dtype == torch.float64), stream()))
        out = torch.empty((b, c, n), dtype=dtype, device=dev)
        kind = {torch.int16: 0, torch.float32: 1, torch.float64: 2}[sym.dtype]
        build.check("parent frad_dequant", lib.frad_dequant(
            ctypes.c_void_p(sym.data_ptr()), ctypes.c_void_p(div.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), b, n, c, float(factor),
            1.0 / psycho.QUANT_ALPHA, kind, stream()))
        return out

    def overlap_add(pcm, w, cut, i16):
        b, c, n = pcm.shape
        olap = w.shape[0]
        out = torch.empty((b, cut, c), dtype=torch.int16 if i16 else pcm.dtype, device=dev)
        frag = torch.empty((olap, c), dtype=pcm.dtype, device=dev)
        build.check("parent frad_overlap_add", lib.frad_overlap_add(
            *(ctypes.c_void_p(t.data_ptr()) for t in (pcm, w, out, frag)), b, c, n, olap, cut,
            int(i16), int(pcm.dtype == torch.float64), stream()))
        return out, frag

    return pair, overlap_add, so


def sass_functions(cuobjdump: Path, lib: Path, key: str) -> dict:
    """{kernel name: opcode Counter} of the kernels of `lib` whose name holds
    `key` (`cuobjdump -sass`)."""
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    out = {}
    for fn in re.split(r"(?=\n\s+Function : )", sass):
        name = re.search(r"Function : (\S+)", fn)
        if name and key in name.group(1):
            out[name.group(1)] = collections.Counter(
                re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\d\s+)?([A-Z0-9_.]+)", fn))
    return out


def probe_decode(cs, kernels, dev, parent: Path | None, build) -> bool:
    """See the module docstring (`decode`)."""
    import numpy as np
    from frad_python_tpu_torch.kernels.overlap_add import crossfade_window

    ok = True
    factor, srate, n, ch = 2.0 ** 15, cs.SRATE, cs.FSIZE, cs.CHANNELS
    pair = oa_parent = None
    if parent:
        pair, oa_parent, parent_so = parent_decode(parent, build, dev)
    for dtype in ("int16", "float64"):
        compute = "float64" if dtype == "float64" else "float32"
        for frames in DECODE_FRAMES:
            rng = np.random.default_rng(frames)
            sym = torch.from_numpy(np.rint(rng.laplace(0, 20, (frames, n, ch))).astype(dtype)
                                   ).to(dev)
            thres = torch.from_numpy(np.rint(rng.laplace(0, 6, (frames, 27, ch))).astype(compute)
                                     ).to(dev)
            got = kernels.dequant(sym, thres, factor, srate)
            same = cs.bits_equal(torch, got, kernels.dequant_plain(sym, thres, factor, srate)
                                 .contiguous())
            ok &= same
            line = (f"dequant {dtype} [{frames}, {n}, {ch}] + thresholds: "
                    f"{'equal' if same else 'DIFFERS'}, device "
                    f"{call_us(lambda: kernels.dequant(sym, thres, factor, srate))} us a call")
            if pair:
                same_p = cs.bits_equal(torch, got, pair(sym, thres, factor, srate))
                ok &= same_p
                line += (f"; the parent's thres_expand + dequant "
                         f"{call_us(lambda: pair(sym, thres, factor, srate))} us "
                         f"({'bit-equal' if same_p else 'DIFFERENT'} output)")
            print(line)
            print(f"dequant {dtype} [{frames}, {n}, {ch}] no thresholds (Profile 2): device "
                  f"{call_us(lambda: kernels.dequant(sym, None, factor))} us a call")
    w = {d: crossfade_window(cs.OLAP, dev, d) for d in (torch.float32, torch.float64)}
    for dtype, i16 in (("float32", True), ("float32", False), ("float64", False)):
        for frames in DECODE_FRAMES:
            pcm = torch.from_numpy((np.random.default_rng(frames).standard_normal(
                (frames, ch, n)) * 0.3).astype(dtype)).to(dev)
            wt = w[pcm.dtype]
            got = kernels.overlap_add(pcm, wt, cs.CUT, i16)
            want = kernels.overlap_add_plain(pcm, wt, cs.CUT, i16)
            same = all(cs.bits_equal(torch, g, x) for g, x in zip(got, want))
            ok &= same
            line = (f"overlap_add {dtype} [{frames}, {ch}, {n}] {'i16' if i16 else dtype} emit: "
                    f"{'equal' if same else 'DIFFERS'}, device "
                    f"{call_us(lambda: kernels.overlap_add(pcm, wt, cs.CUT, i16))} us a call")
            if oa_parent:
                same_p = all(cs.bits_equal(torch, g, x)
                             for g, x in zip(got, oa_parent(pcm, wt, cs.CUT, i16)))
                ok &= same_p
                line += (f"; the parent's {call_us(lambda: oa_parent(pcm, wt, cs.CUT, i16))} us "
                         f"({'bit-equal' if same_p else 'DIFFERENT'} output)")
            print(line)
    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    libs = [("this tree", build.library_path())] + ([("parent", parent_so)] if parent else [])
    for label, lib in libs:
        for key in ("dequant_kernel", "overlap_add_kernel"):
            for name, ops in sass_functions(cuobjdump, lib, key).items():
                wide = {op: sum(v for k, v in ops.items() if k.startswith(op) and ".128" in k)
                        for op in ("LD", "ST")}
                print(f"SASS {label} {name}: {sum(ops.values())} operations, integer divisions "
                      f"{sum(ops[o] for o in INT_DIVISION)} ({', '.join(INT_DIVISION)}), calls "
                      f"{sum(v for k, v in ops.items() if k.startswith('CALL'))}, 16-byte "
                      f"loads {wide['LD']}, 16-byte stores {wide['ST']}")
    return ok


#: the choices of dequant.cu and overlap_add.cu turned the other way, each
#: timed beside the package's own build: {label: (file, [(text as built,
#: text of the variant), ...])}
DECODE_VARIANTS = {
    "512 dequant run threads a block at most": (
        "dequant.cu", [("constexpr int MAX_RUNNERS = 256;", "constexpr int MAX_RUNNERS = 512;")]),
    "no power table (powf for every symbol)": (
        "dequant.cu", [("constexpr int POW_TABLE = 256;", "constexpr int POW_TABLE = 1;"),
                       ("return a < (T)POW_TABLE;", "return false;"),
                       ("return a < (T)POW_TABLE && a == trunc_t(a);", "return false;")]),
    "overlap_add blocks of 128 threads at least": (
        "overlap_add.cu", [("int MIN_THREADS = 32;", "int MIN_THREADS = 128;")]),
    "overlap_add blocks never narrowed": (
        "overlap_add.cu", [("int MIN_THREADS = 32;", "int MIN_THREADS = 512;")]),
}


def decode_variant_sources(csrc: Path) -> dict:
    """{label: {file: source}}: dequant.cu and overlap_add.cu of `csrc`
    with each choice of DECODE_VARIANTS turned the other way (the other
    file as built); a text that is not in its file once raises."""
    out = {}
    for label, (name, edits) in DECODE_VARIANTS.items():
        srcs = {f: (csrc / f).read_text() for f in ("dequant.cu", "overlap_add.cu")}
        for old, new in edits:
            if srcs[name].count(old) != 1:
                raise AssertionError(f"decode_variants: {old!r} is not in {name} once")
            srcs[name] = srcs[name].replace(old, new)
        out[label] = srcs
    return out


def probe_decode_variants(cs, kernels, dev, build) -> bool:
    """See the module docstring (`decode_variants`)."""
    import numpy as np
    from frad_python_tpu_torch.kernels.overlap_add import crossfade_window

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=build.BUILD_DIR))
    libs = {"as built": build.library()}
    jobs = {}
    for i, (label, srcs) in enumerate(decode_variant_sources(build.CSRC_DIR).items()):
        cus = []
        for f, text in srcs.items():
            cus.append(tmp / f"v{i}_{f}")
            cus[-1].write_text(text)
        so = tmp / f"v{i}.so"
        jobs[label] = (so, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR), "-o", str(so),
             *map(str, cus)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for label, (so, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc of variant {label}:\n{err}")
        lib = ctypes.CDLL(str(so))
        for name in ("frad_dequant", "frad_overlap_add"):
            getattr(lib, name).argtypes = list(build.SIGNATURES[name])
            getattr(lib, name).restype = ctypes.c_int
        libs[label] = lib
    factor, srate, n, ch = 2.0 ** 15, cs.SRATE, cs.FSIZE, cs.CHANNELS
    calls = {}
    for dtype in ("int16", "float64"):
        compute = "float64" if dtype == "float64" else "float32"
        for frames in DECODE_FRAMES:
            rng = np.random.default_rng(frames)
            sym = torch.from_numpy(np.rint(rng.laplace(0, 20, (frames, n, ch))).astype(dtype)
                                   ).to(dev)
            thres = torch.from_numpy(np.rint(rng.laplace(0, 6, (frames, 27, ch))).astype(compute)
                                     ).to(dev)
            calls[f"dequant {dtype} [{frames}] + thresholds"] = (
                lambda s=sym, t=thres: kernels.dequant(s, t, factor, srate),
                kernels.dequant_plain(sym, thres, factor, srate).contiguous())
            if dtype == "int16":
                calls[f"dequant {dtype} [{frames}] no thresholds"] = (
                    lambda s=sym: kernels.dequant(s, None, factor),
                    kernels.dequant_plain(sym, None, factor).contiguous())
    for dtype, i16 in (("float32", True), ("float32", False), ("float64", False)):
        for frames in DECODE_FRAMES:
            pcm = torch.from_numpy((np.random.default_rng(frames).standard_normal(
                (frames, ch, n)) * 0.3).astype(dtype)).to(dev)
            wt = crossfade_window(cs.OLAP, dev, pcm.dtype)
            calls[f"overlap_add {dtype} [{frames}] {'i16' if i16 else dtype} emit"] = (
                lambda p=pcm, w=wt, e=i16: kernels.overlap_add(p, w, cs.CUT, e)[0],
                kernels.overlap_add_plain(pcm, wt, cs.CUT, i16)[0])
    ok = True
    times = {label: {} for label in libs}
    saved = build._lib
    try:
        for order in (list(libs), list(libs)[::-1]):
            for label in order:
                build._lib = libs[label]
                for what, (fn, want) in calls.items():
                    same = cs.bits_equal(torch, fn(), want)
                    ok &= same
                    times[label].setdefault(what, []).append(
                        call_us(fn) if same else float("nan"))
    finally:
        build._lib = saved
    for label, t in times.items():
        print(f"variant {label}: " + ", ".join(f"{what} {v[0]} / {v[1]} us"
                                               for what, v in t.items()))
    shutil.rmtree(tmp, ignore_errors=True)
    return ok


#: the C entry of a parent tree's trunc_unpack, which took no launch geometry
PARENT_TRUNC_UNPACK_SIGNATURE = (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)
#: trunc_unpack.cu's choices turned the other way: {label: (text as built,
#: the variant's text, {channels: bins a thread} where the variant differs)}
_BINS = "return cc == 8 ? 2 : 4; }"
TRUNC_UNPACK_VARIANTS = {
    "16 values a thread at C = 1, 2 (16-byte loads, two 16-byte stores a channel)": (
        _BINS, "return cc == 1 ? 16 : cc == 2 ? 8 : cc == 8 ? 2 : 4; }", {1: 16, 2: 8}),
    "4 bins a thread at C = 8 (16-byte stores)": (_BINS, "return 4; }", {8: 4}),
}
#: threads a block each build is also timed at (24 bits)
TRUNC_UNPACK_BLOCKS = (64, 128, 256)


def trunc_unpack_builds(parent: Path | None, build) -> dict:
    """{label: (library, its path, ptxas log)}: this tree's trunc_unpack.cu
    as built and with each TRUNC_UNPACK_VARIANTS choice, and a parent
    tree's, each built alone by nvcc with `-Xptxas -v`, all started
    together; a variant's text that is not in the source once raises."""
    tmp = Path(tempfile.mkdtemp(dir=build.BUILD_DIR))
    text = (build.CSRC_DIR / "trunc_unpack.cu").read_text()
    srcs = {"as built": text}
    for label, (old, new, _) in TRUNC_UNPACK_VARIANTS.items():
        if text.count(old) != 1:
            raise AssertionError(f"trunc_unpack: {old!r} is not in trunc_unpack.cu once")
        srcs[label] = text.replace(old, new)
    if parent:
        srcs["parent"] = (parent / "frad_python_tpu_torch" / "csrc" / "trunc_unpack.cu").read_text()
    jobs = {}
    for i, (label, src) in enumerate(srcs.items()):
        cu, so = tmp / f"u{i}.cu", tmp / f"u{i}.so"
        cu.write_text(src)
        jobs[label] = (so, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(build.CSRC_DIR),
             "-o", str(so), str(cu)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = {}
    for label, (so, proc) in jobs.items():
        o, e = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc of trunc_unpack ({label}):\n{e}")
        lib = ctypes.CDLL(str(so))
        lib.frad_trunc_unpack.argtypes = list(
            PARENT_TRUNC_UNPACK_SIGNATURE if label == "parent"
            else build.SIGNATURES["frad_trunc_unpack"])
        lib.frad_trunc_unpack.restype = ctypes.c_int
        out[label] = (lib, so, o + e)
    return out


def unpack_geometry(n: int, bins: int, block: int) -> tuple[int, int]:
    """(chunks, threads) as kernels/trunc_unpack.py:geometry picks them, for
    `bins` a thread and blocks of at most `block` threads."""
    groups = -(-n // bins)
    chunks = -(-groups // block)
    return chunks, (-(-groups // chunks) + 31) // 32 * 32


def unpack_call(build, lib, w, bits: int, little: bool, n: int, c: int, geo=None):
    """trunc_unpack of `lib` on words w: a parent's entry (geo None) or this
    tree's with the launch geometry `geo` (chunks, threads)."""
    out = torch.empty((w.shape[0], c, n), dtype=torch.float32, device=w.device)
    build.check("frad_trunc_unpack", lib.frad_trunc_unpack(
        ctypes.c_void_p(w.data_ptr()), ctypes.c_void_p(out.data_ptr()), w.shape[0], c, n, bits,
        int(little), *(geo or ()), ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)))
    return out


def unpack_registers(log: str) -> dict:
    """{"C=2 24-bit vec": "40 (stack 0, spill 0)", ...} from `-Xptxas -v`
    output of a trunc_unpack build (a parent's one kernel: "any")."""
    out, name, stack, spill = {}, None, "?", "?"
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            name = m.group(1)
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line):
            stack, spill = m.group(1), m.group(2)
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            k = re.search(r"trunc_unpack_kernelILi(\d+)ELi(\d+)ELb([01])E", name)
            key = (f"C={k[1] if k[1] != '0' else 'any'} {k[2]}-bit {'vec' if k[3] == '1' else 'elem'}"
                   if k else "any")
            out[key] = f"{m.group(1)} (stack {stack}, spill {spill})"
    return out


def probe_trunc_unpack(cs, kernels, dev, parent: Path | None, build) -> bool:
    """See the module docstring (`trunc_unpack`)."""
    ktu = importlib.import_module("frad_python_tpu_torch.kernels.trunc_unpack")
    builds = trunc_unpack_builds(parent, build)
    ok = True
    for si, shape in enumerate(cs.TRUNC_SHAPES + cs.TRUNC_ODD_SHAPES):
        b, c, n = shape
        for bits in (16, 24, 32):
            if bits == 24 and (c * n) % 4:
                continue
            bad, times = [], {}
            for little in (True, False):          # big-endian last: the one timed
                w = torch.from_numpy(cs.trunc_random_words(shape, bits, little, 7 + si)).to(dev)
                want = kernels.trunc_unpack_plain(w, bits, little, n, c)
                calls = {"this tree": lambda: kernels.trunc_unpack(w, bits, little, n, c)}
                if parent:
                    calls["parent"] = lambda: unpack_call(build, builds["parent"][0], w, bits,
                                                          little, n, c)
                for label, (_, _, bins) in TRUNC_UNPACK_VARIANTS.items():
                    if c in bins:
                        calls[label] = lambda lib=builds[label][0], g=bins[c]: unpack_call(
                            build, lib, w, bits, little, n, c, unpack_geometry(n, g, ktu.BLOCK))
                if bits == 24:
                    for label, (_, _, bins) in [("as built", (0, 0, {}))] + [
                            v for v in TRUNC_UNPACK_VARIANTS.items() if c in v[1][2]]:
                        for block in TRUNC_UNPACK_BLOCKS:
                            calls[f"{label}, {block} threads"] = \
                                lambda lib=builds[label][0], g=bins.get(c, ktu.bins(c)), \
                                block=block: unpack_call(build, lib, w, bits, little, n, c,
                                                         unpack_geometry(n, g, block))
                for label, fn in calls.items():
                    if not cs.bits_equal(torch, fn(), want):
                        bad.append((label, "little" if little else "big"))
            ok &= not bad
            if shape in cs.TRUNC_SHAPES:
                times = {label: call_us(fn) for label, fn in calls.items()}
            m = b * c * n
            print(f"trunc_unpack {shape} {bits}-bit: "
                  f"{'bit-equal to plain' if not bad else f'DIFFERS {bad}'} (random words, both "
                  f"orders), bound {m * (bits // 8 + 4) / cs.HBM_BYTES_PER_S * 1e6:.2f} us; "
                  + ", ".join(f"{label} {us} us" for label, us in times.items()))
    for label, (_, _, log) in builds.items():
        print(f"ptxas trunc_unpack {label}: " + ", ".join(
            f"{k} {v}" for k, v in sorted(unpack_registers(log).items())))
    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    for label in ("as built", "parent"):
        if label not in builds:
            continue
        for name, ops in sass_functions(cuobjdump, builds[label][1], "trunc_unpack_kernel").items():
            wide = {op: sum(v for k, v in ops.items() if k.startswith(op) and ".128" in k)
                    for op in ("LD", "ST")}
            print(f"SASS {label} {name}: {sum(ops.values())} operations, integer divisions "
                  f"{sum(ops[o] for o in INT_DIVISION)} ({', '.join(INT_DIVISION)}), 16-byte "
                  f"loads {wide['LD']}, 16-byte stores {wide['ST']}")
    return ok


#: recordings of each way that `trace` counts the lost kernels of
TRACE_WINDOWS = 20
#: what `trace` launches in each window: six hand kernels on small inputs
TRACE_KERNELS = ("power_quant", "overlap_add", "dequant", "mask_thres", "tns_iir",
                 "thres_expand")


def probe_trace(cs, kernels, dev) -> None:
    """See the module docstring (`trace`)."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    from frad_python_tpu_torch.kernels.overlap_add import crossfade_window

    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.standard_normal((8, 2048)) * 1e-2).astype(np.float32)).to(dev)
    div = torch.from_numpy(np.exp(rng.standard_normal((8, 2048))).astype(np.float32)).to(dev)
    pcm = torch.from_numpy(rng.standard_normal((4, 2, 2048)).astype(np.float32)).to(dev)
    sym = torch.from_numpy(np.rint(rng.laplace(0, 20, (4, 2048, 2))).astype(np.int16)).to(dev)
    thres = torch.from_numpy(np.rint(rng.laplace(0, 6, (4, 27, 2))).astype(np.float32)).to(dev)
    coeffs = torch.zeros((8, 13), device=dev)
    coeffs[:, 0] = 1.0
    w = crossfade_window(cs.OLAP, dev)
    calls = (lambda: kernels.power_quant(x, div, 2.0 ** 15),
             lambda: kernels.overlap_add(pcm, w, cs.CUT, True),
             lambda: kernels.dequant(sym, thres, 2.0 ** 15, cs.SRATE),
             lambda: kernels.mask_thres(x, 2.0 ** 15, 0.5, cs.SRATE, 2),
             lambda: kernels.tns_iir(x, coeffs),
             lambda: kernels.thres_expand(thres, 2048, cs.SRATE))
    lead = torch.zeros(1, device=dev)

    def seen(prof) -> str:
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        return " ".join("+" if any(k + "_kernel" in nm for nm in names) else "-"
                        for k in TRACE_KERNELS)

    def window(before, settle):
        for fn in calls:
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            before()
            if settle:
                torch.cuda.synchronize()
                time.sleep(settle)
            for fn in calls:
                fn()
            torch.cuda.synchronize()
        return seen(prof)

    def warmed(leads=0, passes=1):
        """a schedule's warmup step of the calls, then a recorded step of
        `leads` lead kernels and `passes` passes of the calls"""
        for fn in calls:
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for fn in calls:
                fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(leads):
                lead.add_(1)
            torch.cuda.synchronize()
            for _ in range(passes):
                for fn in calls:
                    fn()
                torch.cuda.synchronize()
        return seen(prof)

    thunks = {k + "_kernel": fn for k, fn in zip(TRACE_KERNELS, calls)}

    print(f"trace: which of {TRACE_KERNELS} one profiler window recorded (+) or dropped (-), "
          f"three windows each")
    variants = {
        "one lead kernel, then the calls": lambda: window(lambda: lead.add_(1), 0),
        "no lead": lambda: window(lambda: None, 0),
        "lead kernel, synchronize": lambda: window(lambda: lead.add_(1), 1e-9),
        "synchronize and 1 ms": lambda: window(lambda: None, 0.001),
        "synchronize and 5 ms": lambda: window(lambda: None, 0.005),
        "schedule: a warmup step of the calls, then the calls": warmed,
        "chip_smoke.profiled_device_ms": lambda: " ".join(
            "+" if v is not None else "-" for v in cs.profiled_device_ms(torch, thunks).values()),
    }
    for label, run in variants.items():
        print(f"  {label}: " + " | ".join(run() for _ in range(3)))
    if not hasattr(cs, "kept_device_ms"):
        return
    print(f"trace: kernels of the {len(calls)} that each of {TRACE_WINDOWS} recordings lost")
    recordings = {
        "a warmup step, the calls once": warmed,
        "a warmup step, the calls twice": lambda: warmed(0, 2),
        f"a warmup step, {cs.TRACE_LEADS} lead kernels, the calls twice":
            lambda: warmed(cs.TRACE_LEADS, 2),
        "chip_smoke.profiled_device_ms": variants["chip_smoke.profiled_device_ms"],
    }
    for label, run in recordings.items():
        lost = [run().count("-") for _ in range(TRACE_WINDOWS)]
        print(f"  {label}: {lost}; {sum(n > 0 for n in lost)} of {TRACE_WINDOWS} recordings "
              f"lost a kernel, {sum(lost)} of {len(calls) * TRACE_WINDOWS} kernels lost")
    made, left = [], 0
    for _ in range(TRACE_WINDOWS):
        ms, n = cs.kept_device_ms(torch, thunks)
        made.append(n)
        left += sum(v is None for v in ms.values())
    print(f"  chip_smoke.kept_device_ms, {TRACE_WINDOWS} times: recordings made {made}; "
          f"kernels still lost after them {left} of {len(calls) * TRACE_WINDOWS}")


def probe_registers(build, sources: tuple[str, ...]) -> None:
    """Registers, stack frame and spill stores of every kernel of `sources`
    (`-Xptxas -v`)."""
    tmp = Path(tempfile.mkdtemp(dir=build.BUILD_DIR))
    for src in sources:
        res = subprocess.run([build.nvcc(), *[f for f in build.NVCC_FLAGS if f != "-shared"],
                              "-Xptxas", "-v", "-c", "-o", str(tmp / (src + ".o")),
                              str(build.CSRC_DIR / src)], capture_output=True, text=True)
        name, stack, spill = None, "?", "?"
        for line in (res.stdout + res.stderr).splitlines():
            if m := re.search(r"Compiling entry function '(\S+)'", line):
                name = m.group(1)
            elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line):
                stack, spill = m.group(1), m.group(2)
            elif (m := re.search(r"Used (\d+) registers", line)) and name:
                print(f"{src} {name}: {m.group(1)} registers, stack frame {stack} bytes, spill "
                      f"stores {spill} bytes")
    shutil.rmtree(tmp, ignore_errors=True)


def sm_mhz_under(fn) -> int:
    """The SM clock (MHz, median of three `nvidia-smi` reads) while `fn`
    runs back to back."""
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            for _ in range(200):
                fn()
            torch.cuda.synchronize()

    worker = threading.Thread(target=spin)
    worker.start()
    time.sleep(0.5)
    reads = []
    for _ in range(3):
        reads.append(int(smi("clocks.sm").split()[0]))
        time.sleep(0.2)
    stop.set()
    worker.join()
    return sorted(reads)[1]


def probe_sass(build) -> None:
    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(build.library_path())],
                          capture_output=True, text=True).stdout
    wanted = {"tns_iir_kernelIfEE": "tns_iir float32",
              "trunc_pack_kernelILi2ELi24ELb1EEEv": "trunc_pack C = 2, 24 bits, vectors",
              "tns_autocorr_kernelIfLi8EEEv": "tns_autocorr float32, 8 steps",
              "tns_fir_gate_kernelIfLi2048EEEv": "tns_fir_gate float32, 2048 samples"}
    for fn in re.split(r"(?=\n\s+Function : )", sass):
        name = re.search(r"Function : (\S+)", fn)
        for key, label in wanted.items():
            if name and key in name.group(1):
                ops = collections.Counter(
                    re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\d\s+)?([A-Z0-9_.]+)", fn))
                print(f"{label} SASS, {sum(ops.values())} operations: "
                      f"{dict(ops.most_common(14))}")


def main() -> int:
    args = sys.argv[1:]
    tree = Path(__file__).resolve().parent.parent
    parent = None
    if "--tree" in args:
        i = args.index("--tree")
        tree = Path(args[i + 1]).resolve()
        del args[i:i + 2]
    if "--parent" in args:
        i = args.index("--parent")
        parent = Path(args[i + 1]).resolve()
        del args[i:i + 2]
    sections = args or list(SECTIONS)
    if set(sections) - set(SECTIONS):
        print(f"kernel_probe: sections are {SECTIONS}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(tree))
    import chip_smoke as cs
    from frad_python_tpu_torch import kernels
    from frad_python_tpu_torch.kernels import build

    print(smi("name,power.limit"))
    print(f"tree {tree}")
    dev = torch.device("cuda")
    build.build()
    build.library()
    probes = {"tns_iir": probe_tns_iir, "egr_pack": probe_egr_pack, "i24": probe_i24,
              "trunc_pack": probe_trunc_pack, "tns_autocorr": probe_tns_autocorr,
              "fir_gate": probe_fir_gate}
    ok = True
    for name in sections:
        if name == "sass":
            probe_sass(build)
        elif name == "autocorr_variants":
            ok &= probe_autocorr_variants(cs, kernels, dev, build)
        elif name == "fir_gate_variants":
            ok &= probe_fir_gate_variants(cs, kernels, dev, build)
        elif name == "thres":
            ok &= probe_thres(cs, kernels, dev, parent, build)
        elif name == "thres_registers":
            probe_registers(build, ("mask_thres.cu", "thres_expand.cu"))
        elif name == "decode":
            ok &= probe_decode(cs, kernels, dev, parent, build)
        elif name == "trunc_unpack":
            ok &= probe_trunc_unpack(cs, kernels, dev, parent, build)
        elif name == "decode_variants":
            ok &= probe_decode_variants(cs, kernels, dev, build)
        elif name == "decode_registers":
            probe_registers(build, ("dequant.cu", "overlap_add.cu"))
        elif name == "trace":
            probe_trace(cs, kernels, dev)
        elif name == "flips":
            probe_flips(cs, kernels, dev, parent, build)
        else:
            ok &= probes[name](cs, kernels, dev)
    print("all equal" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
