"""Device times of the redesigned kernels on one CUDA card, warm, with the
SM clock they ran at and what the compiler made of them.

    python3 tools/kernel_probe.py [--tree DIR] [SECTION ...]

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
SECTIONS = ("tns_iir", "egr_pack", "i24", "trunc_pack", "tns_autocorr", "autocorr_variants",
            "fir_gate", "fir_gate_variants", "sass")


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
    if "--tree" in args:
        i = args.index("--tree")
        tree = Path(args[i + 1]).resolve()
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
        else:
            ok &= probes[name](cs, kernels, dev)
    print("all equal" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
