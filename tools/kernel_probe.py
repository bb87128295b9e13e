"""Device times of the redesigned kernels on one CUDA card, warm, with the
SM clock they ran at and what the compiler made of `tns_iir`.

    python3 tools/kernel_probe.py

Prints, after the card's name and power limit:

* `tns_iir` at chip_smoke.py's TNS_SHAPES, float32 and float64: bit-equal
  to its plain version or not, and the mean device time of REPS launches
  from one `torch.profiler` call;
* the SM clock and power draw `nvidia-smi` reads while `tns_iir` at
  [8, 2048] runs back to back, so that a time can be read as cycles a
  step (time * clock / samples);
* the opcode counts of the float32 `tns_iir` kernel from
  `cuobjdump -sass` (one tile is 32 steps, fully unrolled);
* `egr_pack` at chip_smoke.py's EGR_FORMS: words equal to plain or not,
  and the mean device time of each of its kernels over REPS launches
  (the symbols are in L2 from the launch before, unlike chip_smoke.py's
  single launch);
* `i24_pack` (transposed view and contiguous) and `i24_unpack` at
  I24_SHAPES likewise.

Needs a CUDA device and nvcc; any mismatch exits non-zero.
"""

from __future__ import annotations

import collections
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs                                          # noqa: E402
from frad_python_tpu_torch import kernels                        # noqa: E402
from frad_python_tpu_torch.kernels import build                  # noqa: E402

REPS = 10


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


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device", file=sys.stderr)
        return 2
    print(smi("name,power.limit"))
    dev = torch.device("cuda")
    path, _ = build.build()
    build.library()
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

    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(path)], capture_output=True,
                          text=True).stdout
    for fn in re.split(r"(?=\n\s+Function : )", sass):
        name = re.search(r"Function : (\S+)", fn)
        if name and "tns_iir_kernelIfEE" in name.group(1):
            ops = collections.Counter(
                re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\d\s+)?([A-Z0-9_.]+)", fn))
            print(f"tns_iir float32 SASS, {sum(ops.values())} operations: "
                  f"{dict(ops.most_common(12))}")

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
    print("all equal" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
