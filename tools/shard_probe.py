"""The sharded path of the PyTorch port on several cards: one process a
card over NCCL, held against the single-device cores.

    python3 tools/shard_probe.py [--ranks 4] [--device cuda|cpu] [--seconds 30]

Starts `--ranks` processes on this host, one a card (`--device cpu`: gloo,
a rehearsal without cards). They join one process group over TCP on
localhost and run, on the `p1_stereo_44k1` track (`chip_smoke.make_audio`,
44.1 kHz stereo, 2048-sample frames, overlap ratio 16) cut to
`--seconds`, its frames padded to a multiple of the ranks:

* on a 1-D mesh of every rank and on a (ranks / 2, 2) (data, channel)
  mesh: the six `sharded_*` cores, `overlap_add_sharded` and
  `training_step_equivalent`, at float32 and float64. Rank 0 holds each
  result against the port's single-device cores run on its own card block
  by block on the same blocks (bit for bit: the same shapes on the same
  kind of card), and against one call on the whole batch (at float64
  symbols equal and PCM within 1e-12; at float32 it counts what differs,
  since the DCT GEMM sums a block's fewer rows in another order);
* spanwise encodes (`multihost.host_span`, final only on the last rank)
  of `p1_stereo_44k1` and `p0_stereo_44k1` at float64 and float32, joined
  on rank 0 by `gather_bitstream` and by `_gather_allgather_chunked`,
  against one `batch_encode` on rank 0's card: byte for byte at float64,
  the frame plan at float32 with the payloads that differ counted.

Walls: the slowest rank's host wall of the second of two calls, each
ending in a synchronize. Prints the card's name and power limit first;
exits non-zero on any failure. Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
SRATE, BITS, FSIZE, LOSS, FACTOR = 44100, 16, 2048, 0.5, 2.0 ** 15
CUT = FSIZE * 15 // 16
OLAP = FSIZE - CUT
RANK_TIMEOUT_S = 600
#: float64 results on blocks against one call on the whole batch: symbols
#: equal; PCM and coefficients within the lossless float64 tolerance (the
#: FFT of fewer rows may round its last bit otherwise)
WHOLE_F64_MAX_ABS = 1e-12


def launch(args) -> int:
    """Start the ranks, print rank 0's output and the failing ranks' errors."""
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip())
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r), "--port", str(port),
                               "--ranks", str(args.ranks), "--device", args.device,
                               "--seconds", str(args.seconds)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(args.ranks)]
    rc = 0
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=RANK_TIMEOUT_S)
            if r == 0:
                print(out, end="")
            if p.returncode:
                rc = rc or p.returncode
                print(f"rank {r} exited {p.returncode}:\n{err[-4000:]}", file=sys.stderr)
    finally:
        for p in procs:
            p.kill()
            p.wait()
    return rc


def blockwise(torch, fn, arrays, nd: int, nc: int, dev) -> list[np.ndarray]:
    """`fn` (a single-device core) on each (data, channel) block of the
    [B, ., C] host arrays on `dev`, its outputs joined as the mesh joins
    them."""
    from frad_python_tpu_torch.ops.policy import to_device, to_host

    rows = []
    for i in range(nd):
        cols = []
        for j in range(nc):
            blk = [np.ascontiguousarray(np.split(np.split(a, nd)[i], nc, axis=2)[j])
                   for a in arrays]
            out = fn(*(to_device(a, dev) for a in blk))
            cols.append(to_host(*(out if isinstance(out, tuple) else (out,))))
        rows.append([np.concatenate(parts, axis=-1) for parts in zip(*cols)])
    return [np.concatenate(parts) for parts in zip(*rows)]


class Report:
    """Rank 0's comparisons and walls; raises at the end on a failure."""

    def __init__(self):
        self.failed = []

    def hold(self, name: str, got, blocks, whole, exact_whole: bool, wall: float) -> None:
        same_blocks = all(g.shape == b.shape and np.array_equal(g, b) for g, b in zip(got, blocks))
        diff = [int((g != w).sum()) if g.shape == w.shape else -1 for g, w in zip(got, whole)]
        dmax = [float(np.abs(g.astype(np.float64) - w.astype(np.float64)).max())
                if g.shape == w.shape and g.size else float("inf") for g, w in zip(got, whole)]
        close = all(d <= (WHOLE_F64_MAX_ABS if g.dtype.kind == "f" else 0)
                    for g, d in zip(got, dmax))
        ok = same_blocks and (not exact_whole or close)
        print(f"{name}: {wall:.4f} s; blockwise single-device equal {same_blocks}; whole batch "
              f"{'equal' if not any(diff) else f'differs in {diff} elements, max |d| {max(dmax)}'}"
              f"{'' if ok else '  FAIL'}")
        if not ok:
            self.failed.append(name)


def rank_main(args) -> int:
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(REPO))
    import chip_smoke
    import frad_python_tpu_torch as ft
    from frad_python_tpu_torch import kernels
    from frad_python_tpu_torch.models import batch
    from frad_python_tpu_torch.ops.policy import to_device, to_host
    from frad_python_tpu_torch.parallel import multihost, sharded
    from frad_python_tpu_torch.parallel.pipeline import _parse_frames

    torch.set_num_threads(1 if args.device == "cpu" else torch.get_num_threads())
    n, rank = args.ranks, args.rank
    multihost.init_distributed(f"localhost:{args.port}", n, rank, device=args.device)
    dev = torch.device("cuda", torch.cuda.current_device()) if args.device == "cuda" \
        else torch.device("cpu")
    lead = rank == 0
    rep = Report()
    pcm = chip_smoke.make_audio(args.seconds, SRATE, 2)
    frames, pad = sharded.pad_to_multiple(chip_smoke.track_frames(pcm), n)
    if lead:
        print(f"{n} ranks ({dist.get_backend()}), torch {torch.__version__}, "
              f"{len(frames) - pad} frames + {pad} padding of [{FSIZE}, 2]")

    def timed(fn):
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = torch.tensor([time.perf_counter() - t0], dtype=torch.float64, device=dev)
        dist.all_reduce(wall, op=dist.ReduceOp.MAX)
        return out, float(wall.item())

    meshes = {"1-D": (sharded.make_mesh(n, device=args.device), n, 1)}
    if n % 2 == 0:
        meshes["2-D"] = (sharded.make_mesh_2d(n // 2, 2, device=args.device), n // 2, 2)
    whole = (1, 1)
    for label, (mesh, nd, nc) in meshes.items():
        for dtype in ("float32", "float64"):
            x = frames.astype(dtype)
            tag = f"{label} {dtype}"

            def case(name, call, core, inputs, exact_whole):
                got, wall = timed(call)
                got = got if isinstance(got, tuple) else (got,)
                if lead:
                    rep.hold(f"{tag} {name}", got, blockwise(torch, core, inputs, nd, nc, dev),
                             blockwise(torch, core, inputs, *whole, dev), exact_whole, wall)
                return got

            exact = dtype == "float64"
            (coeffs,) = case("sharded_p0_encode", lambda: sharded.sharded_p0_encode(mesh, x),
                             batch.p0_encode_core, (x,), exact)
            case("sharded_p0_decode", lambda: sharded.sharded_p0_decode(mesh, coeffs),
                 batch.p0_decode_core, (coeffs,), exact)
            enc, dec = {}, {}
            for p in (1, 2):
                core = getattr(batch, f"p{p}_encode_core")
                enc[p] = case(f"sharded_p{p}_encode",
                              lambda p=p: getattr(sharded, f"sharded_p{p}_encode")(
                                  mesh, x, SRATE, LOSS, FACTOR),
                              lambda f, c=core: c(f, SRATE, LOSS, FACTOR), (x,), exact)
                sym = [a.astype(np.float64) for a in enc[p]]
                core = getattr(batch, f"p{p}_decode_core")
                dec[p] = case(f"sharded_p{p}_decode",
                              lambda p=p, sym=sym: getattr(sharded, f"sharded_p{p}_decode")(
                                  mesh, *sym, SRATE, FACTOR),
                              lambda *a, c=core: c(*a, SRATE, FACTOR), sym, exact)
            pcm_d = dec[1][0].astype(dtype)
            w = sharded.halo_window(OLAP, getattr(torch, dtype), dev)

            def whole_blend(f, w=w):
                return kernels.overlap_add_plain(f.transpose(1, 2).contiguous(), w, CUT,
                                                    False)[0]

            got, wall = timed(lambda: sharded.overlap_add_sharded(mesh, pcm_d, OLAP, CUT))
            if lead:
                want = blockwise(torch, whole_blend, (pcm_d,), *whole, dev)
                rep.hold(f"{tag} overlap_add_sharded", (got,), want, want, True, wall)
            got, wall = timed(lambda: sharded.training_step_equivalent(
                mesh, x, SRATE, LOSS, FACTOR))
            if lead:
                fq, tq = blockwise(torch, lambda f: batch.p1_encode_core(
                    f, SRATE, LOSS, FACTOR), (x,), nd, nc, dev)
                (dec_b,) = blockwise(torch, lambda a, b: batch.p1_decode_core(
                    a, b, SRATE, FACTOR), (fq.astype(np.float64), tq.astype(np.float64)),
                    nd, nc, dev)
                (want,) = to_host(batch.overlap_add_core(to_device(dec_b, dev), OLAP, CUT))
                rep.hold(f"{tag} training_step_equivalent", (got,), (want,), (want,), True,
                         wall)

    # spanwise encodes, gathered to rank 0
    for name, profile, bits, compact, kw in (
            ("p1_stereo_44k1", 1, BITS, True, dict(i16_upload=True)),
            ("p0_stereo_44k1", 0, chip_smoke.P0_BITS, False, {})):
        for dtype in ("float64", "float32"):
            span = multihost.host_span(len(pcm), FSIZE, 16 if compact else 0, compact)
            part, wall = timed(lambda: ft.batch_encode(
                pcm[span.start:span.stop], profile, SRATE, bits, FSIZE, final=rank == n - 1,
                compute_dtype=dtype, device=dev, **kw))
            t0 = time.perf_counter()
            joined = multihost.gather_bitstream(part, order_key=span.first_frame)
            t_gather = time.perf_counter() - t0
            chunked = multihost._gather_allgather_chunked(part, span.first_frame, 1 << 20)
            if not lead:
                if joined is not None or chunked is not None:
                    raise AssertionError(f"rank {rank} received a gathered stream")
                continue
            ref = ft.batch_encode(pcm, profile, SRATE, bits, FSIZE, compute_dtype=dtype,
                                  device=dev, **kw)
            (hj, pj, tj), (hr, pr, tr) = _parse_frames(joined), _parse_frames(ref)
            differ = sum(a != b for a, b in zip(pj, pr))
            plan = [p is None for p in pj] == [p is None for p in pr] and tj == tr == b""
            ok = chunked == joined and plan and (joined == ref or dtype == "float32")
            print(f"spanwise {name} {dtype}: {n} spans encoded in {wall:.4f} s, gathered "
                  f"({len(joined)} bytes) in {t_gather:.4f} s, chunked all-gather equal "
                  f"{chunked == joined}; against one batch_encode: equal {joined == ref}, "
                  f"{differ} of {len(pr)} payloads differ{'' if ok else '  FAIL'}")
            if not ok:
                rep.failed.append(f"spanwise {name} {dtype}")
    dist.destroy_process_group()
    if lead:
        if rep.failed:
            raise AssertionError(f"shard_probe: failed {rep.failed}")
        print("shard_probe: ok")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    args = ap.parse_args()
    return launch(args) if args.rank is None else rank_main(args)


if __name__ == "__main__":
    sys.exit(main())
