"""The frame-batch split of the PyTorch port's batch cores over one
process's own cards (`models/batch.py`: `place_rows`, `run_rows`,
`decode_oa_rows`).

    python3 tools/local_split_probe.py [--device cuda|cpu] [--seconds 30] [--reps 5] [--out FILE]

In one process, over every visible card (`--device cpu`: four CPU
devices, a rehearsal without cards):

* every batch core through `run_rows` (and the decode's overlap-add
  through `decode_oa_rows`) on inputs made from the `p1_stereo_44k1` track
  (`chip_smoke.make_audio`, 44.1 kHz stereo, 2048-sample frames, overlap
  ratio 16) cut to `--seconds`: split over the cards, each block's outputs
  on its own card, and split over as many logical blocks of card 0
  (`_data_devices` patched to [cuda:0] * n), which is the same core on one
  card on the same block: bit for bit. Against one call on the whole
  batch the elements that differ are counted (float32 GEMMs of fewer rows
  sum in another order);
* `batch_encode` / `batch_decode` of `p1_stereo_44k1` (int16 upload and
  transfer) and `hires_96k_8ch` (cut to 10 s): the streams and PCM of the
  split over the cards equal the logical split's; walls on every card
  (device "cuda") against card 0 alone (device "cuda:0", which never
  splits): the median of `--reps` calls, each ending in a synchronise of
  every card; the halo copies between cards in one decode (overlap_add
  launches given a halo);
* one traced encode and one traced decode of `p1_stereo_44k1` on every
  card (`torch.profiler`, CUDA activity): each card's busy time and span,
  and the busy time of all cards together against its sum (1.0: the
  cards ran one after another; n: all at once).

Prints the card's name and power limit first and a JSON line last (with
`--out`, every number, the walls of each call among them, is written to
FILE as JSON); exits non-zero on any failure. Imports neither jax nor the
JAX package.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

SRATE, BITS, FSIZE, LOSS, FACTOR = 44100, 16, 2048, 0.5, 2.0 ** 15
CUT = FSIZE * 15 // 16
OLAP = FSIZE - CUT
CPU_BLOCKS = 4


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def core_cases(frames: np.ndarray, device: str) -> list:
    """(name, runner) of every core: runner(device) -> Rows."""
    from frad_python_tpu_torch.models import batch
    from frad_python_tpu_torch.ops import bitpack

    f32 = frames.astype(np.float32)
    i16 = np.clip(np.rint(frames * 32768.0), -32768, 32767).astype(np.int16)
    words24 = bitpack.pcm_to_i24_words_host(frames).reshape(len(frames), -1).view(np.int32)
    _, n, c = frames.shape

    def run(core, *arrays, args=()):
        return lambda d: batch.run_rows(core, arrays, d, *args)

    # inputs of the decodes: the outputs of the encodes in one call
    with batch.sharding_disabled():
        coeffs, = batch.run_rows(batch.p0_encode_core, (f32,), device).fetch()
        payload, _ = batch.run_rows(batch.p0_encode_pack_core, (f32,), device, 24,
                                    False).fetch()
        fq, tq = batch.run_rows(batch.p1_encode_core, (frames,), device, SRATE, LOSS,
                                FACTOR).fetch()
        pfq, ptq, plq = batch.run_rows(batch.p2_encode_core, (frames,), device, SRATE, LOSS,
                                       FACTOR).fetch()
    fq16, tq32 = fq.astype(np.int16), tq.astype(np.float32)
    p2 = (pfq.astype(np.float32), ptq.astype(np.float32), plq.astype(np.float32))
    return [
        ("p0_encode_core f32", run(batch.p0_encode_core, f32)),
        ("p0_encode_core f64", run(batch.p0_encode_core, frames)),
        ("p0_decode_core f32", run(batch.p0_decode_core, coeffs)),
        ("p0_encode_pack_core", run(batch.p0_encode_pack_core, f32, args=(24, False))),
        ("p0_encode_pack_core_i24", run(batch.p0_encode_pack_core_i24, words24,
                                        args=(24, False, n, c))),
        ("p0_unpack_decode_core", run(batch.p0_unpack_decode_core, payload,
                                      args=(24, False, n, c))),
        ("p0_unpack_decode_i24_core", run(batch.p0_unpack_decode_i24_core, payload,
                                          args=(24, False, n, c))),
        ("p1_encode_core f32", run(batch.p1_encode_core, f32, args=(SRATE, LOSS, FACTOR))),
        ("p1_encode_core f64", run(batch.p1_encode_core, frames, args=(SRATE, LOSS, FACTOR))),
        ("p1_encode_core_i16", run(batch.p1_encode_core_i16, i16, args=(SRATE, LOSS, FACTOR))),
        ("p1_decode_core", run(batch.p1_decode_core, fq16, tq32, args=(SRATE, FACTOR))),
        ("p2_encode_core f32", run(batch.p2_encode_core, f32, args=(SRATE, LOSS, FACTOR))),
        ("p2_decode_core", run(batch.p2_decode_core, *p2, args=(SRATE, FACTOR))),
        ("p1 decode_oa_rows i16", lambda d: batch.decode_oa_rows(
            batch.p1_decode_core, (fq16, tq32), d, (SRATE, FACTOR), OLAP, CUT, True)),
        ("p1 decode_oa_rows f64", lambda d: batch.decode_oa_rows(
            batch.p1_decode_core, (fq.astype(np.float64), tq.astype(np.float64)), d,
            (SRATE, FACTOR), OLAP, CUT, False)),
        ("p2 decode_oa_rows f32", lambda d: batch.decode_oa_rows(
            batch.p2_decode_core, p2, d, (SRATE, FACTOR), OLAP, CUT, False)),
    ]


def hold_cores(batch, frames, cards, logical, device) -> dict:
    """Every core split over `cards` against `logical` blocks of one card,
    bit for bit, and against one call (elements that differ counted)."""
    out = {}
    real = batch._data_devices
    for name, runner in core_cases(frames, device):
        batch._data_devices = lambda d: list(cards)
        rows = runner(device)
        on = [str(b[0].device) for b in rows.blocks]
        got = rows.fetch()
        batch._data_devices = lambda d: list(logical)
        want = runner(device).fetch()
        batch._data_devices = real
        with batch.sharding_disabled():
            whole = runner(device).fetch()
        if on != [str(d) for d in cards] or not all(map(same_bits, got, want)):
            raise AssertionError(f"{name}: blocks on {on}, split over the cards equal to the "
                                 f"logical split {[same_bits(a, b) for a, b in zip(got, want)]}")
        differ = [int((a != b).sum()) if a.shape == b.shape else -1 for a, b in zip(got, whole)]
        out[name] = {"blocks_on": on, "pad": rows.pad, "differ_from_one_call": differ,
                     "elements": [int(a.size) for a in got]}
        print(f"{name}: {len(on)} blocks on {sorted(set(on))}, pad {rows.pad}: equal to the "
              f"logical split bit for bit; elements differing from one call {differ} of "
              f"{out[name]['elements']}")
    return out


def end_to_end(ft, batch, sync, cards, logical, device, alone, reps) -> dict:
    """batch_encode / batch_decode walls on every card against one, the
    streams against the logical split's, and the halo launches."""
    from frad_python_tpu_torch.parallel.pipeline import _parse_frames

    h = cs.HIRES
    configs = (
        ("p1_stereo_44k1", cs.make_audio(cs.SECONDS, SRATE, 2), 1, SRATE, BITS, FSIZE,
         dict(i16_upload=True), dict(i16_transfer=True)),
        ("hires_96k_8ch", cs.make_audio(h["seconds"], h["srate"], h["channels"]), 0,
         h["srate"], h["bits"], h["fsize"], {}, {}))
    res = {}
    for name, pcm, profile, srate, bits, fsize, ekw, dkw in configs:
        def enc(dev):
            return ft.batch_encode(pcm, profile, srate, bits, fsize, compute_dtype="float32",
                                   device=dev, **ekw)

        def dec(stream, dev):
            return ft.batch_decode(stream, compute_dtype="float32", device=dev, **dkw)[0]

        def walls(fn):
            out, ts = None, []
            for _ in range(reps):
                sync()
                t0 = time.perf_counter()
                out = fn()
                sync()
                ts.append(time.perf_counter() - t0)
            return out, ts

        row = {}
        for label, dev in (("one_card", alone), ("all_cards", device)):
            dec(enc(dev), dev)                              # first-use set-up
            stream, te = walls(lambda: enc(dev))
            pcm_out, td = walls(lambda: dec(stream, dev))
            row[label] = {"enc_s": te, "dec_s": td, "enc_median_s": statistics.median(te),
                          "dec_median_s": statistics.median(td)}
            row[label + "_stream"], row[label + "_pcm"] = stream, pcm_out
        halos = []
        real_oa = batch.overlap_add
        batch.overlap_add = lambda *a: halos.append(a[4] is not None) or real_oa(*a)
        try:
            dec(row["all_cards_stream"], device)
        finally:
            batch.overlap_add = real_oa
        real = batch._data_devices
        batch._data_devices = lambda d: list(logical)
        try:
            s_log = enc(device)
            p_log = dec(row["all_cards_stream"], device)
        finally:
            batch._data_devices = real
        s_all, p_all = row.pop("all_cards_stream"), row.pop("all_cards_pcm")
        s_one, p_one = row.pop("one_card_stream"), row.pop("one_card_pcm")
        if s_all != s_log or not same_bits(p_all, p_log):
            raise AssertionError(f"{name}: the split over the cards differs from the logical "
                                 f"split (stream equal {s_all == s_log})")
        parts = [_parse_frames(s)[1] for s in (s_all, s_one)]
        row["payloads_differ_from_one_card"] = sum(a != b for a, b in zip(*parts))
        row["payloads"] = len(parts[1])
        row["snr_all_cards_db"] = cs.snr_db(pcm, p_all)
        row["snr_one_card_db"] = cs.snr_db(pcm, p_one)
        row["halo_launches_per_decode"] = sum(halos)
        res[name] = row
        print(f"{name}: median of {reps} walls (each to a synchronise of every card), "
              f"encode {row['one_card']['enc_median_s']:.4f} s on one card, "
              f"{row['all_cards']['enc_median_s']:.4f} s on {len(set(cards))}; decode "
              f"{row['one_card']['dec_median_s']:.4f} s / {row['all_cards']['dec_median_s']:.4f}"
              f" s; stream of the split equal to the logical split's; "
              f"{row['payloads_differ_from_one_card']} of {row['payloads']} payloads differ "
              f"from one card's; SNR {row['snr_all_cards_db']:.4f} / one card "
              f"{row['snr_one_card_db']:.4f} dB; overlap_add launches with a halo a decode "
              f"{row['halo_launches_per_decode']}")
    return res


def traced(torch, ft, sync, device) -> dict:
    """Each card's kernel busy time and span in one encode and one decode
    of p1_stereo_44k1 on every card, and whether the cards overlapped."""
    from torch.profiler import ProfilerActivity, profile

    pcm = cs.make_audio(cs.SECONDS, SRATE, 2)
    stream = ft.batch_encode(pcm, 1, SRATE, BITS, FSIZE, i16_upload=True, device=device)
    ft.batch_decode(stream, i16_transfer=True, device=device)
    sync()
    calls = {"encode": lambda: ft.batch_encode(pcm, 1, SRATE, BITS, FSIZE, i16_upload=True,
                                               device=device),
             "decode": lambda: ft.batch_decode(stream, i16_transfer=True, device=device)}
    res = {}
    for name, fn in calls.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        spans: dict[int, list] = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.end > \
                    e.time_range.start:
                spans.setdefault(e.device_index, []).append((e.time_range.start,
                                                             e.time_range.end))
        if not spans:
            res[name] = "not measured: the profiler recorded no device events"
            print(f"traced {name}: {res[name]}")
            continue
        busy = {d: union_us(v) for d, v in sorted(spans.items())}
        together = union_us([iv for v in spans.values() for iv in v])
        res[name] = {
            "busy_us": busy, "span_us": {d: max(e for _, e in v) - min(s for s, _ in v)
                                         for d, v in sorted(spans.items())},
            "events": {d: len(v) for d, v in sorted(spans.items())},
            "busy_together_us": together,
            "overlap": sum(busy.values()) / together if together else None}
        print(f"traced {name}: per card busy us {busy}, spans us {res[name]['span_us']}, "
              f"all cards busy together {together:.1f} us, sum over cards / together "
              f"{res[name]['overlap']:.3f}")
    return res


def union_us(intervals: list) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    import torch

    import frad_python_tpu_torch as ft
    from frad_python_tpu_torch.kernels import build
    from frad_python_tpu_torch.models import batch

    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
            print("local_split_probe: needs two or more CUDA devices", file=sys.stderr)
            return 2
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip()
        print(smi)
        build.library()
        n = torch.cuda.device_count()
        cards = [torch.device("cuda", i) for i in range(n)]
        logical = [torch.device("cuda", 0)] * n
        device, alone = "cuda", "cuda:0"

        def sync():
            for i in range(n):
                torch.cuda.synchronize(i)
    else:
        smi = "cpu"
        cards = logical = [torch.device("cpu")] * CPU_BLOCKS
        device = alone = "cpu"
        batch._data_devices = lambda d: list(cards)

        def sync():
            pass

    pcm = cs.make_audio(args.seconds, SRATE, 2)
    frames = cs.track_frames(pcm)
    t0 = time.perf_counter()
    res = {"card": smi, "cards": [str(d) for d in cards], "frames": len(frames),
           "cores": hold_cores(batch, frames, cards, logical, device)}
    res["end_to_end"] = end_to_end(ft, batch, sync, cards, logical, device, alone, args.reps)
    res["traced"] = traced(torch, ft, sync, device) if args.device == "cuda" else \
        "not measured on the CPU"
    res["wall_s"] = time.perf_counter() - t0
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1, default=str))
    print(json.dumps({"ok": True, "card": smi, "cards": len(set(map(str, cards))),
                      "wall_s": res["wall_s"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
