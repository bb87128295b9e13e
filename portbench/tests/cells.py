"""Cells of the kept traffic and configuration files that BENCHMARK.json
does not list (PERF.md: too noisy for a bound on the card so far), built
from their files as the harness builds a listed one."""

from portbench import spec

UNLISTED = {
    "p1_track_batch_x4": ("p1_stereo_44k1", "track_batch",
                          ["encode_frames_per_s", "decode_frames_per_s"]),
    "p0_track_batch": ("p0_stereo_44k1", "track_batch",
                       ["encode_frames_per_s", "decode_frames_per_s"]),
    "p1_track_stream": ("p1_stereo_44k1", "track_stream", ["stream_frames_per_s"]),
}


def cell(name: str) -> spec.Cell:
    if name not in UNLISTED:
        return spec.cell(spec.load(), name)
    config, traffic, rates = UNLISTED[name]
    e2e = [{"name": r, "unit": "frames/s"} for r in rates] + [{"name": "setup_s", "unit": "s"}]
    return spec.Cell(name, spec.config(config), spec.traffic(traffic),
                     4 if name.endswith("_x4") else 1, e2e, [])
