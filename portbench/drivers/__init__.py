"""Traffic drivers, one module a kind of traffic: a traffic file
(`portbench/traffic/<name>.json`) names its driver, and the harness loads
`portbench/drivers/<driver>.py` by that name (`spec.driver`) and takes its
`DRIVER`. A new kind of traffic is a new module here. The keywords the
program's entries take from a configuration are its `encode_args`.

Everything a window feeds the program is made in set-up: the album from
the seed and whatever the driver cuts from it. Set-up warms every call
shape the window uses. A window holds the calls into the program and the
clock, and nothing else; it closes at the end of the first round over the
album that ends after its seconds, so every window holds whole rounds and
the same mix of call sizes. It keeps, for the comparison after it, one
attempt of each kind and track drawn uniformly from the seed (reservoir
sampling; the first round's attempts always enter).
"""

from __future__ import annotations

import numpy as np

from .. import audio, work
from ..reference import judge

#: attempts of one kind and track that the sample draws can cover
_MAX_ATTEMPTS = 1 << 14


class Driver:
    """Shared set-up: the album, its frame plans and the sample draws.

    A driver adds `setup()`, `window(seconds) -> (calls, push seconds)`,
    `rates(calls) -> {end-to-end metric: value}` and `sampled()`, the kept
    attempts as (track, stream bytes, the program's PCM or None for an
    encode)."""

    def __init__(self, ft, torch, cfg: dict, traffic: dict, seed: int, device: str,
                 seconds_override: list[float] | None = None):
        self.ft, self.torch, self.cfg, self.traffic = ft, torch, cfg, traffic
        self.device = device
        self.jcfg = judge.Config.of(cfg)
        self.enc_kw = dict(profile=cfg["profile"], srate=cfg["srate"],
                           bit_depth=cfg["bit_depth"], frame_size=cfg["frame_size"],
                           **{k: cfg[k] for k in cfg["encode_args"]})
        lengths = seconds_override or traffic["tracks_s"]
        self.tracks = audio.album(lengths, cfg["srate"], cfg["channels"], cfg["bit_depth"],
                                  seed, device)
        self.frames, self.least = [], []
        for pcm in self.tracks:
            plan, _ = judge.frame_plan(len(pcm), self.jcfg)
            self.frames.append(len(plan))
            self.least.append(work.least_seconds([p[2] for p in plan], len(pcm),
                                                 cfg["channels"], cfg["bit_depth"],
                                                 not self.jcfg.compact))
        self.draws = np.random.default_rng(int(seed)).random((len(self.tracks), 2, _MAX_ATTEMPTS))
        self.cards = [] if device == "cpu" or not torch.cuda.is_available() else \
            list(range(torch.cuda.device_count()))
        self.kept: dict = {}

    def sync(self) -> None:
        for d in self.cards:
            self.torch.cuda.synchronize(d)

    def keep(self, track: int, kind: int, n: int) -> bool:
        """Whether attempt n (from 0) of this kind and track enters the sample."""
        return self.draws[track, kind, n % _MAX_ATTEMPTS] * (n + 1) < 1.0

    def compare(self, ref_device) -> dict[str, float]:
        """The comparison's numbers over the sampled attempts."""
        faults, excess, gap, parsed = 0, 0.0, 0.0, {}
        for i, data, pcm in self.sampled():
            if id(data) not in parsed:
                parsed[id(data)] = (data, judge.read(data, self.jcfg, len(self.tracks[i])))
            p = parsed[id(data)][1]
            faults += p.faults
            if pcm is None:
                excess = max(excess, judge.encode_excess(p, self.tracks[i], self.jcfg,
                                                         ref_device))
            else:
                gap = max(gap, judge.pcm_gap(p, pcm, self.jcfg, ref_device))
        return {"plan_faults": float(faults), self.jcfg.rules.EXCESS: excess, "pcm_gap": gap}
