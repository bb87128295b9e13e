"""Music-like test audio made from a seed on the device.

A widened copy of the port's smoke content (`chip_smoke.make_audio`: four
harmonics of 220 Hz plus noise): three voices (bass, middle, lead) play
harmonic notes whose pitch, level, timbre and length change every
150-600 ms, panned across the channels, over broadband noise at a low
level. Spectra therefore move as music's do, so the coder sees the range
of thresholds and symbol sizes a real track gives it; a steady tone packs
unrealistically small.

Every seed plays the same set of notes: each note parameter takes the
same evenly spread values, which the seed only puts in another order (as
it does the voices' places in the stereo image); the seed draws the
phases and the noise. So seeds change the content and not the amount of
work a track makes. Every draw comes from one `torch.Generator` on the
device, in a few large calls, so a seed gives the same tracks on the same
kind of card. The
tracks are quantised to the PCM depth they stand for and handed back as
float64 host arrays, as a decoded PCM file would be.
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: (lowest, highest) fundamental of each voice in Hz
VOICES = ((55.0, 220.0), (150.0, 600.0), (300.0, 1500.0))
HARMONICS = 8
NOTE_S = (0.15, 0.6)
#: a voice's peak level, before its notes' levels of -18..0 dB
VOICE_PEAK = 0.4
NOISE_RMS = 0.002
ATTACK_S, RELEASE_S = 0.01, 0.02


def _track(gen: torch.Generator, samples: int, srate: int, channels: int,
           device: torch.device) -> torch.Tensor:
    t = torch.arange(samples, device=device, dtype=torch.int64)
    out = torch.zeros(samples, channels, device=device, dtype=torch.float64)
    notes = int(math.ceil(samples / (sum(NOTE_S) / 2 * srate))) + 8
    grid = (torch.arange(notes, device=device, dtype=torch.float64) + 0.5) / notes

    def spread():
        """The same evenly spread values in [0, 1] for every seed, in the
        seed's order: every seed plays the same set of notes."""
        return grid[torch.randperm(notes, generator=gen, device=device)]

    pans = (torch.arange(len(VOICES), device=device, dtype=torch.float64) + 0.5) / len(VOICES)
    pans = pans[torch.randperm(len(VOICES), generator=gen, device=device)]
    where = torch.linspace(0.0, 1.0, channels, device=device, dtype=torch.float64)
    for v, (lo, hi) in enumerate(VOICES):
        length = ((NOTE_S[0] + (NOTE_S[1] - NOTE_S[0]) * spread()) * srate).round().to(torch.int64)
        ends = torch.cumsum(length, 0)
        starts = ends - length
        f0 = lo * (hi / lo) ** spread()
        level = 10.0 ** (-18.0 * spread() / 20.0)
        tilt = 0.8 + 1.2 * spread()
        decay = 0.5 + 4.0 * spread()
        phase0 = 2 * math.pi * torch.rand(notes, generator=gen, device=device,
                                          dtype=torch.float64)
        note = torch.bucketize(t, ends, right=True)
        local = (t - starts[note]).to(torch.float64) / srate
        span = length[note].to(torch.float64) / srate
        env = torch.clamp(local / ATTACK_S, max=1.0) * torch.clamp((span - local) / RELEASE_S,
                                                                   min=0.0, max=1.0)
        env = env * torch.exp(-decay[note] * local) * level[note]
        h = torch.arange(1, HARMONICS + 1, device=device, dtype=torch.float64)
        amp = h[None, :] ** -tilt[:, None]
        amp = amp / amp.sum(dim=1, keepdim=True)                         # [notes, H]
        phase = 2 * math.pi * f0[note] * local + phase0[note]
        voice = torch.zeros(samples, device=device, dtype=torch.float64)
        for k in range(HARMONICS):
            voice += amp[note, k] * torch.sin((k + 1) * phase)
        gains = VOICE_PEAK * (1.0 - 0.4 * torch.abs(where - pans[v]))
        out += (voice * env)[:, None] * gains[None, :]
    out += NOISE_RMS * torch.randn(samples, channels, generator=gen, device=device,
                                   dtype=torch.float64)
    return out


def album(seconds: list[float], srate: int, channels: int, bits: int, seed: int,
          device: str | torch.device) -> list[np.ndarray]:
    """Tracks of the given lengths from `seed`: [samples, channels] float64
    host arrays on the grid of `bits`-bit PCM, in [-1, 1 - 2^(1 - bits)]."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    scale = float(2 ** (bits - 1))
    tracks = []
    for s in seconds:
        x = _track(gen, int(round(s * srate)), srate, channels, device)
        x = torch.clamp(torch.round(x * scale), -scale, scale - 1) / scale
        tracks.append(x.cpu().numpy())
    return tracks
