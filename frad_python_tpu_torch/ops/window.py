"""Overlap window and the per-frame decoder's host crossfade.

Asymmetric fade-in w[i] = 0.5*(1 - cos(pi*(i+1)/(n+1))), applied by the
decoder as a crossfade between the carried fragment (reversed window)
and the new frame (forward window).
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=128)
def hanning_in_overlap(n: int, dtype: str = "float64") -> np.ndarray:
    """Fade-in window of length n, computed in f64 and cast to `dtype`."""
    return (0.5 * (1.0 - np.cos(np.pi * np.arange(1, n + 1) / (n + 1)))).astype(dtype)


def crossfade(frame: np.ndarray, fragment: np.ndarray, prog: int) -> tuple[np.ndarray, int]:
    """Crossfade `fragment[prog:]` into the head of `frame`.

    Returns (blended frame, samples consumed from the fragment), with
    frame[i] = frame[i]*w[prog+i] + fragment[prog+i]*w[n-prog-i-1] for the
    consumed samples. A fragment longer than the frame is consumed over
    several frames (`prog` carries the progress)."""
    n = len(fragment)
    take = min(n - prog, len(frame))
    if take <= 0:
        return frame, 0
    w = hanning_in_overlap(n, str(frame.dtype)) if frame.dtype.kind == "f" else hanning_in_overlap(n)
    fade_in = w[prog:prog + take, None]
    fade_out = w[::-1][prog:prog + take, None]
    head = frame[:take] * fade_in + fragment[prog:prog + take] * fade_out
    return np.concatenate([head, frame[take:]], axis=0), take
