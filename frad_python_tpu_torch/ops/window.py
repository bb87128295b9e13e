"""Overlap window.

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
