"""PCM sample-format conversion (copy of `frad_python_tpu.ops.pcm`).

* ffmpeg-style format strings (u8/s16le/f64be/...) -> numpy dtypes
* int <-> f64 normalisation with power-of-two scales, asymmetric (divide
  by 2^(bits-1), unsigned biased by -1)
"""

from __future__ import annotations

import numpy as np


def _gen_formats() -> dict[str, str]:
    fmts = {"u8": "u1", "s8": "i1"}
    for prefix, np_kind, widths in (("u", "u", (16, 32, 64)),
                                    ("s", "i", (16, 32, 64)),
                                    ("f", "f", (16, 32, 64))):
        for bits in widths:
            fmts[f"{prefix}{bits}be"] = f">{np_kind}{bits // 8}"
            fmts[f"{prefix}{bits}le"] = f"<{np_kind}{bits // 8}"
    return fmts


_FORMATS = _gen_formats()


def ff_format_to_numpy_type(fmt: str) -> np.dtype:
    """Map an ffmpeg-style raw PCM format string to a numpy dtype."""
    try:
        return np.dtype(_FORMATS[fmt.lower()])
    except KeyError:
        raise ValueError(f"Invalid PCM format: {fmt!r} (valid: {sorted(_FORMATS)})") from None


def _int_scale(dtype: np.dtype) -> float:
    return float(2 ** (dtype.itemsize * 8 - 1))


def to_f64(pcm: np.ndarray, pcm_format: np.dtype) -> np.ndarray:
    """Normalise integer PCM to [-1, 1) float64; floats pass through."""
    kind = np.dtype(pcm_format).kind
    if kind == "f":
        return np.asarray(pcm, dtype=np.float64)
    scale = _int_scale(np.dtype(pcm_format))
    out = np.asarray(pcm, dtype=np.float64) / scale
    if kind == "u":
        out = out - 1.0
    return out


def from_f64(pcm: np.ndarray, pcm_format: np.dtype) -> np.ndarray:
    """Expand normalised float64 back to the target integer/float format,
    with astype()'s wraparound (no clipping)."""
    dt = np.dtype(pcm_format)
    if dt.kind == "f":
        return pcm.astype(dt)
    scale = _int_scale(dt)
    x = (pcm + 1.0) * scale if dt.kind == "u" else pcm * scale
    with np.errstate(invalid="ignore"):
        return x.astype(dt)
