"""The least time one card needs for a call's work: the yardstick of the
`*_roofline` metrics (the bound arithmetic of `chip_smoke.bound`, frozen
here).

Per call, the larger of two terms:

* bytes: the chain's device-resident inputs and outputs, each moved once,
  over the card's memory rate. The PCM crosses at the depth it stands
  for (the input of an encode, the output of a decode); a lossless chain
  also moves every transform coefficient at the stream depth (the output
  of its encode, the input of its decode). A lossy chain's symbols are
  not counted: their coded size depends on the data. Intermediates are
  not counted.
* operations: the fastest transform the chain must do, an N-point fast
  DCT of every channel-frame, at (17/9) N log2 N real operations (the
  fewest known for a power-of-two length), over the card's float32 rate
  outside the tensor cores.

Both terms count the same work whatever implements it, so a fused or an
FFT-form chain cannot read above 100%.
"""

from __future__ import annotations

import math

#: NVIDIA H100 SXM data sheet: HBM3 rate, float32 rate without tensor cores
HBM_BYTES_PER_S = 3.35e12
FLOAT32_OPS_PER_S = 67e12
FAST_DCT_OPS = 17.0 / 9.0


def dct_ops(n: int) -> float:
    return FAST_DCT_OPS * n * math.log2(n) if n > 1 else 0.0


def least_seconds(sizes: list[int], samples: int, channels: int, bits: int,
                  lossless: bool) -> float:
    """Least time of one encode or decode of `samples` PCM samples cut into
    frames of `sizes`."""
    depth = bits / 8.0
    nbytes = samples * channels * depth
    if lossless:
        nbytes += sum(sizes) * channels * depth
    ops = channels * sum(dct_ops(n) for n in sizes)
    return max(nbytes / HBM_BYTES_PER_S, ops / FLOAT32_OPS_PER_S)
