"""Judge of Profile 0 streams, named by a configuration's `judge`:
lossless frames whose payloads are DCT coefficients as IEEE floats
truncated to the stream depth (see `profile1.py` for what a judge module
gives)."""

from __future__ import annotations

import numpy as np
import torch

from . import codec, stream

COMPACT = False
EXCESS = "p0_coef_excess"

parse = stream.parse


def symbols(group: list[stream.Frame]) -> tuple[np.ndarray]:
    """(coefficients [F, N, C] float64,) of frames of one size."""
    return (stream.lossless_values(group),)


def truncation_step(mag: torch.Tensor, bits: int) -> torch.Tensor:
    """The step of a float of `bits` stored bits at magnitude `mag`: one
    unit of its last kept mantissa bit (24 bits: an f32's top 3 bytes
    keep 15 mantissa bits; 48: an f64's top 6 keep 36; 16/32/64 whole
    IEEE floats)."""
    mant = {16: 10, 24: 15, 32: 23, 48: 36, 64: 52}[bits]
    _, e = torch.frexp(mag)
    return torch.ldexp(torch.ones_like(mag), (e - 1 - mant).to(torch.int32))


def excess(x: torch.Tensor, parts, cfg, prec: codec.Precision) -> torch.Tensor:
    """Each coefficient's distance from the reference's transform beyond
    the truncation step at its magnitude, over the largest coefficient of
    its channel-frame."""
    (got,) = parts
    want = codec.dct(x.transpose(1, 2), prec).double().transpose(1, 2)
    step = truncation_step(torch.maximum(torch.abs(got), torch.abs(want)), cfg.bit_depth)
    scale = torch.amax(torch.abs(want), dim=1, keepdim=True).clamp(min=1e-30)
    return ((torch.abs(got - want) - step) / scale).flatten()


def synthesis(parts, bits: int, cfg, prec: codec.Precision) -> torch.Tensor:
    return codec.lossless_synthesis(parts[0], prec)


def control(x: torch.Tensor, cfg, prec: codec.Precision) -> tuple[np.ndarray]:
    """The coefficients the reference writes at `prec`: its float32
    transform truncated to the stream depth."""
    y = codec.dct(x.transpose(1, 2), prec).float().transpose(1, 2).contiguous()
    keep = 32 - {16: 0, 24: 8, 32: 0}[cfg.bit_depth]
    bits = y.view(torch.int32) & ~((1 << (32 - keep)) - 1)
    return (bits.view(torch.float32).double().cpu().numpy(),)
