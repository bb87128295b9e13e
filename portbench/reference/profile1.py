"""Judge of Profile 1 streams, named by a configuration's `judge`: compact
frames whose payloads are DEFLATE-packed Exp-Golomb-Rice symbols of the
psychoacoustic quantiser (`codec.p1_analysis`).

A judge module gives `judge.py` what depends on the profile: whether its
frames are compact (`COMPACT`), the name of its encode number (`EXCESS`),
the stream reader (`parse`), a payload group's arrays (`symbols`), the
distance of those arrays from the reference's values beyond what rounding
allows (`excess`), their decode (`synthesis`) and the control's arrays in
their place (`control`). A new profile is a new module beside this one."""

from __future__ import annotations

import numpy as np
import torch

from . import codec, stream

COMPACT = True
EXCESS = "p1_symbol_excess"

parse = stream.parse


def symbols(group: list[stream.Frame]) -> tuple[np.ndarray, np.ndarray]:
    """(freqs [F, N, C], thres [F, 27, C]) int64 of frames of one size."""
    return stream.p1_symbols(group)


def excess(x: torch.Tensor, parts, cfg, prec: codec.Precision) -> torch.Tensor:
    """Each symbol's distance from the reference's value before rounding,
    less the half step that rounding allows."""
    freqs, thres = parts
    v, t = codec.p1_analysis(x, cfg.srate, cfg.loss_level, cfg.bit_depth, prec)
    return torch.cat([(torch.abs(freqs - v.double()) - 0.5).flatten(),
                      (torch.abs(thres - t.double()) - 0.5).flatten()])


def synthesis(parts, bits: int, cfg, prec: codec.Precision) -> torch.Tensor:
    freqs, thres = parts
    return codec.p1_synthesis(freqs, thres, cfg.srate, bits, prec)


def control(x: torch.Tensor, cfg, prec: codec.Precision) -> tuple[np.ndarray, np.ndarray]:
    """The symbols the reference writes at `prec`: its values rounded."""
    v, t = codec.p1_analysis(x, cfg.srate, cfg.loss_level, cfg.bit_depth, prec)
    return torch.round(v).long().cpu().numpy(), torch.round(t).long().cpu().numpy()
