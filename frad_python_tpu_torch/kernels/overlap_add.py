"""`overlap_add`: the decoder's overlap-add crossfade and PCM emit.

The port of the Pallas kernel `crossfade_frames` (frad_python_tpu/
research/pallas_kernels.py), widened to all of the JAX package's
`overlap_add_core` plus the s16 emit and the fragment slice of its fused
P1 decode, and to the local blend of `overlap_add_sharded`
(frad_python_tpu/parallel/sharded.py), whose first frame is blended with
a halo, the tail of the frame before it on another shard. `overlap_add`
launches the CUDA kernel (csrc/overlap_add.cu) for CUDA tensors and runs
`overlap_add_plain` for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..ops import policy
from . import build


def crossfade_window(olap: int, device: str | torch.device,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The [olap] fade-in window, computed in `dtype` (float32 or float64)
    in the same operation order as the JAX overlap-add (its cos may differ
    from numpy's by an ulp); cached once per card (`policy.device_key`)."""
    return _crossfade_window(olap, policy.device_key(device), dtype)


#: room for the overlaps and dtypes of a run on four cards
@functools.lru_cache(maxsize=128)
def _crossfade_window(olap: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    ft = np.float64 if dtype == torch.float64 else np.float32
    a = np.arange(1, olap + 1, dtype=ft)
    w = ft(0.5) * (ft(1.0) - np.cos(ft(np.pi) * a / ft(olap + 1)))
    return torch.from_numpy(w.astype(ft)).to(device)


def overlap_add_plain(pcm: torch.Tensor, w: torch.Tensor, cut: int, i16: bool,
                      halo: torch.Tensor | None = None):
    """pcm [B, C, N] float32 or float64 frames, w [olap] window of the
    same dtype, halo None or [C, olap] of that dtype -> (out [B, cut, C]
    int16 (x32768, clamped) or that dtype, frag [olap, C] of that dtype).

    Frame 0's head passes through, or with a halo (the raw tail of the
    frame before frame 0, held by another shard of the batch) is blended
    with it as frame b >= 1's first olap samples are with
    prev[cut:cut+olap]: head*w + tail*reverse(w); samples [olap:cut] are
    copied; frag is the last frame's raw [cut:cut+olap] tail."""
    olap = w.shape[0]
    frames = pcm.transpose(1, 2)                               # [B, N, C]
    out = frames[:, :cut, :].clone()
    if olap:
        out[1:, :olap, :] = (frames[1:, :olap, :] * w[:, None]
                             + frames[:-1, cut:cut + olap, :] * w.flip(0)[:, None])
        if halo is not None:
            out[0, :olap, :] = frames[0, :olap, :] * w[:, None] + halo.T * w.flip(0)[:, None]
    frag = frames[-1, cut:cut + olap, :].clone()
    if i16:
        out = torch.clamp(torch.round(out * 32768.0), -32768, 32767).to(torch.int16)
    return out, frag


def _check_halo(pcm: torch.Tensor, w: torch.Tensor, halo: torch.Tensor) -> None:
    """Raises where `halo` is not a contiguous [C, olap] tensor of pcm's
    dtype on pcm's device (pcm's and w's own faults are the caller's)."""
    if pcm.dim() != 3 or w.dim() != 1:
        return
    want = (pcm.shape[1], w.shape[0])
    if halo.device != pcm.device:
        raise ValueError(f"overlap_add: halo on {halo.device}, pcm on {pcm.device}")
    if halo.dtype != pcm.dtype:
        raise TypeError(f"overlap_add: halo of {halo.dtype}, pcm of {pcm.dtype}")
    if tuple(halo.shape) != want:
        raise ValueError(f"overlap_add: halo [C, olap] = {want} required, got "
                         f"{tuple(halo.shape)}")
    if not halo.is_contiguous():
        raise ValueError("overlap_add: contiguous halo required")


def overlap_add(pcm: torch.Tensor, w: torch.Tensor, cut: int, i16: bool,
                halo: torch.Tensor | None = None):
    """See `overlap_add_plain`; one kernel launch for CUDA tensors."""
    if halo is not None:
        _check_halo(pcm, w, halo)
    if pcm.device.type == "cpu" and w.device.type == "cpu":
        return overlap_add_plain(pcm, w, cut, i16, halo)
    if pcm.device.type != "cuda" or w.device != pcm.device:
        raise ValueError(f"overlap_add: tensors on {pcm.device} and {w.device}")
    if pcm.dtype not in (torch.float32, torch.float64) or w.dtype != pcm.dtype:
        raise TypeError(f"overlap_add: float32 or float64 inputs of one dtype required, got "
                        f"{pcm.dtype}, {w.dtype}")
    if pcm.dim() != 3 or w.dim() != 1:
        raise ValueError(f"overlap_add: pcm [B, C, N] and w [olap] required, got "
                         f"{tuple(pcm.shape)}, {tuple(w.shape)}")
    b, c, n = pcm.shape
    olap = w.shape[0]
    if b < 1 or cut < 0 or cut + olap > n or olap > cut:
        raise ValueError(f"overlap_add: bad geometry B={b} N={n} olap={olap} cut={cut}")
    if not (pcm.is_contiguous() and w.is_contiguous()):
        raise ValueError("overlap_add: contiguous inputs required")
    out = torch.empty((b, cut, c), dtype=torch.int16 if i16 else pcm.dtype,
                      device=pcm.device)
    frag = torch.empty((olap, c), dtype=pcm.dtype, device=pcm.device)
    lib = build.library()
    with build.on_device("overlap_add", pcm, w, halo) as stream:
        err = lib.frad_overlap_add(
            ctypes.c_void_p(pcm.data_ptr()), ctypes.c_void_p(w.data_ptr()),
            ctypes.c_void_p(None if halo is None else halo.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(frag.data_ptr()),
            b, c, n, olap, cut, int(bool(i16)), int(pcm.dtype == torch.float64),
            stream)
    build.check("frad_overlap_add", err)
    overlap_add.launches += 1
    return out, frag


#: kernel launches since the last reset (CPU calls do not count)
overlap_add.launches = 0
