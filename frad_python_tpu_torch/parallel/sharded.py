"""Sharded codec cores: frame-batch data parallelism over a device mesh.

The counterpart of the JAX package's `parallel/sharded.py`, over
`torch.distributed`. JAX runs one controller over a mesh of devices; here
every rank of the process group runs the same program on its own device
(SPMD) and is one device of the mesh:

* A [B, N, C] frame batch is split into blocks: rows over the mesh's first
  axis ('data'), and on a 2-D (data, channel) mesh (`make_mesh_2d`)
  channels over its second. The transform chain is frame- and
  channel-local, so each rank runs the port's single-device cores
  (`models/batch.py`) on its block with no communication, and the blocks
  are then gathered (`all_gather`) so that every rank returns the whole
  result as host arrays, as the JAX functions return the global array.
* The decoder's overlap-add needs each frame's left neighbour's tail. At a
  block boundary that tail lies on the previous rank along 'data': each
  rank sends its last frame's tail one step along a ring
  (`batch_isend_irecv`), and launches the `overlap_add` kernel once with
  the tail it received as the halo of its first frame
  (`overlap_add_sharded`). Data-rank 0 holds the stream's first frame,
  which has no predecessor: it passes no halo.

Every rank calls each function with the same global host array. On CUDA
the group's backend is NCCL, one rank a card; with `device="cpu"` it is
gloo. A mesh of one device needs no launcher: `make_mesh` starts a
one-rank group itself. Importing this module starts nothing.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..kernels.overlap_add import overlap_add
from ..models import batch
from ..ops.policy import resolve_device, to_device, to_host

#: the process group's backend for each device type
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _start_group(dev: torch.device, n: int) -> None:
    """Check the default process group against a mesh of n ranks on `dev`,
    or start a one-rank group (an in-process store: no file, no network)
    when there is none and n is 1."""
    backend = BACKENDS[dev.type]
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(f"a mesh of {n} devices needs a process group of {n} ranks: "
                               f"call multihost.init_distributed first")
        if backend == "nccl" and not dist.is_nccl_available():
            raise RuntimeError("this PyTorch has no NCCL: a CUDA mesh needs it")
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)
    if backend not in dist.get_backend():
        raise RuntimeError(f"a {dev.type} mesh needs the {backend} backend, the process group "
                           f"has {dist.get_backend()}")
    if n != dist.get_world_size():
        raise ValueError(f"need {n} devices, the process group has {dist.get_world_size()} "
                         f"ranks (one device a rank)")


def make_mesh(n_devices: int | None = None, axis: str = "data",
              device: str | torch.device | None = None) -> DeviceMesh:
    """1-D mesh over the n ranks (default: all) of the process group, one
    device each: CUDA unless `device` is "cpu"."""
    dev = resolve_device(device)
    n = n_devices or (dist.get_world_size() if dist.is_initialized() else 1)
    _start_group(dev, n)
    return init_device_mesh(dev.type, (n,), mesh_dim_names=(axis,))


def make_mesh_2d(n_data: int, n_channel: int,
                 device: str | torch.device | None = None) -> DeviceMesh:
    """2-D (data, channel) mesh: the per-channel transform chain is
    channel-independent, so the C axis shards with no communication;
    'channel' is the inner axis (neighbouring ranks)."""
    dev = resolve_device(device)
    _start_group(dev, n_data * n_channel)
    return init_device_mesh(dev.type, (n_data, n_channel), mesh_dim_names=("data", "channel"))


def _device(mesh: DeviceMesh) -> torch.device:
    """This rank's device of the mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _frame_spec(mesh: DeviceMesh, shape: tuple[int, ...]) -> tuple[slice, slice, slice]:
    """This rank's block of a [B, N, C] frame batch on this mesh: rows over
    the first axis, channels over the second when the mesh has one. Raises
    ValueError where B (or C) does not divide."""
    blocks = [slice(None)] * 3
    for dim, axis in enumerate((0, 2)[:mesh.ndim]):
        n, i = mesh.size(dim), mesh.get_local_rank(dim)
        if shape[axis] % n:
            raise ValueError(f"axis {axis} of {tuple(shape)} does not divide over "
                             f"{mesh.mesh_dim_names[dim]!r} ({n} devices)")
        step = shape[axis] // n
        blocks[axis] = slice(i * step, (i + 1) * step)
    return tuple(blocks)


def pad_to_multiple(frames: np.ndarray, m: int) -> tuple[np.ndarray, int]:
    """Pad the batch axis to a multiple of m (shardable); returns (padded, pad)."""
    b = frames.shape[0]
    pad = (-b) % m
    if pad:
        frames = np.concatenate([frames, np.zeros((pad,) + frames.shape[1:], frames.dtype)])
    return frames, pad


def _blocks(mesh: DeviceMesh, *arrays: np.ndarray) -> list[torch.Tensor]:
    """This rank's block of each [B, ., C] host array, on its device."""
    dev = _device(mesh)
    return [to_device(a[_frame_spec(mesh, a.shape)], dev) for a in arrays]


def _gather(mesh: DeviceMesh, *blocks: torch.Tensor) -> list[np.ndarray]:
    """Every rank's [B_l, ., C_l] blocks joined into the whole [B, ., C]
    arrays, on every rank: over 'channel' (the last axis), then over
    'data' (the first)."""
    out = []
    for t in blocks:
        for dim, axis in reversed(tuple(enumerate((0, -1)[:mesh.ndim]))):
            parts = [torch.empty_like(t) for _ in range(mesh.size(dim))]
            dist.all_gather(parts, t.contiguous(), group=mesh.get_group(dim))
            t = torch.cat(parts, dim=axis)
        out.append(t)
    return to_host(*out)


def sharded_p1_encode(mesh: DeviceMesh, frames: np.ndarray, srate: int,
                      loss_level: float, factor: float):
    """Data-parallel profile-1 encode core over the mesh.

    frames [B, N, C] with B % n_devices == 0. Returns host arrays
    (freqs_q, thres_q) identical to the single-device core."""
    (f,) = _blocks(mesh, frames)
    return tuple(_gather(mesh, *batch.p1_encode_core(f, srate, loss_level, factor)))


def sharded_p0_encode(mesh: DeviceMesh, frames: np.ndarray) -> np.ndarray:
    (f,) = _blocks(mesh, frames)
    return _gather(mesh, batch.p0_encode_core(f))[0]


def sharded_p0_decode(mesh: DeviceMesh, coeffs: np.ndarray) -> np.ndarray:
    (c,) = _blocks(mesh, coeffs)
    return _gather(mesh, batch.p0_decode_core(c))[0]


def sharded_p1_decode(mesh: DeviceMesh, freqs: np.ndarray, thres: np.ndarray,
                      srate: int, factor: float) -> np.ndarray:
    f, t = _blocks(mesh, freqs, thres)
    return _gather(mesh, batch.p1_decode_core(f, t, srate, factor))[0]


def sharded_p2_encode(mesh: DeviceMesh, frames: np.ndarray, srate: int,
                      loss_level: float, factor: float):
    """Data-parallel profile-2 encode core (P1 chain + TNS) over the mesh.

    frames [B, N, C] with B % n_devices == 0. Returns host arrays
    (freqs_q, thres_q, lpc_q) identical to the single-device
    `batch.p2_encode_core`: the TNS analysis is frame- and channel-local."""
    (f,) = _blocks(mesh, frames)
    return tuple(_gather(mesh, *batch.p2_encode_core(f, srate, loss_level, factor)))


def sharded_p2_decode(mesh: DeviceMesh, freqs: np.ndarray, thres: np.ndarray,
                      lpc: np.ndarray, srate: int, factor: float) -> np.ndarray:
    """Inverse of `sharded_p2_encode`."""
    f, t, lp = _blocks(mesh, freqs, thres, lpc)
    return _gather(mesh, batch.p2_decode_core(f, t, lp, srate, factor))[0]


@functools.lru_cache(maxsize=32)
def halo_window(olap: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The JAX sharded overlap-add's [olap] fade-in window: computed in
    float64 by numpy, then cast to `dtype` (at float32 it may differ by an
    ulp from `kernels.overlap_add.crossfade_window`, which computes in
    float32)."""
    w = 0.5 * (1.0 - np.cos(np.pi * np.arange(1, olap + 1) / (olap + 1)))
    return torch.from_numpy(w).to(dtype).to(device)


def local_overlap_add(block: torch.Tensor, halo: torch.Tensor | None, olap: int,
                      cut: int) -> torch.Tensor:
    """One rank's overlap-add: block [B_l, C, N] frames (the IDCT's layout)
    on the device, halo None or [C, olap], the raw tail of the frame before
    the block -> [B_l, cut, C]. One `overlap_add` launch."""
    return overlap_add(block, halo_window(olap, block.dtype, block.device), cut, False, halo)[0]


def _ring_halo(mesh: DeviceMesh, tail: torch.Tensor) -> torch.Tensor:
    """`tail` sent one step right along 'data' (a ring); returns the tail
    the rank on the left sent. A ring of one is `tail` itself (gloo cannot
    send to its own rank)."""
    n = mesh.size(0)
    if n == 1:
        return tail
    group, i = mesh.get_group(0), mesh.get_local_rank(0)
    halo = torch.empty_like(tail)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, tail, dist.get_global_rank(group, (i + 1) % n), group),
        dist.P2POp(dist.irecv, halo, dist.get_global_rank(group, (i - 1) % n), group)])
    for r in reqs:
        r.wait()
    return halo


def overlap_add_sharded(mesh: DeviceMesh, frames: np.ndarray, olap: int,
                        cut: int) -> np.ndarray:
    """Decoder overlap-add of frames [B, N, C] sharded on B, with a halo
    exchange: each rank's last frame's raw tail goes to the next rank along
    'data', where it blends that rank's first frame as a frame's own
    predecessor would; data-rank 0 uses none (the stream's first frame has
    no predecessor). Returns [B, cut, C] on every rank."""
    (f,) = _blocks(mesh, frames)
    block = f.transpose(1, 2).contiguous()                           # [B_l, C, N]
    halo = _ring_halo(mesh, block[-1, :, cut:cut + olap].contiguous())
    out = local_overlap_add(block, halo if mesh.get_local_rank(0) else None, olap, cut)
    return _gather(mesh, out)[0]


def training_step_equivalent(mesh: DeviceMesh, pcm_frames: np.ndarray, srate: int,
                             loss_level: float, factor: float) -> np.ndarray:
    """One full sharded 'step': encode core -> decode core (float64
    symbols) -> overlap-add, as the JAX package's multi-chip path."""
    fq, tq = sharded_p1_encode(mesh, pcm_frames, srate, loss_level, factor)
    pcm = sharded_p1_decode(mesh, fq.astype(np.float64), tq.astype(np.float64), srate, factor)
    n = pcm_frames.shape[1]
    cut = n * 15 // 16
    return overlap_add_sharded(mesh, pcm, n - cut, cut)
