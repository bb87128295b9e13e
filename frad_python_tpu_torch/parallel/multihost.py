"""Multi-process orchestration over `torch.distributed`.

The counterpart of the JAX package's `parallel/multihost.py`. A job splits
a stream into contiguous sample spans, one a process (the overlap halo
included in the span, so the encode needs no exchange), encodes each span,
and assembles the serial bitstream on process 0 in frame order: frame
lengths depend on the data, so the concatenation is host work.

On each process (one a card):

    from frad_python_tpu_torch.parallel import multihost
    multihost.init_distributed("tcp://host0:29500", num_processes, process_id)
    mesh = multihost.global_mesh()          # one device a process
    span = multihost.host_span(total_samples, frame_size, overlap_ratio)
    part = batch_encode(pcm[span.start:span.stop], ..., final=last)
    multihost.gather_bitstream(part, order_key=span.first_frame)  # stream on 0

The device collectives run on the default group (NCCL on CUDA, gloo with
`device="cpu"`). The streams are host bytes: they travel over a gloo group
beside it, point-to-point to process 0 in chunks, so the whole stream
exists only there (`_gather_allgather_chunked` is the chunk-bounded
all-gather form).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..models.profiles import compact
from ..ops.policy import resolve_device
from .sharded import BACKENDS, make_mesh


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device: str | torch.device | None = None) -> None:
    """Join the process group (a no-op for one process).

    `coordinator_address` is "host:port" (TCP) or a URL `init_process_group`
    takes ("file://...", "tcp://..."); None reads the environment
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK, as `torchrun` sets
    them). On CUDA this process takes the card of its rank modulo the cards
    it sees, and the backend is NCCL; with `device="cpu"` it is gloo."""
    if num_processes is not None and num_processes <= 1:
        return
    dev = resolve_device(device)
    backend = BACKENDS[dev.type]
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("this PyTorch has no NCCL: a CUDA process group needs it")
    if coordinator_address is None:
        url = "env://"
    elif "://" in coordinator_address:
        url = coordinator_address
    else:
        url = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url,
                            world_size=-1 if num_processes is None else num_processes,
                            rank=-1 if process_id is None else process_id)
    if dev.type == "cuda":                 # before the first collective creates NCCL's
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())


def global_mesh(axis: str = "data", device: str | torch.device | None = None) -> DeviceMesh:
    """1-D mesh over every process's device."""
    return make_mesh(None, axis, device)


def _process() -> tuple[int, int]:
    """(this process's index, processes): (0, 1) without a process group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclass(frozen=True)
class HostSpan:
    start: int          # first sample this process encodes
    stop: int           # one-past-last sample
    first_frame: int    # global index of this process's first frame


def host_span(total_samples: int, frame_size: int, overlap_ratio: int,
              is_compact: bool = True, process_id: int | None = None,
              num_processes: int | None = None) -> HostSpan:
    """Contiguous frame range for this process, halo included.

    Frames are distributed evenly; each process's sample span starts at its
    first frame's start offset (which already re-reads the overlap halo
    from the previous frame, the same duplication the streaming encoder
    performs), so processes need no sample exchange to encode."""
    pid, nproc = _process()
    pid = pid if process_id is None else process_id
    nproc = nproc if num_processes is None else num_processes

    n = compact.get_samples_min_ge(frame_size) if is_compact else frame_size
    olap = (n - n * (overlap_ratio - 1) // overlap_ratio) \
        if (is_compact and overlap_ratio > 1) else 0
    hop = n - olap
    n_frames = max(1, -(-(total_samples - olap) // hop)) if total_samples > 0 else 0

    lo_frame = n_frames * pid // nproc
    hi_frame = n_frames * (pid + 1) // nproc
    start = max(lo_frame * hop, 0)
    stop = min(hi_frame * hop + olap if hi_frame > lo_frame else start, total_samples)
    if pid == nproc - 1:
        stop = total_samples
    return HostSpan(start=start, stop=stop, first_frame=lo_frame)


#: the bytes of one message of a stream gather
_CHUNK = 2 << 20
#: the gloo group the byte gathers run on, made at the first gather
_HOST_GROUP: list = []


def _host_group():
    """A gloo group of every process, for host bytes: the default group
    where it is gloo, else one made (collectively) beside it at the first
    call."""
    if "nccl" not in dist.get_backend():
        return dist.group.WORLD
    if not _HOST_GROUP:
        _HOST_GROUP.append(dist.new_group(backend="gloo"))
    return _HOST_GROUP[0]


def _lengths_and_keys(n: int, key: int, group) -> np.ndarray:
    """Every process's (length, key), [processes, 2] int64, on every process."""
    mine = torch.tensor([n, key], dtype=torch.int64)
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, mine, group=group)
    return torch.stack(parts).numpy()


def _joined(parts: list[bytes], meta: np.ndarray) -> bytes:
    """The processes' streams joined in the order of their keys."""
    order = np.argsort(meta[:, 1], kind="stable")
    return b"".join(parts[int(i)] for i in order)


def gather_bitstream(local_stream: bytes, order_key: int | None = None,
                     chunk_bytes: int = _CHUNK) -> bytes | None:
    """Order-preserving concatenation of the processes' byte streams on
    process 0.

    Only (length, key) pairs go to every process; the bytes go
    point-to-point to process 0 in messages of `chunk_bytes`, so traffic and
    memory are O(total bytes) and the whole stream exists only on process 0.
    Collective: every process calls it.

    Returns the full stream on process 0 and None elsewhere. One process:
    identity. Streams are ordered by `order_key` (pass HostSpan.first_frame);
    with the default None the process index is the key."""
    pid, nproc = _process()
    if nproc == 1:
        return local_stream
    key = pid if order_key is None else int(order_key)
    group = _host_group()
    meta = _lengths_and_keys(len(local_stream), key, group)
    if pid != 0:
        data = torch.from_numpy(np.frombuffer(local_stream, dtype=np.uint8).copy())
        for off in range(0, len(data), chunk_bytes):
            dist.send(data[off:off + chunk_bytes], dst=0, group=group)
        return None
    parts = [local_stream]
    for p in range(1, nproc):
        buf = torch.empty(int(meta[p, 0]), dtype=torch.uint8)
        for off in range(0, len(buf), chunk_bytes):
            dist.recv(buf[off:off + chunk_bytes], src=p, group=group)
        parts.append(buf.numpy().tobytes())
    return _joined(parts, meta)


def _gather_allgather_chunked(local_stream: bytes, key: int,
                              chunk_bytes: int) -> bytes | None:
    """The byte gather as chunk-bounded all-gather rounds: memory a round is
    O(processes x chunk) instead of O(processes x longest stream); the
    assembly is on process 0 only (None elsewhere). One process: identity."""
    pid, nproc = _process()
    if nproc == 1:
        return local_stream
    group = _host_group()
    arr = np.frombuffer(local_stream, dtype=np.uint8)
    meta = _lengths_and_keys(len(arr), key, group)
    longest = int(meta[:, 0].max())
    parts: list[list[bytes]] = [[] for _ in range(nproc)]
    for off in range(0, longest, chunk_bytes):
        w = min(chunk_bytes, longest - off)
        buf = torch.zeros(w, dtype=torch.uint8)
        take = min(max(len(arr) - off, 0), w)
        if take:
            buf[:take] = torch.from_numpy(arr[off:off + take].copy())
        got = [torch.empty_like(buf) for _ in range(nproc)]
        dist.all_gather(got, buf, group=group)
        if pid == 0:
            for p in range(nproc):
                rem = int(meta[p, 0]) - off
                if rem > 0:
                    parts[p].append(got[p][:min(rem, w)].numpy().tobytes())
    if pid != 0:
        return None
    return _joined([b"".join(p) for p in parts], meta)
