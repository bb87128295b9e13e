"""The port's multi-process orchestration
(`frad_python_tpu_torch.parallel.multihost`) against the JAX package's
(`frad_python_tpu.parallel.multihost`) on the CPU: the span arithmetic,
spanwise encodes joined against one global encode (the port's and the
JAX package's streams), the byte gathers at one process, and a spawned
2-rank gloo session (file store, one thread a rank) for the gathers
across processes. The worker imports only torch, numpy and the port."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from frad_python_tpu.parallel import batch_encode as jbatch_encode
from frad_python_tpu.parallel import multihost as jmultihost
from frad_python_tpu_torch.parallel import batch_encode, multihost

REPO = pathlib.Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 240
#: the uneven gather's streams: 64 bytes against 5 MiB + 13 (three 2 MiB
#: messages), the big one first by its key
BIG = (5 << 20) + 13


def _big() -> bytes:
    return np.random.default_rng(5).integers(0, 256, BIG, dtype=np.uint8).tobytes()


def _chunked_data(rank: int) -> bytes:
    return np.random.default_rng(3 + rank).integers(0, 256, 10_000 + 777 * rank,
                                                     dtype=np.uint8).tobytes()


def _span_pcm() -> np.ndarray:
    return np.random.default_rng(99).standard_normal((20480, 2)) * 0.4


WORKER = """
import sys
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(1)
rank, d = int(sys.argv[1]), Path(sys.argv[2])
sys.path.insert(0, sys.argv[3])
import torch.distributed as dist
from frad_python_tpu_torch.parallel import batch_encode, multihost

multihost.init_distributed(f"file://{d / 'store'}", 2, rank, device="cpu")
pcm = np.load(d / "pcm.npy")
span = multihost.host_span(len(pcm), 2048, 16, True)
part = batch_encode(pcm[span.start:span.stop], 1, 48000, 16, 2048, overlap_ratio=16,
                    final=rank == 1, compute_dtype="float64", device="cpu")
got = {"spans": multihost.gather_bitstream(part, order_key=span.first_frame)}
small, big = bytes(range(64)), (d / "big.bin").read_bytes()
mine, key = (small, 7) if rank == 0 else (big, 3)
got["uneven"] = multihost.gather_bitstream(mine, order_key=key)
got["uneven_again"] = multihost.gather_bitstream(mine, order_key=key)
data = (d / f"chunked{rank}.bin").read_bytes()
got["chunked"] = multihost._gather_allgather_chunked(data, key=1 - rank, chunk_bytes=999)
got["empty"] = multihost.gather_bitstream(b"" if rank else b"xyz")
for k, v in got.items():
    if rank == 0:
        (d / f"{k}.bin").write_bytes(v)
    elif v is not None:
        raise AssertionError(f"rank {rank} got {k}")
(d / f"span{rank}.txt").write_text(f"{span.start} {span.stop} {span.first_frame}")
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The 2-rank session's gathered bytes on rank 0, {name: bytes}, and
    each rank's span."""
    d = tmp_path_factory.mktemp("multihost")
    np.save(d / "pcm.npy", _span_pcm())
    (d / "big.bin").write_bytes(_big())
    for r in range(2):
        (d / f"chunked{r}.bin").write_bytes(_chunked_data(r))
    script = d / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(d), str(REPO)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    errors = []
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=RANK_TIMEOUT_S)
            if p.returncode != 0:
                errors.append(f"rank {r} exited {p.returncode}:\n{err[-3000:]}")
    finally:
        for p in procs:
            p.kill()
            p.wait()
    if errors:
        pytest.fail("\n".join(errors))
    got = {k: (d / f"{k}.bin").read_bytes()
           for k in ("spans", "uneven", "uneven_again", "chunked", "empty")}
    got["spans_of"] = [tuple(int(v) for v in (d / f"span{r}.txt").read_text().split())
                       for r in range(2)]
    return got


@pytest.mark.parametrize("total,fsize,ratio,compact,nproc", [
    (100000, 2048, 16, True, 4), (5000, 512, 0, False, 1), (13000, 512, 0, False, 3),
    (40960, 2048, 16, True, 4), (20480, 2048, 16, True, 2), (1000, 2048, 16, True, 4),
    (0, 2048, 16, True, 2), (99991, 1000, 2, True, 5)])
def test_host_span_matches_jax(total, fsize, ratio, compact, nproc):
    for pid in range(nproc):
        got = multihost.host_span(total, fsize, ratio, compact, pid, nproc)
        want = jmultihost.host_span(total, fsize, ratio, compact, pid, nproc)
        assert (got.start, got.stop, got.first_frame) == (want.start, want.stop,
                                                          want.first_frame)


def test_host_spans_cover_stream_with_halo():
    total, fsize, ratio = 100000, 2048, 16
    olap = 2048 - 2048 * (ratio - 1) // ratio
    spans = [multihost.host_span(total, fsize, ratio, True, pid, 4) for pid in range(4)]
    assert spans[0].start == 0 and spans[-1].stop == total
    for a, b in zip(spans, spans[1:]):
        assert b.start == a.stop - olap            # consecutive spans share the halo


def test_host_span_single_process():
    """Without a process group the process is 0 of 1."""
    s = multihost.host_span(5000, 512, 0, False)
    assert (s.start, s.stop, s.first_frame) == (0, 5000, 0)


@pytest.mark.parametrize("case", ["p1", "p0"])
def test_spanwise_encode_matches_global(case):
    """Span encodes (final only on the last) joined == one global encode,
    the port's and the JAX package's, byte for byte (float64, as the JAX
    package's default)."""
    if case == "p1":
        total, fsize, ratio, nproc, prof, bits, compact = 40960, 2048, 16, 4, 1, 16, True
        pcm = np.random.default_rng(55).standard_normal((total, 2)) * 0.4
        kw = dict(overlap_ratio=ratio)
        srate = 48000
    else:
        total, fsize, ratio, nproc, prof, bits, compact = 13000, 512, 0, 3, 0, 24, False
        pcm = np.random.default_rng(56).standard_normal((total, 1)) * 0.4
        kw = {}
        srate = 44100
    ref = batch_encode(pcm, prof, srate, bits, fsize, compute_dtype="float64", device="cpu",
                       **kw)
    parts = []
    for pid in range(nproc):
        s = multihost.host_span(total, fsize, ratio, compact, pid, nproc)
        parts.append(batch_encode(pcm[s.start:s.stop], prof, srate, bits, fsize,
                                  compute_dtype="float64", final=pid == nproc - 1,
                                  device="cpu", **kw))
    assert b"".join(parts) == ref
    assert ref == jbatch_encode(pcm, prof, srate, bits, fsize, **kw)


def test_gathers_single_process():
    """One process (no process group): both gathers are the identity."""
    data = bytes(np.random.default_rng(3).integers(0, 256, 10_000, dtype=np.uint8))
    assert multihost.gather_bitstream(b"abc") == b"abc"
    assert multihost.gather_bitstream(data, order_key=5, chunk_bytes=999) == data
    assert multihost._gather_allgather_chunked(data, key=0, chunk_bytes=999) == data
    assert multihost._gather_allgather_chunked(b"", 0, 999) == b""
    assert jmultihost._gather_allgather_chunked(data, key=0, chunk_bytes=999) == data


def test_two_ranks_spanwise_encode_gathers_to_global(two_ranks):
    pcm = _span_pcm()
    ref = batch_encode(pcm, 1, 48000, 16, 2048, overlap_ratio=16, compute_dtype="float64",
                       device="cpu")
    assert two_ranks["spans"] == ref
    assert ref == jbatch_encode(pcm, 1, 48000, 16, 2048, overlap_ratio=16)
    spans = [jmultihost.host_span(len(pcm), 2048, 16, True, pid, 2) for pid in range(2)]
    assert two_ranks["spans_of"] == [(s.start, s.stop, s.first_frame) for s in spans]


def test_two_ranks_uneven_gather_in_key_order(two_ranks):
    """64 B against 5 MiB + 13 B (three messages), reversed keys: the big
    stream lands first, intact, and a second gather gives the same."""
    assert two_ranks["uneven"] == _big() + bytes(range(64))
    assert two_ranks["uneven_again"] == two_ranks["uneven"]
    assert two_ranks["empty"] == b"xyz"


def test_two_ranks_chunked_allgather(two_ranks):
    """Ragged streams in 999-byte all-gather rounds, joined by key (rank 1
    first)."""
    assert two_ranks["chunked"] == _chunked_data(1) + _chunked_data(0)


def test_init_distributed_single_process_is_a_no_op():
    import torch.distributed as dist

    multihost.init_distributed("localhost:1", 1, 0)
    multihost.init_distributed(None, 0, None, device="cpu")
    assert not dist.is_initialized()
