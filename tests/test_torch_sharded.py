"""The port's sharded cores (`frad_python_tpu_torch.parallel.sharded`)
against the JAX package's (`frad_python_tpu.parallel.sharded`) on the
CPU.

The port runs one rank a device: each session below spawns its ranks as
processes (gloo, a file store in the session's directory, one thread a
rank) that run every case once on the same inputs, drawn here from seeded
numpy, and save every rank's outputs. The cases then compare each output
with the JAX function on the conftest's 8-device mesh cut to the same
shape: a 4-device 1-D mesh and a 2 x 2 (data, channel) mesh. The worker
imports only torch, numpy and the port."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from frad_python_tpu.models import batch as jbatch
from frad_python_tpu.parallel import sharded as jsharded
from frad_python_tpu_torch import kernels
from frad_python_tpu_torch.kernels.overlap_add import crossfade_window
from frad_python_tpu_torch.models import batch as tbatch
from frad_python_tpu_torch.parallel import sharded

REPO = pathlib.Path(__file__).resolve().parent.parent
SRATE, LOSS, FACTOR = 48000, 0.5, 2.0 ** 15
#: overlap-add geometry of the [16, 512, 2] case (overlap ratio 16)
N_OA = 512
CUT = N_OA * 15 // 16
OLAP = N_OA - CUT
RANK_TIMEOUT_S = 240

WORKER = """
import sys
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(1)
rank, world, mode, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4])
sys.path.insert(0, sys.argv[5])
import torch.distributed as dist
from frad_python_tpu_torch.parallel import multihost, sharded

multihost.init_distributed(f"file://{d / 'store'}", world, rank, device="cpu")
sent = []
real_batch = dist.batch_isend_irecv
dist.batch_isend_irecv = lambda ops: sent.append(len(ops)) or real_batch(ops)
mesh = (sharded.make_mesh_2d(2, 2, device="cpu") if mode == "2d"
        else sharded.make_mesh(world, device="cpu"))
x = {k: np.load(d / f"in_{k}.npy") for k in ("p0", "p1", "p2", "oa64", "oa32", "step")}
out = {}
out["p0_enc"] = sharded.sharded_p0_encode(mesh, x["p0"])
out["p0_dec"] = sharded.sharded_p0_decode(mesh, out["p0_enc"])
for p in ("p1", "p2"):
    enc = getattr(sharded, f"sharded_{p}_encode")(mesh, x[p], 48000, 0.5, 2.0 ** 15)
    for name, a in zip(("fq", "tq", "lq"), enc):
        out[f"{p}_{name}"] = a
    dec = getattr(sharded, f"sharded_{p}_decode")
    out[f"{p}_pcm"] = dec(mesh, *(a.astype(np.float64) for a in enc), 48000, 2.0 ** 15)
out["oa64"] = sharded.overlap_add_sharded(mesh, x["oa64"], 32, 480)
out["oa32"] = sharded.overlap_add_sharded(mesh, x["oa32"], 32, 480)
out["step"] = sharded.training_step_equivalent(mesh, x["step"], 48000, 0.5, 2.0 ** 15)
refused = []
for bad in (x["oa64"][:world * 2 + 1], x["oa64"][:8, :, :1]):
    try:
        sharded.sharded_p0_encode(mesh, np.ascontiguousarray(bad))
    except ValueError:
        refused.append(bad.shape)
out["refused"] = np.array([list(s) for s in refused] or np.zeros((0, 3)), dtype=np.int64)
out["ring_ops"] = np.array(sent, dtype=np.int64)
for k, a in out.items():
    np.save(d / f"{k}.{rank}.npy", a)
dist.destroy_process_group()
"""


def _inputs() -> dict:
    rng = np.random.default_rng(2024)
    return {"p0": rng.standard_normal((8, 1024, 2)),
            "p1": rng.standard_normal((8, 1024, 2)) * 0.4,
            "p2": rng.standard_normal((8, 1024, 2)) * 0.4,
            "oa64": rng.standard_normal((16, N_OA, 2)),
            "oa32": rng.standard_normal((16, N_OA, 2)).astype(np.float32),
            "step": rng.standard_normal((8, N_OA, 2)) * 0.4}


def _run_session(d: pathlib.Path, world: int, mode: str) -> dict:
    """Spawn `world` ranks running WORKER in `mode`; returns {output name:
    [each rank's array]}. A rank that fails, or a group that does not form
    in time, fails the test."""
    d.mkdir(parents=True)
    for k, a in _inputs().items():
        np.save(d / f"in_{k}.npy", a)
    script = d / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(world), mode, str(d),
                               str(REPO)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(world)]
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
    names = {f.name.split(".")[0] for f in d.glob("*.0.npy")}
    return {k: [np.load(d / f"{k}.{r}.npy") for r in range(world)] for k in names}


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    base = tmp_path_factory.mktemp("sharded")
    return {"1d": _run_session(base / "1d", 4, "1d"), "2d": _run_session(base / "2d", 4, "2d"),
            "one": _run_session(base / "one", 1, "1d")}


@pytest.fixture(scope="module")
def jax_meshes():
    return {"1d": jsharded.make_mesh(4), "2d": jsharded.make_mesh_2d(2, 2)}


def _got(sessions, mode: str, name: str) -> np.ndarray:
    """The output `name` of a session; every rank must hold all of it."""
    arrs = sessions[mode][name]
    for r, a in enumerate(arrs[1:], 1):
        assert a.dtype == arrs[0].dtype and np.array_equal(a, arrs[0], equal_nan=True), \
            f"rank {r}'s {name} differs from rank 0's"
    return arrs[0]


MODES = ["1d", "2d"]


@pytest.mark.parametrize("mode", MODES)
def test_p0_sharded_matches_jax(sessions, jax_meshes, mode):
    x = _inputs()["p0"]
    want = jsharded.sharded_p0_encode(jax_meshes[mode], x)
    got = _got(sessions, mode, "p0_enc")
    assert got.shape == want.shape and got.dtype == np.float64
    np.testing.assert_allclose(got, want, atol=1e-14, rtol=1e-13)
    back = jsharded.sharded_p0_decode(jax_meshes[mode], want)
    np.testing.assert_allclose(_got(sessions, mode, "p0_dec"), back, atol=1e-14, rtol=1e-13)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("profile", [1, 2])
def test_lossy_sharded_symbols_and_pcm_match_jax(sessions, jax_meshes, mode, profile):
    x = _inputs()[f"p{profile}"]
    mesh = jax_meshes[mode]
    enc = getattr(jsharded, f"sharded_p{profile}_encode")(mesh, x, SRATE, LOSS, FACTOR)
    for name, want in zip(("fq", "tq", "lq"), enc):
        np.testing.assert_array_equal(_got(sessions, mode, f"p{profile}_{name}"), want)
    dec = getattr(jsharded, f"sharded_p{profile}_decode")
    want = dec(mesh, *(np.asarray(a, np.float64) for a in enc), SRATE, FACTOR)
    np.testing.assert_allclose(_got(sessions, mode, f"p{profile}_pcm"), want, atol=1e-12)


@pytest.mark.parametrize("mode", MODES)
def test_lossy_sharded_equals_single_device_port(sessions, mode):
    """The sharded encode gives the port's single-device core's symbols."""
    x = torch.from_numpy(_inputs()["p1"])
    fq, tq = tbatch.p1_encode_core(x, SRATE, LOSS, FACTOR)
    np.testing.assert_array_equal(_got(sessions, mode, "p1_fq"), fq.numpy())
    np.testing.assert_array_equal(_got(sessions, mode, "p1_tq"), tq.numpy())


@pytest.mark.parametrize("mode", MODES)
def test_overlap_add_sharded_matches_jax_f64(sessions, jax_meshes, mode):
    x = _inputs()["oa64"]
    want = jsharded.overlap_add_sharded(jax_meshes[mode], x, OLAP, CUT)
    got = _got(sessions, mode, "oa64")
    assert got.shape == (16, CUT, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)
    np.testing.assert_allclose(got, np.asarray(jbatch.overlap_add_core(x, OLAP, CUT)),
                               rtol=0, atol=1e-15)


@pytest.mark.parametrize("mode", MODES)
def test_overlap_add_sharded_f32_equals_plain_blend(sessions, jax_meshes, mode):
    """float32: the same bits as the single-process plain blend with the
    sharded window, and within 2e-6 of JAX."""
    x = _inputs()["oa32"]
    pcm = torch.from_numpy(x).transpose(1, 2).contiguous()
    w = sharded.halo_window(OLAP, torch.float32, torch.device("cpu"))
    want, _ = kernels.overlap_add_plain(pcm, w, CUT, False)
    got = _got(sessions, mode, "oa32")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want.numpy())
    jwant = jsharded.overlap_add_sharded(jax_meshes[mode], x, OLAP, CUT)
    np.testing.assert_allclose(got, jwant, rtol=0, atol=2e-6)


@pytest.mark.parametrize("mode", MODES)
def test_training_step_matches_jax(sessions, jax_meshes, mode):
    x = _inputs()["step"]
    want = jsharded.training_step_equivalent(jax_meshes[mode], x, SRATE, LOSS, FACTOR)
    got = _got(sessions, mode, "step")
    assert got.shape == want.shape == (8, CUT, 2)
    np.testing.assert_allclose(got, want, atol=1e-12)


@pytest.mark.parametrize("mode", MODES)
def test_batch_or_channels_that_do_not_divide_are_refused(sessions, mode):
    """B = 9 on 4 data ranks, and C = 1 on 2 channel ranks."""
    refused = [tuple(s) for s in _got(sessions, mode, "refused")]
    assert refused == ([(9, N_OA, 2)] if mode == "1d" else [(9, N_OA, 2), (8, N_OA, 1)])


@pytest.mark.parametrize("mode", MODES)
def test_the_ring_is_one_exchange_a_call(sessions, mode):
    """Each overlap-add sends one tail and receives one per rank: three
    calls (two overlap-adds, the training step), two operations each."""
    assert _got(sessions, mode, "ring_ops").tolist() == [2, 2, 2]


def test_ring_of_one_is_a_local_copy(sessions):
    """One rank: no send or receive (gloo cannot send to its own rank),
    and the result is the port's overlap_add_core."""
    assert _got(sessions, "one", "ring_ops").tolist() == []
    x = _inputs()["oa64"]
    want = tbatch.overlap_add_core(torch.from_numpy(x), OLAP, CUT)
    np.testing.assert_array_equal(_got(sessions, "one", "oa64"), want.numpy())
    # float32: the sharded window (float64 cast to float32) with the plain blend
    pcm = torch.from_numpy(_inputs()["oa32"]).transpose(1, 2).contiguous()
    w = sharded.halo_window(OLAP, torch.float32, torch.device("cpu"))
    np.testing.assert_array_equal(_got(sessions, "one", "oa32"),
                                  kernels.overlap_add_plain(pcm, w, CUT, False)[0].numpy())
    assert _got(sessions, "one", "refused").shape[0] == 0


def test_one_rank_session_matches_single_device(sessions):
    x = _inputs()
    want = jsharded.overlap_add_sharded(jsharded.make_mesh(1), x["oa64"], OLAP, CUT)
    np.testing.assert_allclose(_got(sessions, "one", "oa64"), want, rtol=0, atol=1e-15)
    fq, tq = tbatch.p1_encode_core(torch.from_numpy(x["step"]), SRATE, LOSS, FACTOR)
    pcm = tbatch.p1_decode_core(fq.to(torch.float64), tq.to(torch.float64), SRATE, FACTOR)
    want = tbatch.overlap_add_core(pcm, OLAP, CUT)
    np.testing.assert_array_equal(_got(sessions, "one", "step"), want.numpy())


def _np_halo_blend(frames, halo, w):
    """frad_python_tpu/parallel/sharded.py:189 on the first frame, in numpy:
    heads * w + prev_tails * reverse(w)."""
    olap = len(w)
    return frames[0, :olap, :] * w[:, None] + halo.T * w[::-1][:, None]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("b,c,olap,cut", [(3, 2, 32, 480), (1, 1, 16, 100), (4, 3, 7, 93)])
@pytest.mark.parametrize("i16", [False, True])
def test_overlap_add_plain_halo(dtype, b, c, olap, cut, i16):
    """With a halo, frame 0's head is blended with it as the sharded
    overlap-add blends it; the other frames and the fragment are as
    without one."""
    rng = np.random.default_rng(b * 100 + c * 10 + olap)
    n = cut + olap
    frames = (rng.standard_normal((b, n, c)) * 0.6).astype(dtype)
    halo = (rng.standard_normal((c, olap)) * 0.6).astype(dtype)
    w = (0.5 * (1.0 - np.cos(np.pi * np.arange(1, olap + 1) / (olap + 1)))).astype(dtype)
    pcm = torch.from_numpy(frames).transpose(1, 2).contiguous()
    wt, ht = torch.from_numpy(w), torch.from_numpy(halo)
    out, frag = kernels.overlap_add(pcm, wt, cut, i16, ht)
    out0, frag0 = kernels.overlap_add_plain(pcm, wt, cut, i16)
    want = _np_halo_blend(frames, halo, w)
    if i16:
        want = np.clip(np.rint(want * 32768.0), -32768, 32767).astype(np.int16)
    np.testing.assert_array_equal(out[0, :olap].numpy(), want)
    assert torch.equal(out[0, olap:], out0[0, olap:]) and torch.equal(out[1:], out0[1:])
    assert torch.equal(frag, frag0)


def test_overlap_add_halo_is_a_frame_before_the_batch():
    """A halo equal to the tail of the frame before gives the same bits as
    the longer batch's own blend (the by-hand four-shard join)."""
    rng = np.random.default_rng(11)
    frames = rng.standard_normal((12, N_OA, 2))
    pcm = torch.from_numpy(frames).transpose(1, 2).contiguous()
    w = sharded.halo_window(OLAP, torch.float64, torch.device("cpu"))
    whole = sharded.local_overlap_add(pcm, None, OLAP, CUT)
    parts = [sharded.local_overlap_add(pcm[:4], None, OLAP, CUT)]
    for k in (4, 8):
        parts.append(sharded.local_overlap_add(pcm[k:k + 4].contiguous(),
                                               pcm[k - 1, :, CUT:].contiguous(), OLAP, CUT))
    assert torch.equal(torch.cat(parts), whole)
    assert torch.equal(w, crossfade_window(OLAP, torch.device("cpu"), torch.float64))


@pytest.mark.parametrize("bad,err", [
    (torch.zeros(2, OLAP, dtype=torch.float32), TypeError),
    (torch.zeros(2, OLAP - 1, dtype=torch.float64), ValueError),
    (torch.zeros(3, OLAP, dtype=torch.float64), ValueError),
    (torch.zeros(OLAP, 2, dtype=torch.float64).T, ValueError),
    (torch.zeros(2, OLAP, dtype=torch.float64, device="meta"), ValueError),
])
def test_overlap_add_refuses_bad_halos(bad, err):
    pcm = torch.zeros(2, 2, N_OA, dtype=torch.float64)
    w = crossfade_window(OLAP, torch.device("cpu"), torch.float64)
    with pytest.raises(err):
        kernels.overlap_add(pcm, w, CUT, False, bad)


def test_frame_spec_and_pad_to_multiple():
    frames = np.arange(13 * 4 * 1, dtype=np.float64).reshape(13, 4, 1)
    padded, pad = sharded.pad_to_multiple(frames, 8)
    jpadded, jpad = jsharded.pad_to_multiple(frames, 8)
    assert pad == jpad == 3 and np.array_equal(padded, jpadded)
    assert np.array_equal(padded[:13], frames) and not padded[13:].any()

    class Mesh:                                  # what _frame_spec reads of a DeviceMesh
        ndim = 2
        mesh_dim_names = ("data", "channel")

        def size(self, dim):
            return (4, 2)[dim]

        def get_local_rank(self, dim):
            return (3, 1)[dim]

    assert sharded._frame_spec(Mesh(), (16, 64, 2)) == (slice(12, 16), slice(None),
                                                        slice(1, 2))
    with pytest.raises(ValueError, match="does not divide"):
        sharded._frame_spec(Mesh(), (16, 64, 3))
    with pytest.raises(ValueError, match="does not divide"):
        sharded._frame_spec(Mesh(), (10, 64, 2))


def test_mesh_needs_a_process_group_of_its_size():
    """No process group and a mesh of several devices: refused before
    anything starts; CUDA without a card raises (no CPU fallback)."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group of 4 ranks"):
        sharded.make_mesh(4, device="cpu")
    with pytest.raises(RuntimeError, match="process group of 4 ranks"):
        sharded.make_mesh_2d(2, 2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sharded.make_mesh(1)
    assert not dist.is_initialized()


def test_chip_smoke_tally_tells_halo_launches_apart():
    """chip_smoke.py's form of an overlap_add launch ends in "halo" where
    frame 0 is blended with one, and its tally sees the sharded module's
    launches: a halo-free check does not hold a halo launch."""
    import chip_smoke

    rng = np.random.default_rng(5)
    block = torch.from_numpy(rng.standard_normal((3, 2, N_OA)))
    halo = torch.from_numpy(rng.standard_normal((2, OLAP)))
    with chip_smoke.FormTally(only=("overlap_add",), device_type="cpu") as tally:
        sharded.local_overlap_add(block, halo, OLAP, CUT)
        sharded.local_overlap_add(block, None, OLAP, CUT)
    base = ("overlap_add", (3, 2, N_OA), "float64", OLAP, CUT, False)
    assert tally.seen == {base + ("halo",): 1, base: 1}
    frames = chip_smoke.track_frames(chip_smoke.make_audio(1.0, 44100, 2))
    assert frames.shape == (23, 2048, 2) and not frames[-1, -100:].any()
