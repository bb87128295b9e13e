"""The port's host byte layer against the JAX package: CRCs, ASFH headers,
Exp-Golomb-Rice streams, Profile 1 payloads and the frame plan must be
byte-identical. Also: importing the port never imports jax."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from frad_python_tpu import common as jcommon
from frad_python_tpu.container import asfh as jasfh
from frad_python_tpu.models import batch as jbatch
from frad_python_tpu.models import profile1 as jprofile1
from frad_python_tpu.models.profiles import compact as jcompact
from frad_python_tpu.ops import golomb as jgolomb
from frad_python_tpu.parallel import pipeline as jpipeline
from frad_python_tpu_torch import common as tcommon
from frad_python_tpu_torch.container import asfh as tasfh
from frad_python_tpu_torch.models import batch as tbatch
from frad_python_tpu_torch.models import profile1 as tprofile1
from frad_python_tpu_torch.models.profiles import compact as tcompact
from frad_python_tpu_torch.ops import golomb as tgolomb
from frad_python_tpu_torch.parallel import pipeline as tpipeline

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "frad_python_tpu_torch"


@pytest.mark.parametrize("n", [0, 1, 7, 255, 4096])
def test_crc_identical(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    assert tcommon.crc16_ansi(data) == jcommon.crc16_ansi(data)
    assert tcommon.crc32(data) == jcommon.crc32(data)
    assert tcommon.FRM_SIGN == jcommon.FRM_SIGN


def test_compact_tables_identical():
    assert tcompact.SRATES == jcompact.SRATES
    assert tcompact.SAMPLES == jcompact.SAMPLES
    for v in (1, 128, 129, 2000, 2048, 28672):
        assert tcompact.get_samples_min_ge(v) == jcompact.get_samples_min_ge(v)
    for sr in (8000, 11000, 44100, 48000, 96000):
        assert tcompact.get_valid_srate(sr) == jcompact.get_valid_srate(sr)
        assert tcompact.get_srate_index(sr) == jcompact.get_srate_index(sr)


def _header(mod, profile, ch, srate, fsize, olap, little, bdi, ecc):
    a = mod.ASFH()
    a.profile, a.channels, a.srate, a.fsize = profile, ch, srate, fsize
    a.overlap_ratio, a.endian, a.bit_depth_index = olap, little, bdi
    a.ecc = ecc
    a.ecc_dsize, a.ecc_codesize = (96, 24) if ecc else (0, 0)
    return a


HEADERS = [
    (1, 2, 44100, 2048, 16, False, 2, False),
    (1, 1, 48000, 1792, 0, True, 3, False),
    (1, 8, 8000, 128, 256, False, 0, True),
    (2, 2, 96000, 28672, 2, False, 6, True),
    (0, 2, 44100, 2048, 0, False, 2, False),
    (4, 3, 192000, 4096, 0, True, 5, True),
]


@pytest.mark.parametrize("cfg", HEADERS)
def test_asfh_write_read_force_flush_identical(cfg):
    payload = np.random.default_rng(5).integers(0, 256, 300, dtype=np.uint8).tobytes()
    j = _header(jasfh, *cfg)
    t = _header(tasfh, *cfg)
    frame = t.write(payload)
    assert frame == j.write(payload)
    assert t.force_flush() == j.force_flush()
    got, want = tasfh.ASFH(), jasfh.ASFH()
    assert got.read(frame)[0] == want.read(frame)[0] == tasfh.COMPLETE
    for name in jasfh.ASFH.__slots__:
        assert getattr(got, name) == getattr(want, name), name
    if cfg[0] in (1, 2):
        ff = tasfh.ASFH()
        assert ff.read(t.force_flush())[0] == tasfh.FORCE_FLUSH


def _symbols(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "empty":
        return np.zeros(0, dtype=np.int64)
    if kind == "zeros":
        return np.zeros(500, dtype=np.int64)
    if kind == "small":
        return rng.integers(-3, 4, 4096)
    if kind == "laplace":
        return np.rint(rng.laplace(0, 20, 4096)).astype(np.int64)
    return rng.integers(-(1 << 20), 1 << 20, 777)           # wide


@pytest.mark.parametrize("kind", ["empty", "zeros", "small", "laplace", "wide"])
def test_golomb_identical(kind):
    data = _symbols(kind, 11)
    enc = tgolomb.encode(data)
    assert enc == jgolomb.encode(data)
    np.testing.assert_array_equal(tgolomb.decode(enc), jgolomb.decode(enc))
    np.testing.assert_array_equal(tgolomb.decode(enc), data)


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_streams_identical(seed):
    rng = np.random.default_rng(seed)
    freqs = np.rint(rng.laplace(0, 4, 4096)).astype(np.int64)
    thres = rng.integers(0, 40, 54)
    payload = tprofile1.pack_streams(freqs, thres)
    assert payload == jprofile1.pack_streams(freqs, thres)
    f, t = tprofile1.unpack_streams(payload)
    np.testing.assert_array_equal(f, freqs)
    np.testing.assert_array_equal(t, thres)
    assert tprofile1.unpack_streams(b"\x00garbage") is None
    assert tprofile1._scale_factor(16) == jprofile1._scale_factor(16)
    assert tprofile1.DEPTHS == jprofile1.DEPTHS


@pytest.mark.parametrize("total", [0, 100, 2048, 2049, 88200, 44100 * 3 + 17])
def test_plan_frames_identical(total):
    for olap in (0, 2, 16):
        assert (tpipeline.plan_frames(total, 2048, olap, True)
                == jpipeline.plan_frames(total, 2048, olap, True))
        ts, to = tbatch.overlap_frame_starts(total, 2048, olap)
        js, jo = jbatch.overlap_frame_starts(total, 2048, olap)
        assert to == jo
        np.testing.assert_array_equal(ts, js)


def test_import_leaves_jax_out():
    code = (
        "import sys, frad_python_tpu_torch\n"
        "import frad_python_tpu_torch.kernels.build, frad_python_tpu_torch.models.batch\n"
        "import frad_python_tpu_torch.container.head, frad_python_tpu_torch.__main__\n"
        "from frad_python_tpu_torch.app import decode, encode, main, metadata, repair\n"
        "from frad_python_tpu_torch.utils import cli, fmt, hostmem, telemetry, tracing\n"
        "from frad_python_tpu_torch.kernels import dequant, egr_pack\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'frad_python_tpu' or m.startswith('frad_python_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_sources_import_neither_jax_nor_jax_package():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    names = {str(p.relative_to(PORT)) for p in files[:-1]}
    assert {"container/head.py", "app/main.py", "app/encode.py", "app/decode.py",
            "app/repair.py", "app/metadata.py", "__main__.py", "utils/cli.py", "utils/fmt.py",
            "utils/telemetry.py", "utils/hostmem.py", "utils/tracing.py",
            "kernels/egr_pack.py", "kernels/dequant.py"} <= names
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "frad_python_tpu", "bench"), (path, name)
