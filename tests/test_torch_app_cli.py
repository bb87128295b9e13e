"""Both command lines on the same files: `frad_python_tpu.app.main` (JAX,
the oracle) and `frad_python_tpu_torch.app.main` with `--device cpu`.

* Host-only actions (`repair`, every `meta` action) and the encodes whose
  tensor work is exact on the CPU (profile 4; profiles 0 and 1 at float64
  on both sides): files byte-identical, headers included.
* float32 (the port's default; the JAX CLI at
  FRAD_TPU_COMPUTE_DTYPE=float32): the port's decode of the JAX file and
  of its own within 2e-6 of the JAX decode of the same file (a few
  float32 ulps of the IDCT sum, |pcm| < 2), SNR within 0.1 dB.
* Output rotation on a change of channel count: the same file names, the
  same PCM within 1e-9 (float64 on both sides).
"""

import json

import numpy as np
import pytest

from frad_python_tpu.app.main import main as jmain
from frad_python_tpu.ops import policy as jpolicy
from frad_python_tpu_torch.app.main import main as tmain
from frad_python_tpu_torch.container import head as thead

CPU = ["--device", "cpu"]
SRATE = 44100
PNG = b"\x89PNG\r\n\x1a\n" + bytes(range(200))


def set_dtype(monkeypatch, dtype: str) -> None:
    monkeypatch.setenv("FRAD_TPU_COMPUTE_DTYPE", dtype)
    monkeypatch.setenv("FRAD_TORCH_COMPUTE_DTYPE", dtype)
    jpolicy.compute_dtype.cache_clear()


@pytest.fixture(autouse=True)
def clear_jax_dtype_cache():
    yield
    jpolicy.compute_dtype.cache_clear()


def tone(channels: int = 2, seconds: float = 0.25) -> np.ndarray:
    t = np.arange(int(SRATE * seconds)) / SRATE
    rng = np.random.default_rng(channels)
    sig = np.stack([0.4 * np.sin(2 * np.pi * (330 + 110 * c) * t) for c in range(channels)], 1)
    return sig + 0.01 * rng.standard_normal(sig.shape)


@pytest.fixture
def files(tmp_path):
    sig = tone()
    pcm = tmp_path / "tone.pcm"
    pcm.write_bytes((sig * 32768).astype(">i2").tobytes())
    (tmp_path / "cover.png").write_bytes(PNG)
    return tmp_path, pcm, sig


def both(argv_tail: list[str], out_j, out_t, device: bool = True) -> None:
    """One action on both command lines, writing to `out_j` and `out_t`."""
    jmain(["frad-tpu"] + argv_tail + ["-o", str(out_j), "-y"])
    tmain(["frad-torch"] + argv_tail + ["-o", str(out_t), "-y"] + (CPU if device else []))


def snr(ref: np.ndarray, out: np.ndarray) -> float:
    err = out[: len(ref)] - ref
    return float(10 * np.log10(np.sum(ref ** 2) / np.sum(err ** 2)))


@pytest.mark.parametrize("mode", [[], ["--turbo"], ["--no-turbo"]])
@pytest.mark.parametrize("profile,bits,extra", [
    (4, 16, []), (4, 64, ["--le"]), (0, 24, []), (0, 16, ["--ecc", "64", "16"]),
    (1, 16, []), (1, 24, ["--ecc", "--lv", "3", "--olap", "4", "--fr", "1000"])])
def test_encode_files_byte_identical_at_float64(monkeypatch, files, profile, bits, extra, mode):
    tmp, pcm, _ = files
    set_dtype(monkeypatch, "float64")
    argv = ["encode", str(pcm), "--srate", str(SRATE), "--ch", "2", "--pcm", "s16be",
            "--profile", str(profile), "--bits", str(bits), "--tag", "TITLE", "tön",
            "--img", str(tmp / "cover.png")] + extra + mode
    both(argv, tmp / "j.frad", tmp / "t.frad")
    got = (tmp / "t.frad").read_bytes()
    assert got == (tmp / "j.frad").read_bytes()
    header = thead.builder([("TITLE", "tön".encode())], PNG)
    assert got.startswith(header) and len(got) > len(header) + 1000
    # and the decodes of that file agree
    both(["decode", str(tmp / "j.frad"), "--pcm", "f64be"] + mode
         + (["--ecc"] if "--ecc" in extra else []), tmp / "j", tmp / "t")
    a = np.frombuffer((tmp / "j.pcm").read_bytes(), ">f8")
    b = np.frombuffer((tmp / "t.pcm").read_bytes(), ">f8")
    assert a.shape == b.shape and len(a) >= 2 * int(SRATE * 0.25)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-9 if profile == 1 else 1e-12)


@pytest.mark.parametrize("mode", [[], ["--no-turbo"], ["--exact"]])
def test_float32_decodes_within_tolerance(monkeypatch, files, mode):
    tmp, pcm, sig = files
    set_dtype(monkeypatch, "float32")
    argv = ["encode", str(pcm), "--srate", str(SRATE), "--ch", "2", "--pcm", "s16be",
            "--profile", "1", "--bits", "16"]
    both(argv, tmp / "j.frad", tmp / "t.frad")
    jmain(["frad-tpu", "decode", str(tmp / "j.frad"), "--pcm", "f64be", "-o",
           str(tmp / "jj"), "-y"] + mode)
    want = np.frombuffer((tmp / "jj.pcm").read_bytes(), ">f8").reshape(-1, 2)
    for name in ("j", "t"):
        tmain(["frad-torch", "decode", str(tmp / f"{name}.frad"), "--pcm", "f64be", "-o",
               str(tmp / f"t{name}"), "-y"] + mode + CPU)
    own_file = np.frombuffer((tmp / "tt.pcm").read_bytes(), ">f8").reshape(-1, 2)
    jax_file = np.frombuffer((tmp / "tj.pcm").read_bytes(), ">f8").reshape(-1, 2)
    assert jax_file.shape == want.shape == own_file.shape
    np.testing.assert_allclose(jax_file, want, rtol=0, atol=2e-6)
    ref = (sig * 32768).astype(">i2").astype(np.float64) / 32768
    assert abs(snr(ref, jax_file) - snr(ref, want)) < 0.1
    assert abs(snr(ref, own_file) - snr(ref, want)) < 0.1
    assert snr(ref, own_file) > 10


def test_repair_byte_identical(monkeypatch, files):
    tmp, pcm, _ = files
    set_dtype(monkeypatch, "float64")
    for profile, name in ((1, "a"), (4, "b")):
        src = tmp / f"{name}.frad"
        jmain(["frad-tpu", "encode", str(pcm), "--srate", str(SRATE), "--ch", "2", "--pcm",
               "s16be", "--profile", str(profile), "-o", str(src), "-y", "--tag", "K", "v"])
        for ratio in (["--ecc", "96", "24"], ["--ecc", "20", "8"], ["--ecc", "0", "5"],
                      ["--ecc", "200", "100"]):
            both(["repair", str(src)] + ratio, tmp / "rj.frad", tmp / "rt.frad", device=False)
            assert (tmp / "rt.frad").read_bytes() == (tmp / "rj.frad").read_bytes()
        # damage the armored copy: both repair it to the same bytes
        data = bytearray((tmp / "rj.frad").read_bytes())
        for off in range(300, len(data), 997):
            data[off] ^= 0x5A
        (tmp / "bad.frad").write_bytes(bytes(data))
        both(["repair", str(tmp / "bad.frad"), "--ecc", "96", "24"], tmp / "fj.frad",
             tmp / "ft.frad", device=False)
        assert (tmp / "ft.frad").read_bytes() == (tmp / "fj.frad").read_bytes()
    # default output name, beside the working directory
    monkeypatch.chdir(tmp)
    jmain(["frad-tpu", "repair", str(tmp / "a.frad"), "-y"])
    want = (tmp / "a.repaired.frad").read_bytes()
    (tmp / "a.repaired.frad").unlink()
    tmain(["frad-torch", "repair", str(tmp / "a.frad"), "-y"])
    assert (tmp / "a.repaired.frad").read_bytes() == want


def test_meta_actions_byte_identical(monkeypatch, files):
    tmp, pcm, _ = files
    monkeypatch.chdir(tmp)
    set_dtype(monkeypatch, "float64")
    jmain(["frad-tpu", "encode", str(pcm), "--srate", str(SRATE), "--ch", "2", "--pcm",
           "s16be", "-o", str(tmp / "j.frad"), "-y", "--tag", "TITLE", "first"])
    (tmp / "t.frad").write_bytes((tmp / "j.frad").read_bytes())
    (tmp / "tags.json").write_text(json.dumps(
        [{"key": "BIN", "type": "base64", "value": "AAH//g=="},
         {"key": "NAME", "type": "string", "value": "名前"}]), encoding="utf-8")
    (tmp / "tags.txt").write_text("ALBUM=x\nmore\nYEAR=2024\n", encoding="utf-8")
    steps = [
        ["add", "--meta", "ARTIST", "me", "--img", str(tmp / "cover.png")],
        ["add", "--jsonmeta", str(tmp / "tags.json"), "--vm", str(tmp / "tags.txt")],
        ["parse"],
        ["remove", "--meta", "TITLE", "--meta", "YEAR"],
        ["parse"],
        ["rm-img"],
        ["parse"],
        ["overwrite", "--tag", "ONLY", "one", "--img", str(tmp / "cover.png")],
        ["parse"],
        ["overwrite"],
    ]
    for step in steps:
        exported = {}
        for run, name in ((jmain, "j"), (tmain, "t")):
            run(["frad", "meta", step[0], str(tmp / f"{name}.frad")] + step[1:])
            if step[0] == "parse":
                exported[name] = ((tmp / f"{name}.json").read_bytes(),
                                  (tmp / f"{name}.png").read_bytes()
                                  if (tmp / f"{name}.png").exists() else None)
                for leftover in (tmp / f"{name}.json", tmp / f"{name}.png"):
                    leftover.unlink(missing_ok=True)
        assert (tmp / "t.frad").read_bytes() == (tmp / "j.frad").read_bytes(), step
        if exported:
            assert exported["t"] == exported["j"], step
    # a headerless stream is a valid file with an empty header; other bytes are not
    stream = (tmp / "j.frad").read_bytes()[64:]
    for name, run in (("hj.frad", jmain), ("ht.frad", tmain)):
        (tmp / name).write_bytes(stream)
        run(["frad", "meta", "add", str(tmp / name), "--tag", "A", "b"])
    assert (tmp / "ht.frad").read_bytes() == (tmp / "hj.frad").read_bytes()
    (tmp / "junk.frad").write_bytes(b"not a frad file at all")
    for run in (jmain, tmain):
        with pytest.raises(SystemExit) as e:
            run(["frad", "meta", "add", str(tmp / "junk.frad"), "--tag", "A", "b"])
        assert e.value.code == 1
        with pytest.raises(SystemExit):
            run(["frad", "meta", "frobnicate", str(tmp / "j.frad")])


@pytest.mark.parametrize("mode", [[], ["--no-turbo"]])
def test_output_rotation_on_a_channel_change(monkeypatch, files, mode):
    """Two streams of 2 and 1 channels in one file: `x.pcm` then `x.1.pcm`
    on both command lines, with the same PCM."""
    tmp, pcm, _ = files
    set_dtype(monkeypatch, "float64")
    mono = tmp / "mono.pcm"
    mono.write_bytes((tone(1, 0.2) * 32768).astype(">i2").tobytes())
    jmain(["frad-tpu", "encode", str(pcm), "--srate", str(SRATE), "--ch", "2", "--pcm",
           "s16be", "--profile", "1", "-o", str(tmp / "s2.frad"), "-y"])
    jmain(["frad-tpu", "encode", str(mono), "--srate", str(SRATE), "--ch", "1", "--pcm",
           "s16be", "--profile", "1", "-o", str(tmp / "s1.frad"), "-y"])
    joined = tmp / "joined.frad"
    joined.write_bytes((tmp / "s2.frad").read_bytes() + (tmp / "s1.frad").read_bytes()[64:])
    both(["decode", str(joined), "--pcm", "f64be"] + mode, tmp / "xj", tmp / "xt.pcm")
    for suffix, ch in ((".pcm", 2), (".1.pcm", 1)):
        a = np.frombuffer((tmp / f"xj{suffix}").read_bytes(), ">f8")
        b = np.frombuffer((tmp / f"xt{suffix}").read_bytes(), ">f8")
        assert a.shape == b.shape and len(a) >= ch * int(SRATE * 0.2)
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-9)
    assert not (tmp / "xt.2.pcm").exists() and not (tmp / "xj.2.pcm").exists()
