"""The port's app and CLI layer (`python -m frad_python_tpu_torch`): the
cases of tests/test_app.py through the port's `main` on the CPU
(`--device cpu`), its parser, formatters and telemetry against the JAX
package's, the `--device` contract, pipes, and the host utilities."""

import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from frad_python_tpu.utils import cli as jcli
from frad_python_tpu.utils import fmt as jfmt
from frad_python_tpu.utils import hostmem as jhostmem
from frad_python_tpu.utils import telemetry as jtelemetry
from frad_python_tpu.utils.tracing import StageTimer as JStageTimer
import frad_python_tpu_torch as ft
from frad_python_tpu_torch.app import encode as tencode
from frad_python_tpu_torch.app.main import main
from frad_python_tpu_torch.utils import cli, hostmem, tracing
from frad_python_tpu_torch.utils import fmt as tfmt
from frad_python_tpu_torch.utils import telemetry as ttelemetry
from frad_python_tpu_torch.utils.fmt import format_si, format_speed, format_time, get_file_stem
from frad_python_tpu_torch.utils.telemetry import StreamStats, status_line

REPO = Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]


class TestCliParse:
    def test_defaults(self):
        action, meta, inp, p = cli.parse(["x", "encode", "in.pcm"])
        assert (action, inp) == ("encode", "in.pcm")
        assert p.pcm == "f64be" and p.profile == 4 and p.frame_size == 2048
        assert p.overlap_ratio == 16 and p.ecc_ratio == (96, 24)
        assert p.device is None

    def test_flags(self):
        _, _, _, p = cli.parse(["x", "enc", "a", "--srate", "48000", "-ch", "2",
                                "--bits", "16", "-p", "1", "--ecc", "64", "32",
                                "--le", "-y", "--log", "2", "--turbo"])
        assert p.srate == 48000 and p.channels == 2 and p.bits == 16
        assert p.profile == 1 and p.enable_ecc and p.ecc_ratio == (64, 32)
        assert p.little_endian and p.overwrite and p.loglevel == 2 and p.turbo

    def test_ecc_without_ratio(self):
        _, _, _, p = cli.parse(["x", "enc", "a", "--ecc", "--bits", "16"])
        assert p.enable_ecc and p.ecc_ratio == (96, 24) and p.bits == 16

    def test_meta_action(self):
        action, meta, inp, p = cli.parse(
            ["x", "meta", "add", "f.frad", "--meta", "K", "V"])
        assert (action, meta, inp) == ("meta", "add", "f.frad")
        assert p.meta == [("K", b"V")]

    def test_keys_to_speed(self):
        _, _, _, p = cli.parse(["x", "play", "f", "--keys", "12"])
        assert p.speed == pytest.approx(2.0)

    def test_device(self):
        for value in ("cpu", "cuda", "cuda:1"):
            _, _, _, p = cli.parse(["x", "dec", "f", "--device", value, "-y"])
            assert p.device == value and p.overwrite


def _argv_table(tmp_path) -> list[list[str]]:
    """argv lists that walk every action alias and every flag alias of
    `_FLAG_HANDLERS` and of the three flags `parse` handles itself."""
    jm = tmp_path / "m.json"
    jm.write_text(json.dumps([
        {"key": "TITLE", "type": "string", "value": "名前"},
        {"key": "BIN", "type": "base64", "value": "AAEC/w=="},
        {"key": None, "value": None}, {"key": "EMPTY"}, {"value": "v"}]), encoding="utf-8")
    vm = tmp_path / "m.tags"
    vm.write_text("bare first\nARTIST=me\ncontinued line\nALBUM=a=b\n", encoding="utf-8")
    table = [["x"], ["x", "HELP"], ["x", "meta", "ADD"], ["x", "enc"],
             ["x", "encode", "in.pcm", "stray", "--unknown-flag", "-o", "out"]]
    for action in (jcli.ENCODE_OPT + jcli.DECODE_OPT + jcli.REPAIR_OPT + jcli.PLAY_OPT
                   + jcli.HELP_OPT + jcli.PROFILES_OPT + jcli.JSONMETA_OPT + jcli.VORBISMETA_OPT):
        table.append(["x", action, "file.x", "-y"])
    for action in jcli.METADATA_OPT:
        for sub in ("add", "remove", "rm-img", "overwrite", "parse"):
            table.append(["x", action, sub, "f.frad", "--meta", "K", "V"][: 7 if sub != "remove"
                                                                          else 6])
    values = {"output": "o.frad", "pcm": "s24le", "bits": "24", "srate": "96000", "chnl": "6",
              "frame-size": "4096", "overlap-ratio": "8", "profile": "2", "losslevel": "7",
              "jsonmeta": str(jm), "vorbismeta": str(vm), "img": "cover.png", "speed": "1.5",
              "keys": "-5"}
    for aliases in jcli._FLAG_HANDLERS:
        for alias in aliases:
            for dashes in ("-", "--"):
                arg = values.get(aliases[0])
                table.append(["x", "encode", "in.pcm", dashes + alias.upper()]
                             + ([arg] if arg is not None else []))
    for alias in ("ecc", "enable-ecc", "e"):
        table += [["x", "enc", "a", "--" + alias], ["x", "enc", "a", "-" + alias, "48", "12"],
                  ["x", "enc", "a", "--" + alias, "--le"]]
    for alias in ("tag", "meta", "m"):
        table += [["x", "enc", "a", "--" + alias, "K", "värde"],
                  ["x", "meta", "remove", "a", "-" + alias, "K"]]
    for alias in ("log", "v"):
        table += [["x", "dec", "a", "--" + alias], ["x", "dec", "a", "-" + alias, "2"],
                  ["x", "dec", "a", "--" + alias, "-y"]]
    return table


def test_parse_equals_the_jax_parser_on_every_alias(tmp_path):
    table = _argv_table(tmp_path)
    assert len(table) > 120
    assert cli._FLAG_HANDLERS.keys() - jcli._FLAG_HANDLERS.keys() == {("device",)}
    assert jcli._FLAG_HANDLERS.keys() <= cli._FLAG_HANDLERS.keys()
    for name in ("ENCODE_OPT", "DECODE_OPT", "REPAIR_OPT", "PLAY_OPT", "METADATA_OPT",
                 "JSONMETA_OPT", "VORBISMETA_OPT", "PROFILES_OPT", "HELP_OPT", "META_ADD",
                 "META_REMOVE", "META_RMIMG", "META_OVERWRITE", "META_PARSE"):
        assert getattr(cli, name) == getattr(jcli, name)
    for argv in table:
        try:
            want = jcli.parse(list(argv))
        except SystemExit as e:
            with pytest.raises(SystemExit) as got:
                cli.parse(list(argv))
            assert str(got.value) == str(e)
            continue
        got = cli.parse(list(argv))
        assert got[:3] == want[:3], argv
        mine = dict(vars(got[3]))
        assert mine.pop("device") is None
        assert mine == vars(want[3]), argv


class TestFormatters:
    def test_time(self):
        assert format_time(0) == "0"
        assert format_time(1.5) == "1.500 s"
        assert format_time(65) == "1:05.000"
        assert format_time(3600 + 61) == "1:01:01.000"
        assert format_time(31557600 * 2 + 1) .startswith("J2.")

    def test_si(self):
        assert format_si(0) == "0 "
        assert format_si(1234) == "1.234 k"
        assert format_si(5e9) == "5.000 G"

    def test_speed(self):
        assert format_speed(123.4) == "123"
        assert format_speed(12.34) == "12.3"
        assert format_speed(0.5) == "0.500"

    def test_stem(self):
        assert get_file_stem("/a/b/c.frad") == "c"
        assert get_file_stem(".hidden") == ".hidden"
        assert get_file_stem("-") == "pipe"
        assert get_file_stem("a.b.c") == "a.b"
        assert get_file_stem("plain") == "plain"

    def test_equal_to_the_jax_formatters(self):
        values = [0, 1e-10, 3e-9, 4.5e-6, 0.0021, 0.5, 1, 1.5, 59.9995, 60, 65, 3599.9,
                  3661, 86400, 90061.5, 31557600, 31557600 * 2 + 1, 1e10, -3, -75.25,
                  999.9994, 1000, 1234, 5e9, 7.7e26, -1234.5, 9.996, 10, 99.95, 100, 123.4]
        for v in values:
            assert tfmt.format_time(v) == jfmt.format_time(v)
            assert tfmt.format_si(v) == jfmt.format_si(v)
            assert tfmt.format_speed(abs(v)) == jfmt.format_speed(abs(v))
        for path in ("/a/b/c.frad", ".hidden", "-", "/dev/stdin", "/dev/fd/1", "a.b.c",
                     "plain", "dir.d/file", "x.", ""):
            assert tfmt.get_file_stem(path) == jfmt.get_file_stem(path)
        assert (tfmt.PIPEIN, tfmt.PIPEOUT) == (jfmt.PIPEIN, jfmt.PIPEOUT)

    def test_check_overwrite(self, tmp_path, monkeypatch, capsys):
        path = tmp_path / "there"
        tfmt.check_overwrite(str(path), False)          # absent: nothing to ask
        path.write_bytes(b"x")
        tfmt.check_overwrite(str(path), True)
        for mod in (tfmt, jfmt):
            monkeypatch.setattr(sys, "stdin", io.StringIO(""))
            with pytest.raises(SystemExit) as e:
                mod.check_overwrite(str(path), False)
            assert e.value.code == 0
        out = capsys.readouterr().err.splitlines()
        assert out[0] == out[1] and "--force" in out[0]


class TestStreamStats:
    def test_rates_and_speed(self):
        now = [100.0]
        s = StreamStats(clock=lambda: now[0])
        s.log(4410 * 2, samples=4410, srate=44100)   # 0.1 s of audio
        s.log(9600 * 2, samples=9600, srate=48000)   # 0.2 s of audio
        now[0] += 0.1
        assert s.total_bytes == (4410 + 9600) * 2
        assert s.coded_seconds == pytest.approx(0.3)
        assert s.speed == pytest.approx(3.0)
        assert s.bitrate == pytest.approx((4410 + 9600) * 16 / 0.3)

    def test_pause_excludes_prompt_time(self):
        now = [0.0]
        s = StreamStats(clock=lambda: now[0])
        s.log(100, samples=44100, srate=44100)
        now[0] = 1.0
        s.pause()
        now[0] = 11.0    # 10 s stuck at an interactive prompt
        s.resume()
        now[0] = 12.0
        assert s.elapsed == pytest.approx(2.0)
        assert s.speed == pytest.approx(0.5)

    def test_status_line_shapes(self):
        s = StreamStats(clock=lambda: 0.0)
        assert status_line(s).startswith("size=0 B")
        assert "B/s" in status_line(s, bytes_only=True)
        s.log(2000, samples=44100, srate=44100)
        line = status_line(s)
        assert "time=1.000 s" in line and "bitrate=16.000 kbit/s" in line

    def test_equal_to_the_jax_telemetry(self):
        now = [5.0]
        mine = ttelemetry.StreamStats(clock=lambda: now[0])
        theirs = jtelemetry.StreamStats(clock=lambda: now[0])
        rng = np.random.default_rng(3)
        for step in range(40):
            nbytes, samples = int(rng.integers(0, 1 << 20)), int(rng.integers(0, 1 << 16))
            srate = int(rng.choice([0, 8000, 44100, 48000, 96000]))
            now[0] += float(rng.random())
            for s in (mine, theirs):
                s.log(nbytes, samples, srate)
                if step % 7 == 3:
                    s.pause()
                if step % 7 == 5:
                    s.resume()
            for attr in ("total_bytes", "coded_seconds", "bitrate", "elapsed", "speed"):
                assert getattr(mine, attr) == getattr(theirs, attr)
            assert ttelemetry.status_line(mine) == jtelemetry.status_line(theirs)
            assert (ttelemetry.status_line(mine, bytes_only=True)
                    == jtelemetry.status_line(theirs, bytes_only=True))


@pytest.fixture
def tone_pcm(tmp_path):
    srate = 44100
    t = np.arange(srate // 4) / srate
    sig = np.stack([0.5 * np.sin(2 * np.pi * 440 * t),
                    0.5 * np.sin(2 * np.pi * 660 * t)], 1)
    path = tmp_path / "tone.pcm"
    path.write_bytes((sig * 32768).astype(">i2").tobytes())
    return path, sig


class TestEndToEnd:
    def test_encode_decode_cycle(self, tone_pcm, tmp_path):
        pcm_path, sig = tone_pcm
        frad = tmp_path / "out.frad"
        main(["frad-torch", "encode", str(pcm_path), "--srate", "44100",
              "--ch", "2", "--pcm", "s16be", "--bits", "24", "--profile", "0",
              "--ecc", "-o", str(frad), "-y",
              "--tag", "TITLE", "tone"] + CPU)
        assert frad.exists() and frad.stat().st_size > 0

        out = tmp_path / "back"
        main(["frad-torch", "decode", str(frad), "--pcm", "s16be", "--ecc",
              "-o", str(out), "-y"] + CPU)
        got = np.frombuffer((tmp_path / "back.pcm").read_bytes(), ">i2")
        want = (sig * 32768).astype(">i2").ravel()
        assert got.shape == want.shape
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1

    def test_turbo_matches_streaming(self, tone_pcm, tmp_path):
        pcm_path, _ = tone_pcm
        a = tmp_path / "a.frad"
        b = tmp_path / "b.frad"
        c = tmp_path / "c.frad"
        for out, extra in ((a, []), (b, ["--turbo"]), (c, ["--no-turbo"])):
            main(["frad-torch", "encode", str(pcm_path), "--srate", "44100",
                  "--ch", "2", "--pcm", "s16be", "--profile", "1",
                  "-o", str(out), "-y"] + extra + CPU)
        assert a.read_bytes() == b.read_bytes() == c.read_bytes()

    def test_exact_decode_matches_per_frame_engine(self, tone_pcm, tmp_path):
        """--exact must take the strictly per-frame Decoder path:
        output bit-identical to a hand-driven Decoder(exact=True) fed
        in uneven chunks."""
        pcm_path, _ = tone_pcm
        frad = tmp_path / "x.frad"
        main(["frad-torch", "encode", str(pcm_path), "--srate", "44100",
              "--ch", "2", "--pcm", "s16be", "--profile", "1",
              "-o", str(frad), "-y"] + CPU)
        out = tmp_path / "xb"
        main(["frad-torch", "decode", str(frad), "--pcm", "s16be",
              "--exact", "-o", str(out), "-y"] + CPU)
        got = np.frombuffer((tmp_path / "xb.pcm").read_bytes(), ">i2")

        d = ft.Decoder(exact=True, device="cpu")
        stream = frad.read_bytes()
        parts = [d.process(stream[i:i + 997]).pcm
                 for i in range(0, len(stream), 997)]
        parts.append(d.flush().pcm)
        ref = np.concatenate([p for p in parts if p.size])
        want = np.clip(ref * 32768.0, -(2 ** 15), 2 ** 15 - 1).astype(">i2")
        np.testing.assert_array_equal(got, want.ravel())

    def test_meta_roundtrip(self, tone_pcm, tmp_path, monkeypatch):
        pcm_path, _ = tone_pcm
        frad = tmp_path / "m.frad"
        main(["frad-torch", "encode", str(pcm_path), "--srate", "44100",
              "--ch", "2", "--pcm", "s16be", "-o", str(frad), "-y",
              "--tag", "TITLE", "first"] + CPU)
        main(["frad-torch", "meta", "add", str(frad), "--meta", "ARTIST", "me"])
        monkeypatch.chdir(tmp_path)
        main(["frad-torch", "meta", "parse", str(frad)])
        meta = json.loads((tmp_path / "m.json").read_text())
        assert [m["key"] for m in meta] == ["TITLE", "ARTIST"]

        main(["frad-torch", "meta", "remove", str(frad), "--meta", "TITLE"])
        main(["frad-torch", "meta", "parse", str(frad)])
        meta = json.loads((tmp_path / "m.json").read_text())
        assert [m["key"] for m in meta] == ["ARTIST"]

    def test_repair_roundtrip(self, tone_pcm, tmp_path):
        pcm_path, sig = tone_pcm
        frad = tmp_path / "r.frad"
        main(["frad-torch", "encode", str(pcm_path), "--srate", "44100",
              "--ch", "2", "--pcm", "s16be", "--profile", "4", "--bits", "64",
              "-o", str(frad), "-y"] + CPU)
        armored = tmp_path / "r2.frad"
        main(["frad-torch", "repair", str(frad), "--ecc", "96", "24",
              "-o", str(armored), "-y"])
        assert armored.stat().st_size > frad.stat().st_size

        # corrupt then repair
        data = bytearray(armored.read_bytes())
        data[200] ^= 0x55
        armored.write_bytes(bytes(data))
        main(["frad-torch", "repair", str(armored), "--ecc", "96", "24",
              "-o", str(tmp_path / "r3.frad"), "-y"])
        out = tmp_path / "dec"
        main(["frad-torch", "decode", str(tmp_path / "r3.frad"), "--pcm", "s16be",
              "-o", str(out), "-y"] + CPU)
        got = np.frombuffer((tmp_path / "dec.pcm").read_bytes(), ">i2")
        want = (sig * 32768).astype(">i2").ravel()
        np.testing.assert_array_equal(got, want)

    def test_repair_overwrite_replaces_the_input(self, tone_pcm, tmp_path):
        pcm_path, _ = tone_pcm
        frad = tmp_path / "ow.frad"
        main(["frad-torch", "encode", str(pcm_path), "--srate", "44100", "--ch", "2",
              "--pcm", "s16be", "--profile", "1", "-o", str(frad), "-y"] + CPU)
        plain = frad.read_bytes()
        main(["frad-torch", "repair", str(frad), "--ecc", "--overwrite", "-y"])
        assert not (tmp_path / "ow.repaired.frad").exists()
        assert frad.read_bytes() == plain[:plain.index(ft.common.FRM_SIGN)] + ft.batch_repair(
            plain[plain.index(ft.common.FRM_SIGN):], (96, 24))

    def test_help(self, capsys):
        main(["frad-torch", "help"])
        out = capsys.readouterr().out
        assert "encode" in out and "decode" in out and "--device" in out
        assert "PyTorch" in out and "CUDA" in out and "TPU" not in out
        main(["frad-torch", "help", "profiles"])
        out = capsys.readouterr().out
        assert "Profile 1" in out and "28672" in out
        for topic in ("encode", "decode", "repair", "play", "meta", "jsonmeta", "vm"):
            main(["frad-torch", "help", topic])
            assert "TPU" not in capsys.readouterr().out
        main(["frad-torch"])
        assert "Abstract syntax: frad-torch" in capsys.readouterr().err

    def test_missing_input_errors(self, tmp_path):
        with pytest.raises(SystemExit):
            main(["frad-torch", "encode", str(tmp_path / "nope.pcm"),
                  "--srate", "44100", "--ch", "2"] + CPU)
        for action in ("decode", "repair"):
            with pytest.raises(SystemExit):
                main(["frad-torch", action, str(tmp_path / "nope.frad")] + CPU)
        with pytest.raises(SystemExit):
            main(["frad-torch", "meta", "add", str(tmp_path / "nope.frad")])
        with pytest.raises(SystemExit):
            main(["frad-torch", "meta"])

    def test_encode_refuses_what_the_gauntlet_refuses(self, tone_pcm, tmp_path, capsys):
        pcm_path, _ = tone_pcm
        for extra in (["--srate", "0", "--ch", "2"], ["--srate", "44100", "--ch", "0"],
                      ["--srate", "44100", "--ch", "2", "--profile", "2"],
                      ["--srate", "200000", "--ch", "2", "--profile", "1"]):
            with pytest.raises(SystemExit) as e:
                main(["frad-torch", "encode", str(pcm_path), "-o", str(tmp_path / "no.frad"),
                      "-y"] + extra + CPU)
            assert e.value.code == 1
        assert not (tmp_path / "no.frad").exists()
        with pytest.raises(SystemExit):
            main(["frad-torch", "encode", str(pcm_path), "--srate", "44100", "--ch", "2",
                  "-o", str(pcm_path)] + CPU)
        assert "cannot be the same" in capsys.readouterr().err


def test_output_names_and_loss_level(tmp_path, monkeypatch):
    """The extension policy of `set_files` and the CLI loss level."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "in.pcm").write_bytes(b"\x00" * 64)
    for profile, name, want in ((4, "", "in.fra"), (1, "", "in.dsn"), (0, "longername", "longername.frad"),
                                (2, "longername", "longername.dsin"), (1, "keep.frad", "keep.frad")):
        r, w = tencode.set_files("in.pcm", name, profile, True)
        r.close()
        w.close()
        assert (tmp_path / want).exists()
    assert tencode.loss_level_from_cli(0) == pytest.approx(1 / 19 + 0.5)
    assert tencode.loss_level_from_cli(4) == pytest.approx(1.25 ** 4 / 19 + 0.5)


class _Pipe:
    """Stand-in for sys.stdin / sys.stdout with a bytes `.buffer`."""

    def __init__(self, data: bytes = b""):
        self.buffer = io.BytesIO(data)

    def isatty(self) -> bool:
        return False


@pytest.mark.parametrize("profile", [1, 4])
def test_pipes_in_and_out(tone_pcm, tmp_path, monkeypatch, profile):
    """`-` for input and output on encode, decode and repair: the bytes
    through the pipes equal the bytes through files (the pipe route runs
    the streaming engines in 32 KiB reads)."""
    pcm_path, _ = tone_pcm
    flags = ["--srate", "44100", "--ch", "2", "--pcm", "s16be", "--profile", str(profile)]
    frad = tmp_path / "f.frad"
    main(["frad-torch", "encode", str(pcm_path), "-o", str(frad), "-y", "--no-turbo"]
         + flags + CPU)
    main(["frad-torch", "decode", str(frad), "--pcm", "s16be", "-o", str(tmp_path / "f"),
          "-y", "--no-turbo"] + CPU)
    main(["frad-torch", "repair", str(frad), "--ecc", "48", "12", "-o",
          str(tmp_path / "fr.frad"), "-y"])

    def piped(argv, data):
        stdin, stdout = _Pipe(data), _Pipe()
        monkeypatch.setattr(sys, "stdin", stdin)
        monkeypatch.setattr(sys, "stdout", stdout)
        main(argv)
        monkeypatch.undo()
        return stdout.buffer.getvalue()

    enc = piped(["frad-torch", "encode", "-", "-o", "-"] + flags + CPU, pcm_path.read_bytes())
    assert enc == frad.read_bytes()
    dec = piped(["frad-torch", "decode", "/dev/stdin", "--pcm", "s16be", "-o", "/dev/stdout"]
                + CPU, enc)
    assert dec == (tmp_path / "f.pcm").read_bytes()
    rep = piped(["frad-torch", "repair", "-", "--ecc", "48", "12", "-o", "-"], enc)
    assert rep == (tmp_path / "fr.frad").read_bytes()


def test_without_device_and_without_a_gpu_nothing_decodes(tone_pcm, tmp_path):
    """No `--device`: CUDA. Without a GPU the run ends with the
    `resolve_device` error and a non-zero exit code; it never falls back
    to the CPU, whatever the environment says."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    pcm_path, _ = tone_pcm
    frad = tmp_path / "c.frad"
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        main(["frad-torch", "encode", str(pcm_path), "--srate", "44100", "--ch", "2",
              "--pcm", "s16be", "--profile", "1", "-o", str(frad), "-y"])
    assert not frad.exists() or frad.stat().st_size == 0
    main(["frad-torch", "encode", str(pcm_path), "--srate", "44100", "--ch", "2",
          "--pcm", "s16be", "--profile", "1", "-o", str(frad), "-y"] + CPU)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", FRAD_TORCH_DEVICE="cpu")
    res = subprocess.run(
        [sys.executable, "-m", "frad_python_tpu_torch", "decode", str(frad), "-o",
         str(tmp_path / "c"), "-y"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode != 0
    assert "no CUDA device is available" in res.stderr
    assert not (tmp_path / "c.pcm").exists() or (tmp_path / "c.pcm").stat().st_size == 0


def test_module_entry_point_never_imports_jax(tmp_path):
    res = subprocess.run([sys.executable, "-m", "frad_python_tpu_torch", "help"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "Usage: __main__.py <action>" in res.stdout
    code = (
        "import sys\n"
        "from frad_python_tpu_torch.app.main import main\n"
        "from frad_python_tpu_torch.app import decode, encode, metadata, repair\n"
        "from frad_python_tpu_torch.utils import hostmem, tracing\n"
        "main(['frad-torch', 'help', 'encode'])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'frad_python_tpu')]\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0 and "BAD []" in res.stdout, res.stdout + res.stderr


def test_play_needs_sounddevice(tone_pcm, tmp_path, capsys):
    """`play` parses like `decode`; without the sounddevice package it ends
    with a message and exit code 1 before any audio work."""
    _, _, inp, p = cli.parse(["x", "p", "f.frad", "--spd", "1.25"] + CPU)
    assert inp == "f.frad" and p.speed == 1.25 and p.device == "cpu"
    try:
        import sounddevice  # noqa: F401
    except (ImportError, OSError):
        pcm_path, _ = tone_pcm
        frad = tmp_path / "p.frad"
        main(["frad-torch", "encode", str(pcm_path), "--srate", "44100", "--ch", "2",
              "--pcm", "s16be", "-o", str(frad), "-y"] + CPU)
        with pytest.raises(SystemExit) as e:
            main(["frad-torch", "play", str(frad)] + CPU)
        assert e.value.code == 1 and "sounddevice" in capsys.readouterr().err


def test_hostmem_and_warm_heap_variable(monkeypatch):
    assert (hostmem.M_TRIM_THRESHOLD, hostmem.M_TOP_PAD, hostmem.M_MMAP_THRESHOLD,
            hostmem.M_MMAP_MAX) == (jhostmem.M_TRIM_THRESHOLD, jhostmem.M_TOP_PAD,
                                    jhostmem.M_MMAP_THRESHOLD, jhostmem.M_MMAP_MAX)
    hostmem.prefault(1 << 16)
    called = []
    monkeypatch.setattr(hostmem, "tune", lambda: called.append(True))
    monkeypatch.delenv("FRAD_TORCH_WARM_HEAP", raising=False)
    monkeypatch.setenv("FRAD_TPU_WARM_HEAP", "1")       # the JAX package's: not read
    main(["frad-torch"])
    assert not called
    monkeypatch.setenv("FRAD_TORCH_WARM_HEAP", "1")
    main(["frad-torch"])
    assert called == [True]


def test_tracing(tmp_path):
    import torch

    mine, theirs = tracing.StageTimer(), JStageTimer()
    for t in (mine, theirs):
        with t.stage("enc:h2d"):
            pass
        with t.stage("core"):
            time.sleep(0.001)
        t.add_bytes("h2d", 1 << 20)
    assert mine.counts == theirs.counts and mine.bytes == theirs.bytes
    assert mine.transfer_wait("h2d") == mine.totals["enc:h2d"]
    assert [ln.split(":")[0] for ln in mine.summary().splitlines()] == \
        [ln.split(":")[0] for ln in theirs.summary().splitlines()]
    with tracing.trace(str(tmp_path / "tr")) as prof:
        with tracing.annotate("region-of-the-test"):
            torch.ones(8).sum()
    assert prof is not None
    text = (tmp_path / "tr" / "trace.json").read_text()
    assert "region-of-the-test" in text and "traceEvents" in text
