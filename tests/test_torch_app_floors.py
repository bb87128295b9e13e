"""chip_smoke.py's SNR floors of its command-line phase are the JAX
package's float32 SNR minus 0.1 dB on what that phase encodes: the 30 s
track as the s16le file the CLI reads, at the CLI's default loss level
for Profile 1 (decoded to s16le, against the track) and as profile 0 at
24 bits (decoded to f64be, against the file's samples)."""

import numpy as np

import chip_smoke
from frad_python_tpu.ops.pcm import from_f64, to_f64
from frad_python_tpu.parallel import pipeline as jpipeline
from frad_python_tpu_torch.app.encode import loss_level_from_cli


def test_chip_smoke_cli_snr_floors():
    pcm = chip_smoke.make_audio(chip_smoke.SECONDS, chip_smoke.SRATE, chip_smoke.CHANNELS)
    s16 = np.dtype("<i2")
    content = to_f64(np.frombuffer(chip_smoke.to_s16le(pcm), s16).reshape(-1, chip_smoke.CHANNELS),
                     s16)
    stream = jpipeline.batch_encode(content, 1, chip_smoke.SRATE, chip_smoke.BITS,
                                    chip_smoke.FSIZE, loss_level=loss_level_from_cli(0),
                                    compute_dtype="float32")
    out, _ = jpipeline.batch_decode(stream, compute_dtype="float32")
    back = from_f64(out, s16).astype(s16).astype(np.float64) / 32768.0
    assert abs((chip_smoke.snr_db(pcm, back) - 0.1) - chip_smoke.CLI_P1_SNR_FLOOR_DB) < 1e-3

    stream0 = jpipeline.batch_encode(content, 0, chip_smoke.SRATE, chip_smoke.P0_BITS,
                                     chip_smoke.FSIZE, compute_dtype="float32")
    out0, _ = jpipeline.batch_decode(stream0, compute_dtype="float32")
    assert abs((chip_smoke.snr_db(content, out0) - 0.1) - chip_smoke.CLI_P0_SNR_FLOOR_DB) < 1e-3
