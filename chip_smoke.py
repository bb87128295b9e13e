"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `frad_python_tpu_torch/csrc/` and its
C++ host module from `frad_python_tpu_torch/native/`, holds each kernel
against its plain PyTorch version at the main path's shapes, then drives
the Profile 1 main path (44.1 kHz stereo, 16-bit, 2048-sample frames,
overlap ratio 16) end to end on the card through `batch_encode` /
`batch_decode`, decodes the card's stream again on the CPU for
comparison, and drives the same track with ECC armor at (96, 24) through
damage, `batch_repair` and an error-correcting `batch_decode`. Then the
streaming phase feeds the track as s16le bytes through the push engines:
`Encoder` in 32 KiB pushes and in one deep push, `Decoder` in 32 KiB
pushes and in `exact` mode, and the (96, 24) stream, damaged, through
`Repairer` and an error-correcting `Decoder`, with the kernels held
against their plain versions at the streaming shapes first. Last, the
lossless phase: `trunc_pack` and `trunc_unpack` held byte for byte against
their plain versions at its shapes and on the truncation edges
(`trunc_unpack` also bit for bit on random payload words with NaN, Inf,
signed-zero and subnormal patterns, as they lie and one element past a
16-byte boundary), then
`p0_stereo_44k1` (profile 0, 24-bit, the float32 fast path, and its int24
transfer variant, whose `i24_pack` and `i24_unpack` kernels are held bit
for bit against their plain versions first, on NaN, infinities, +-1 and
values past +-1 too; the card's stream decoded again on the CPU),
`p4_mono_44k1` (profile 4, 16-bit: the card's stream equals the CPU's),
`p0_stereo_48b` and `p0_stereo_64b` (the float64 FFT form on the card
against the CPU), `hires_96k_8ch` (96 kHz, 8 channels, 8192-sample frames,
cut to 10 s), Profile 1 at 8192-sample frames (the DCT GEMM cut along its
contraction) and at 16384 (the FFT form), and the `p0_stereo_44k1` track
as s32le bytes through `Encoder` and `Decoder`. Then the Profile 2 phase:
`tns_iir` and `tns_fir_gate` (on the Levinson recursion's dead, clamped
and frozen lanes) held bit for bit against their plain versions at the
batch and the streaming shapes, float32 and float64, with the
float64 and no-divisor forms of `power_quant` and the float64 form of
`overlap_add` (the phase fails if one of its runs launches a kernel at a
shape, dtype or option that was not held so); the track as profile 2 through `batch_encode` /
`batch_decode` (the card's stream decoded again on the CPU) and through
`Decoder` in 32 KiB pushes; and 5 s of it as profiles 1 and 2 at
`compute_dtype="float64"`. `egr_pack` and `dequant` are held against
their plain versions first, at every shape, dtype and option that any of
these runs launches them at (a tally over all the runs fails the script on
a form that was not held); so are `mask_thres` and `thres_expand`, the
threshold chains of every lossy encode and decode (spectrum to divisor and
symbols; symbols to divisor, which `dequant` computes itself for Profile
1: a traced encode and decode of each lossy profile must show no GEMM and
no other kernel between the DCT and `power_quant` / `tns_autocorr` but
`mask_thres`, no GEMM in a decode but the IDCT's, and in a Profile 1
decode no `thres_expand` and `dequant` right before each IDCT GEMM), and
`overlap_add` at the forms no run launches (one channel, odd cut and
overlap, three channels, storage not 16-byte aligned), and in the Profile 2
phase `tns_autocorr` and `tns_fir_gate`, which are the TNS analysis
(inputs that meet every gate from both sides; the card's
quantised LPC rows of the 30 s track are held against a CPU encode's). The
batch and streaming runs of Profiles 1 and 2 print the pipeline's stage
timer. Last, the command-line phase: the track as an
s16le file through `frad_python_tpu_torch.app.main` on the card: `encode`
(the file must be the metadata header plus `batch_encode`'s bytes),
`decode`, `--no-turbo` through the engines, profile 0 at 24 bits, `repair`
of a damaged armored file, the `meta` actions, and one
`python3 -m frad_python_tpu_torch encode` subprocess. Then the sharded
phase: `overlap_add` with a halo (the tail of the frame before the first,
from another shard) held bit for bit against its plain version at one
rank's block when four share the track and at 4 frames, float32 and int16
emits and float64; `training_step_equivalent` on a one-rank NCCL mesh over
the 30 s track at float32 and float64 against the single-device cores;
the per-rank overlap-add by hand over four blocks of the track, each halo
the previous block's last tail; and the track encoded in four spans
(`multihost.host_span`, final only on the last) as `p1_stereo_44k1` and
`p0_stereo_44k1`, joined by `gather_bitstream` and held against one
`batch_encode`; a tally of the phase's launches holds every form it
launched against the plain versions. Last, the local split phase: the
frame-batch split of the batch cores (`models/batch.py`'s `place_rows`)
over four logical blocks of the card, and over every card when the
machine shows more (the earlier phases then run with the split off):
`p1_stereo_44k1`, `p0_stereo_44k1` (and its int24 forms), `hires_96k_8ch`
(10 s) and Profile 2 (5 s), at float32 and float64, each against the same
calls in one piece: float64 byte for byte, float32 to the frame plan, the
SNR floors and the decode of one stream (the payloads that differ
printed), with a tally that counts the halo launches and holds every form
against the plain versions.
Every phase prints one line; any failure exits non-zero. The
second-to-last line is a JSON object with one entry per kernel (thirteen,
each with its device time at the main path's shape and at the streaming
engines' shape), the last
line `{"ok": true, "device": {...}}`. Needs a CUDA device, nvcc and g++,
and refuses to run with FRAD_TORCH_NO_NATIVE set; imports neither jax
nor the JAX package.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

#: SNR floor of the 30 s main-path run. The JAX package's float32 path
#: (batch_encode(..., compute_dtype="float32", i16_upload=True) ->
#: batch_decode(..., compute_dtype="float32", i16_transfer=True)) reaches
#: 17.224032936 dB on this content on the CPU
#: (tests/test_torch_slice.py::test_chip_smoke_snr_floor measures it);
#: the floor is that minus 0.1 dB.
SNR_FLOOR_DB = 17.124

#: the card's decode against the CPU's decode of the same stream: the
#: IDCT GEMM sums in another order on each, so an int16 sample may round
#: one step the other way; two steps bound it
CARD_VS_CPU_MAX_ABS = 2.0 / 32768.0

SECONDS, SRATE, CHANNELS, BITS, FSIZE = 30.0, 44100, 2, 16, 2048
#: Profile 2 on the main path's geometry. SNR floor: the JAX package's
#: float32 Profile 2 SNR on the 30 s content on the CPU, P2_JAX_SNR_DB,
#: minus 0.1 dB (tests/test_torch_p2.py::test_chip_smoke_p2_snr_floors
#: measures it, and the float64 ones)
P2_JAX_SNR_DB = 17.0244
P2_SNR_FLOOR_DB = 16.924
#: profiles 1 and 2 at compute_dtype="float64" over F64_SECONDS of the
#: content: the JAX package's float64 SNR there minus 0.1 dB
F64_SECONDS = 5.0
F64_JAX_SNR_DB = {1: 17.1241, 2: 16.9243}
F64_SNR_FLOOR_DB = {1: 17.024, 2: 16.824}
#: float64 decodes of one stream on the card and on the CPU (cuFFT against
#: the CPU's FFT, the last bits of f64 through the TNS filter's gain)
F64_LOSSY_CARD_VS_CPU_MAX_ABS = 1e-9
#: the float32 Profile 2 decode of one stream on the card and on the CPU:
#: powf and the GEMMs differ in the last ulps on each, and the TNS
#: synthesis filter amplifies that before the IDCT (1.5e-6 measured on an
#: H100 on this content)
P2_CARD_VS_CPU_MAX_ABS = 1e-5
#: the TNS kernels' shapes [lanes = frames * channels, samples]. float32:
#: the 30 s batch decode (689 frames), its encode's 688 uniform frames and
#: its tail frame, and the engines' micro-batches of 8, 4, 2 and 1 frames.
#: float64: the first and the micro-batch of 4 again, then the F64_SECONDS
#: track's 114 uniform frames and its tail frame, padded to 1792 samples
TNS_SHAPES = {"float32": ((1378, 2048), (1376, 2048), (16, 2048), (8, 2048), (4, 2048),
                          (2, 2048)),
              "float64": ((1378, 2048), (8, 2048), (228, 2048), (2, 1792))}
#: power_quant's forms on the Profile 2 and float64 paths, (dtype, with a
#: divisor, shapes): Profile 2 has no divisor, Profile 1 at float64 has one
P2_POWER_QUANT_FORMS = (
    ("float32", False, ((1376, 2048), (8, 2048), (4, 2048), (2, 2048))),
    ("float64", False, ((1376, 2048), (228, 2048), (2, 1792))),
    ("float64", True, ((1376, 2048), (228, 2048), (2, 1792))))
#: overlap_add's forms there, (dtype, [B, C, N], olap, int16 emit): float64
#: at the main path's shape and at the F64_SECONDS track's two decode runs,
#: float32 at the Decoder's micro-batches of 4 and 8 frames (2 and 256 are
#: held in the streaming phase)
P2_OVERLAP_FORMS = (
    ("float64", (689, 2, 2048), 128, False), ("float64", (689, 2, 2048), 128, True),
    ("float64", (114, 2, 2048), 128, False), ("float64", (1, 2, 1792), 112, False),
    ("float32", (4, 2, 2048), 128, False), ("float32", (8, 2, 2048), 128, False))
#: the card's memory rate and float32 / float64 peak (NVIDIA H100 SXM data
#: sheet), for each kernel's bound
HBM_BYTES_PER_S = 3.35e12
# the data sheet gives no rate for 32-bit integer operations outside the
# tensor cores: the float32 rate of the same units stands in as their ceiling
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12, "int32": 67e12}

#: SNR floor of the lossless p0_stereo_44k1 run (24-bit, float32 fast
#: path): the JAX package's float32 SNR on this content, 97.5471 dB on the
#: CPU (its i24 transfer variant 97.5469 dB), minus 0.1 dB
#: (tests/test_torch_lossless.py::test_chip_smoke_lossless_snr_floor)
P0_BITS = 24
P0_SNR_FLOOR_DB = 97.447
#: Profile 1 at 16384-sample frames, through the FFT form: the JAX
#: package's float32 SNR here, 2.4436 dB on the CPU, minus 0.1 dB
#: (tests/test_torch_lossless.py::test_chip_smoke_profile1_16384_snr_floor)
P1_LONG_FSIZE = 16384
P1_LONG_SNR_FLOOR_DB = 2.344
#: Profile 1 at 8192-sample frames, the DCT GEMM cut along K: the JAX
#: package's float32 SNR here, 7.7632 dB on the CPU, minus 0.1 dB
#: (tests/test_torch_lossless.py::test_chip_smoke_profile1_8192_snr_floor)
P1_MID_FSIZE = 8192
P1_MID_SNR_FLOOR_DB = 7.663
#: the float32 lossless decode of one stream on the card and on the CPU:
#: the IDCT GEMM sums in another order on each, a few float32 ulps of
#: |pcm| < 2
LOSSLESS_CARD_VS_CPU_MAX_ABS = 2e-6
#: the float64 decode of one stream on the card and on the CPU: cuFFT and
#: the CPU's FFT differ in the last bits of f64
F64_CARD_VS_CPU_MAX_ABS = 1e-12
#: the archival SNR bounds of the JAX package's tests
#: (tests/test_deep_depth.py:49)
DEEP_SNR_DB = {48: 195.0, 64: 250.0}
HIRES = dict(seconds=10.0, srate=96000, channels=8, bits=24, fsize=8192)
#: hires_96k_8ch's floor over its first HIRES_FLOOR_FRAMES frames (a
#: profile 0 frame is coded on its own): the JAX package's float32 SNR
#: there, 97.4934 dB on the CPU, minus 0.1 dB
#: (tests/test_torch_lossless.py::test_chip_smoke_hires_snr_floor)
HIRES_FLOOR_FRAMES = 16
HIRES_SNR_FLOOR_DB = 97.393
#: the lossless trunc kernels' shapes: the p0_stereo_44k1 run's uniform
#: frames and its 2040-sample tail frame, the streaming run's
#: micro-batches of 2, and the hires run's frames and 1536-sample tail
TRUNC_SHAPES = ((645, 2, 2048), (1, 2, 2040), (2, 2, 2048), (117, 8, 8192), (1, 8, 1536))
#: the trunc kernels' other paths, which no run here takes (a mono Profile 0
#: stream would take the first): C = 1 in 16-byte pieces; rows of C * N not
#: a multiple of 16 (trunc_pack's value-by-value loads and byte stores),
#: which are also trunc_unpack's run-time channel path (C = 3) and rows of N
#: not whole groups (its element-wise loads and stores, at C = 1 and 8); the
#: third at 16 and 32 bits only
TRUNC_ODD_SHAPES = ((2, 1, 2048), (3, 3, 1004), (2, 1, 1001), (2, 8, 1001))
#: the int24 transfer kernels' shapes, PCM [B, N, C]: the p0_stereo_44k1 i24
#: run's uniform frames, its 2040-sample tail frame and its warm-up's 4
#: frames. i24_unpack takes the words [B, N * C * 3 / 4]; i24_pack is handed
#: the IDCT's [B, C, N] output as a transposed view
I24_SHAPES = ((645, 2048, 2), (1, 2040, 2), (4, 2048, 2))
#: the shape at which each kernel's device time is also taken: what the
#: engines hand it in 32 KiB pushes (micro-batches of 4 frames, 2 for profile
#: 0), and for the int24 forms, which only the batch calls use, their smallest
STREAMING_SHAPES = {
    "power_quant": "[8, 2048]", "overlap_add": "[4, 2, 2048] f32 emit",
    "trunc_pack": "[2, 2, 2048] 24-bit", "trunc_unpack": "[2, 2, 2048] 24-bit",
    "tns_iir": "[8, 2048]", "egr_pack": "[4, 4096]",
    "dequant": "[4, 2048, 2] i16 + thresholds", "tns_autocorr": "[8, 2048] + divisor",
    "tns_fir_gate": "[8, 2048]", "mask_thres": "[8, 2048]", "thres_expand": "[4, 2, 2048]",
    "i24_pack": "[4, 2048, 2] transposed view", "i24_unpack": "[4, 3072]"}
# the main path's shapes for 30 s: 688 uniform frames + a tail frame
# padded to 2048, encoded as two batches and decoded as one run
POWER_QUANT_SHAPE = (1376, 2048)         # R = uniform frames * channels, N bins
OVERLAP_SHAPE = (689, 2, 2048)           # IDCT output [B, C, N]
OLAP, CUT = 128, 1920
ECC_RATIO = (96, 24)
DEVICE = "cuda"
#: the kernels of the Profile 1 paths (the decode expands its thresholds
#: inside dequant: no thres_expand)
P1_KERNELS = ("power_quant", "overlap_add", "egr_pack", "dequant", "mask_thres")
#: the kernels of the Profile 2 paths
P2_KERNELS = ("power_quant", "overlap_add", "dequant", "tns_iir", "tns_autocorr",
              "tns_fir_gate", "mask_thres", "thres_expand")
#: the kernels of a Profile 2 encode
P2_ENCODE_KERNELS = ("power_quant", "tns_autocorr", "tns_fir_gate", "mask_thres")
#: lanes of the 30 s track whose quantised LPC row may differ between the
#: card's encode and the CPU's (a gate is a threshold on float sums, and the
#: DCT GEMM before them sums in another order on each)
TNS_CARD_VS_CPU_LANES = 2
# the streaming engines' shapes: one frame per call on the per-frame path,
# 2..256 frames per micro-batch; the decoder's micro-batches emit float32
STREAM_POWER_QUANT_SHAPES = ((2, 2048), (512, 2048))
STREAM_OVERLAP_CASES = ((2, OLAP, CUT), (256, OLAP, CUT), (256, 0, 2048))   # (B, olap, cut)
#: overlap_add's forms that no run launches, (dtype, [B, C, N], olap, int16
#: emit): one channel, odd cut and overlap (element-wise loads and
#: stores), three channels (the kernel's any-channel path), float64 with
#: one channel; each also on a copy whose storage is not 16-byte aligned
OVERLAP_EDGE_FORMS = (
    ("float32", (3, 1, 2048), 128, True), ("float32", (3, 1, 2048), 128, False),
    ("float32", (4, 2, 1000), 77, True), ("float32", (4, 2, 1000), 77, False),
    ("float32", (2, 3, 512), 32, True), ("float64", (3, 1, 2048), 128, False),
    ("float64", (3, 2, 1000), 77, True))
PUSH = 32768
#: the streaming decode against batch_decode(..., i16_transfer=False) of
#: the same stream: other batch sizes reach the IDCT GEMM, so float32
#: sums differ by a few ulps of |pcm| < 2
STREAM_VS_BATCH_MAX_ABS = 2e-6


#: egr_pack's forms, (rows, symbols a row): the batch encode's 688 uniform
#: frames (a tail frame is one row and takes the host coder) and the 1 s
#: warm-up's 22, the engines' micro-batches (2 and 4 frames in 32 KiB
#: pushes; 256, 128, 32 and 16 in one deep push or an 8 MiB read), and
#: Profile 1's uniform frames at 8192 and 16384 samples with their
#: warm-ups' 4; max_words is symbols * 12 // 32
EGR_FORMS = ((688, 4096), (2, 4096), (4, 4096), (16, 4096), (22, 4096), (32, 4096),
             (128, 4096), (256, 4096), (172, 16384), (4, 16384), (86, 32768), (4, 32768))
#: max_words of egr_pack's extra check on [4, 200] full-range symbols (36
#: bits a symbol hold any code)
EGR_WIDE_WORDS = 200 * 36 // 32 + 1
#: and of its check above 2048 rows, where the rows' offsets come from a
#: scan launch instead of each pack block's own sum
EGR_MANY_ROWS = (2304, 64)
#: dequant's forms, (symbol dtype, [B, N, C], with threshold symbols):
#: Profile 1 passes them, Profile 2 none. int16 symbols in batches, runs and
#: micro-batches (689 frames, the warm-ups' 23, runs of 1, 2, 4 and 8; at
#: 8192 samples 172 and the 6144-sample tail frame, at 16384 samples 86,
#: and the warm-ups' 4 and 5), float32 on the per-frame path (one frame),
#: float64 at compute_dtype="float64" (the F64_SECONDS track's 114 uniform
#: frames and its tail frame padded to 1792 samples)
DEQUANT_FORMS = (
    ("int16", (689, 2048, 2), True), ("int16", (1, 2048, 2), True),
    ("int16", (2, 2048, 2), True), ("int16", (4, 2048, 2), True),
    ("int16", (8, 2048, 2), True), ("int16", (23, 2048, 2), True),
    ("float32", (1, 2048, 2), True), ("int16", (172, 8192, 2), True),
    ("int16", (1, 6144, 2), True), ("int16", (4, 8192, 2), True),
    ("int16", (86, 16384, 2), True), ("int16", (5, 16384, 2), True),
    ("int16", (689, 2048, 2), False), ("int16", (2, 2048, 2), False),
    ("int16", (4, 2048, 2), False), ("int16", (8, 2048, 2), False),
    ("int16", (23, 2048, 2), False), ("float32", (1, 2048, 2), False),
    ("float64", (114, 2048, 2), True), ("float64", (1, 1792, 2), True),
    ("float64", (114, 2048, 2), False), ("float64", (1, 1792, 2), False))
#: dequant's forms that no run of this script launches, (symbol dtype,
#: [B, N, C]): one channel (the kernel's C = 1 path), N not a multiple of a
#: run (element-wise loads and stores at C = 2) and three channels (its
#: any-channel path), at each symbol dtype; each is held with and without
#: threshold symbols, and each also on copies whose storage is not 16-byte
#: aligned (element-wise at C = 1 too)
DEQUANT_EDGE_FORMS = tuple((dtype, shape) for shape in ((3, 2048, 1), (2, 1001, 2), (2, 512, 3))
                           for dtype in ("int16", "float32", "float64"))
#: mask_thres's forms, (dtype, rows = frames * channels, samples a frame,
#: channels), for every batch that an encoder of these runs hands over: the
#: 30 s track's 688 uniform frames and its tail frame, the 1 s warm-ups' 22,
#: the engines' micro-batches, Profile 1 at 8192 and 16384 samples (their
#: tail frames too), and the F64_SECONDS track at float64; then the edges no
#: run reaches: 256 and 16384 samples at both dtypes, one row, odd row counts
MASK_THRES_FORMS = (
    ("float32", 1376, 2048, 2), ("float32", 2, 2048, 2), ("float32", 4, 2048, 2),
    ("float32", 8, 2048, 2), ("float32", 16, 2048, 2), ("float32", 32, 2048, 2),
    ("float32", 44, 2048, 2), ("float32", 64, 2048, 2), ("float32", 256, 2048, 2),
    ("float32", 512, 2048, 2), ("float32", 344, 8192, 2), ("float32", 8, 8192, 2),
    ("float32", 2, 6144, 2), ("float32", 172, 16384, 2), ("float32", 2, 16384, 2),
    ("float32", 8, 16384, 2), ("float64", 228, 2048, 2), ("float64", 2, 1792, 2),
    ("float32", 1, 256, 1), ("float32", 7, 256, 1), ("float64", 1, 2048, 1),
    ("float64", 5, 256, 1), ("float64", 3, 8192, 1), ("float64", 2, 16384, 2),
    ("float32", 3, 16384, 1))
#: thres_expand's forms, (dtype, frames, samples a frame, channels): every
#: Profile 2 run of DEQUANT_FORMS (Profile 1 expands inside dequant), and the
#: same edges as mask_thres's
THRES_EXPAND_FORMS = tuple(sorted({
    ("float64" if dtype == "float64" else "float32", shape[0], shape[1], shape[2])
    for dtype, shape, with_thres in DEQUANT_FORMS if not with_thres})) + (
    ("float32", 1, 256, 1), ("float32", 7, 256, 1), ("float64", 1, 2048, 1),
    ("float64", 5, 256, 1), ("float64", 3, 8192, 1), ("float64", 1, 16384, 2),
    ("float32", 3, 16384, 1))
#: the command-line phase: the track as an s16le file. Profile 1 at the
#: CLI's default loss level, decoded to s16le: the JAX package's float32
#: SNR there, 17.6704 dB on the CPU, minus 0.1 dB; profile 0 at 24 bits
#: decoded to f64be, against the file's samples: 97.5227 dB minus 0.1 dB
#: (tests/test_torch_app_floors.py measures both)
CLI_P1_SNR_FLOOR_DB = 17.570
CLI_P0_SNR_FLOOR_DB = 97.423
#: the sharded phase: ranks that share the 30 s track in the by-hand run and
#: in the spanwise encodes
SHARDS = 4
#: overlap_add's halo form, [B, C, N]: one rank's block when four share the
#: track's 688 uniform frames, and when they share its 689 frames padded to
#: 692 (the by-hand run), and the engines' micro-batch of 4 frames
HALO_SHAPES = ((172, 2, 2048), (173, 2, 2048), (4, 2, 2048))
#: ... at each (input dtype, int16 emit): the float emit, the int16 emit and
#: float64
HALO_EMITS = (("float32", False), ("float32", True), ("float64", False))
#: the spanwise encodes: (name, profile, bits, compact, options, SNR floor)
SPAN_CONFIGS = (("p1_stereo_44k1", 1, BITS, True, dict(i16_upload=True), SNR_FLOOR_DB),
                ("p0_stereo_44k1", 0, P0_BITS, False, {}, P0_SNR_FLOOR_DB))

#: every form (`kernel_form`) at which a kernel was held against its plain
#: version in this run
CHECKED: set[tuple] = set()


def kernel_form(name: str, *args) -> tuple:
    """What tells one launch of a kernel from another of another form: the
    wrapper's name, its first tensor's shape and dtype, and for power_quant
    and tns_autocorr whether it has a divisor, for dequant whether it has
    threshold symbols and then the sample rate, for overlap_add the
    overlap, cut and emit (and "halo" where frame 0 is blended with one),
    for egr_pack max_words, for mask_thres the
    sample rate and the channels, for thres_expand the samples a frame
    and the sample rate, for i24_pack whether the PCM is contiguous (the
    kernel reads a view through its strides)."""
    x = args[0]
    form = (name, tuple(x.shape), str(x.dtype).removeprefix("torch."))
    if name == "power_quant":
        return form + (args[1] is not None,)
    if name == "overlap_add":
        halo = ("halo",) if len(args) > 4 and args[4] is not None else ()
        return form + (int(args[1].numel()), int(args[2]), bool(args[3])) + halo
    if name == "egr_pack":
        return form + (int(args[1]),)
    if name == "dequant":
        return form + (args[1] is not None, int(args[3]) if args[1] is not None else 0)
    if name == "tns_autocorr":
        return form + (args[1] is not None,)
    if name == "mask_thres":
        return form + (int(args[3]), int(args[4]))
    if name == "thres_expand":
        return form + (int(args[1]), int(args[2]))
    if name == "i24_pack":
        return form + (bool(x.is_contiguous()),)
    return form


def held(kernels, name: str, *args):
    """(kernel's result, plain version's result) of `name` on `args`, both
    as tuples of tensors; the form goes into CHECKED (the caller raises
    where the two differ)."""
    got = getattr(kernels, name)(*args)
    want = getattr(kernels, name + "_plain")(*args)
    CHECKED.add(kernel_form(name, *args))
    return tuple(r if isinstance(r, tuple) else (r,) for r in (got, want))


class FormTally:
    """The forms at which the port's modules call the kernels' wrappers,
    counted over its `with` blocks by wrapping the names the modules hold
    them under."""

    def __init__(self, only: tuple[str, ...] | None = None, device_type: str = "cuda"):
        """`only`: the wrappers to count (None: all). `device_type`: where
        a call's first tensor must lie to count: "cuda" counts launches and
        leaves the plain versions' calls out, "cpu" serves the CPU tests."""
        from frad_python_tpu_torch.models import batch
        from frad_python_tpu_torch.ops import tns
        from frad_python_tpu_torch.parallel import pipeline, sharded

        self.targets = [(mod, name) for mod, name in (
            (batch, "power_quant"), (batch, "overlap_add"), (sharded, "overlap_add"),
            (tns, "tns_iir"),
            (pipeline, "egr_pack"), (batch, "dequant"),
            (tns, "tns_autocorr"), (tns, "tns_fir_gate"), (batch, "mask_thres"),
            (batch, "thres_expand"), (batch, "i24_pack"), (batch, "i24_unpack"))
            if only is None or name in only]
        self.device_type = device_type
        self.seen: dict[tuple, int] = {}
        #: words of the compacted streams that egr_pack returned
        self.egr_words = 0

    def __enter__(self):
        self.saved = [getattr(mod, name) for mod, name in self.targets]

        def wrap(fn, name):
            def counted(*args):
                out = fn(*args)
                if args[0].device.type == self.device_type:
                    form = kernel_form(name, *args)
                    self.seen[form] = self.seen.get(form, 0) + 1
                    if name == "egr_pack":
                        self.egr_words += int(out[0].numel())
                return out
            return counted

        for (mod, name), fn in zip(self.targets, self.saved):
            setattr(mod, name, wrap(fn, name))
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in zip(self.targets, self.saved):
            setattr(mod, name, fn)

    def unchecked(self) -> list[tuple]:
        """The forms launched in the block that no check of this run held
        against a plain version."""
        return sorted((f for f in self.seen if f not in CHECKED), key=str)

    def require_held(self, what: str) -> None:
        if self.unchecked():
            raise AssertionError(f"{what} launched kernels at forms that no check held "
                                 f"against a plain version: {self.unchecked()}")


def make_audio(seconds: float, srate: int, ch: int) -> np.ndarray:
    """The benchmark's content: four harmonics of 220 Hz plus noise
    (a copy of bench.make_audio)."""
    rng = np.random.default_rng(0)
    t = np.arange(int(seconds * srate)) / srate
    sig = sum(0.3 / (i + 1) * np.sin(2 * np.pi * (220 * (i + 1)) * t[:, None] + i)
              for i in range(4)) * np.ones((1, ch))
    return sig + 0.01 * rng.standard_normal((len(t), ch))


def snr_db(ref: np.ndarray, out: np.ndarray) -> float:
    m = len(ref)
    err = out[:m] - ref
    return float(10 * np.log10(np.sum(ref ** 2) / np.sum(err ** 2)))


def cuda_ms(torch, fn, reps: int = 11, inner: int = 20) -> float:
    """Median over `reps` of the mean device time of `inner` calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound(nbytes: float, flops: float, dtype: str = "float32") -> tuple[float, str]:
    """(least time in ms the card could take, what bounds it): the bytes
    the function must move (each input read once, each output written
    once) over the memory rate, or its operations over the peak rate of
    their type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


#: throwaway kernels that open a recorded step: without them a recording
#: after a warmup step lost kernels 6 times in 20 (PERF.md §7)
TRACE_LEADS = 8


def profiled_device_ms(torch, calls: dict) -> dict:
    """Device time in ms of one launch of each hand kernel on its check's
    inputs, from ONE `torch.profiler` call over the thunks of `calls`
    ({kernel function name: thunk}); None where the trace kept no such
    kernel. A recording can lose some of its kernels, or all of them
    (PERF.md §7): the profiler warms up over one pass of the calls (a
    schedule's warmup step, whose events it drops), then opens the
    recorded step with TRACE_LEADS throwaway kernels and runs the calls
    once, each on its inputs as the warmup pass left them. A thunk of
    several kernels (`egr_`) sums one launch of each."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    lead = torch.zeros(1, device=DEVICE)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for fn in calls.values():
            fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(TRACE_LEADS):
            lead.add_(1)
        torch.cuda.synchronize()
        for fn in calls.values():
            fn()
        torch.cuda.synchronize()
    kept = {e.name: e.time_range.elapsed_us() for e in prof.events()
            if e.device_type == DeviceType.CUDA}
    out = {}
    for name in calls:
        us = [v for k, v in kept.items() if name in k]
        out[name] = sum(us) / 1e3 if us and sum(us) > 0 else None
    return out


#: recordings of the kernels that the recordings before lost, at most
TRACE_RETRIES = 10


def kept_device_ms(torch, calls: dict) -> tuple[dict, int]:
    """(`profiled_device_ms` of `calls`, recordings made): the kernels that
    a recording did not keep are recorded again, by themselves, until each
    is kept or TRACE_RETRIES more recordings were made (PERF.md §7 gives
    how often a kernel is lost and how many recordings it took)."""
    ms = profiled_device_ms(torch, calls)
    made = 1
    while made <= TRACE_RETRIES and None in ms.values():
        ms.update(profiled_device_ms(torch, {k: calls[k] for k, v in ms.items() if v is None}))
        made += 1
    return ms, made


def check_native_pack(native) -> None:
    """p1_pack_batch against the Python payload layout on main-path-sized
    frames: its DEFLATE must equal this machine's zlib.compress byte for
    byte."""
    import struct
    import zlib

    import torch

    from frad_python_tpu_torch.ops import bitpack, golomb

    rng = np.random.default_rng(7)
    fq = np.rint(rng.laplace(0, 1, (16, FSIZE * CHANNELS))
                 * np.linspace(0.5, 40, 16)[:, None]).astype(np.int32)
    tq = rng.integers(0, 60, (16, 27 * CHANNELS))
    words, nbits, ks, ovf = (t.numpy() for t in bitpack.egr_pack_frames(
        torch.from_numpy(fq), FSIZE * CHANNELS * 12 // 32))
    words = words.astype(np.uint32)
    got = native.p1_pack_batch(words, nbits, ks, ovf, tq)
    for i, p in enumerate(got):
        thres = golomb.encode(tq[i])
        frad = (struct.pack(">I", len(thres)) + thres
                + bitpack.words_to_stream(words[i], nbits[i], ks[i]))
        if ovf[i] or p != zlib.compress(frad, wbits=-15):
            raise AssertionError(f"native p1_pack_batch differs from zlib.compress at frame {i}")


def check_stream_shapes(torch, kernels, crossfade_window, dev) -> tuple[float, float]:
    """Each kernel against its plain version at the streaming engines'
    shapes, exactly; returns (power_quant max |d|, overlap_add max |d|)."""
    rng = np.random.default_rng(4321)
    pq_err = oa_err = 0.0
    for shape in STREAM_POWER_QUANT_SHAPES:
        freqs = (rng.standard_normal(shape) * 1e-2).astype(np.float32)
        div = (np.exp(rng.standard_normal(shape) * 2.0) * 0.1).astype(np.float32)
        div[:, -128:] = 0.0
        f_d, d_d = torch.from_numpy(freqs).to(dev), torch.from_numpy(div).to(dev)
        (got,), (want,) = held(kernels, "power_quant", f_d, d_d, 2.0 ** 15)
        torch.cuda.synchronize()
        err = float((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        pq_err = max(pq_err, err)
        if not torch.equal(got, want):
            raise AssertionError(f"power_quant {shape} differs from its plain version: "
                                 f"max |d| {err}")
        ms = cuda_ms(torch, lambda: kernels.power_quant(f_d, d_d, 2.0 ** 15))
        plain = cuda_ms(torch, lambda: kernels.power_quant_plain(f_d, d_d, 2.0 ** 15))
        print(f"kernel power_quant {shape}: equal, max|d| {err}, {ms:.4f} ms vs plain "
              f"{plain:.4f} ms")
    for b, olap, cut in STREAM_OVERLAP_CASES:
        pcm_k = torch.from_numpy(
            rng.standard_normal((b, CHANNELS, FSIZE)).astype(np.float32) * 0.3).to(dev)
        w = crossfade_window(olap, dev)
        (out_k, frag_k), (out_p, frag_p) = held(kernels, "overlap_add", pcm_k, w, cut, False)
        torch.cuda.synchronize()
        err = float((out_k - out_p).abs().max())
        if olap:
            err = max(err, float((frag_k - frag_p).abs().max()))
        oa_err = max(oa_err, err)
        if not (torch.equal(out_k, out_p) and torch.equal(frag_k, frag_p)):
            raise AssertionError(f"overlap_add B={b} olap={olap} differs from its plain "
                                 f"version: max |d| {err}")
        ms = cuda_ms(torch, lambda: kernels.overlap_add(pcm_k, w, cut, False))
        plain = cuda_ms(torch, lambda: kernels.overlap_add_plain(pcm_k, w, cut, False))
        print(f"kernel overlap_add ({b}, {CHANNELS}, {FSIZE}) olap={olap} cut={cut} f32 emit: "
              f"equal, max|d| {err}, {ms:.4f} ms vs plain {plain:.4f} ms")
    for dtype, shape, olap, i16 in OVERLAP_EDGE_FORMS:
        pcm = torch.from_numpy((rng.standard_normal(shape) * 0.6).astype(dtype)).to(dev)
        w = crossfade_window(olap, dev, pcm.dtype)
        cut = shape[2] - olap
        for x in (pcm, offset_view(torch, pcm)):
            (out_k, frag_k), (out_p, frag_p) = held(kernels, "overlap_add", x, w, cut, i16)
            torch.cuda.synchronize()
            oa_err = max(oa_err, max_abs(torch, out_k, out_p), max_abs(torch, frag_k, frag_p))
            if not (bits_equal(torch, out_k, out_p) and bits_equal(torch, frag_k, frag_p)):
                raise AssertionError(f"overlap_add {dtype} {shape} olap={olap} i16={i16} "
                                     f"aligned={x.data_ptr() % 16 == 0} differs from its plain "
                                     f"version: max |d| {oa_err}")
    print(f"kernel overlap_add at {list(OVERLAP_EDGE_FORMS)}, each also on storage not 16-byte "
          f"aligned: equal bit for bit")
    return pq_err, oa_err


def to_s16le(pcm: np.ndarray) -> bytes:
    """PCM as s16le bytes (the same rounding as batch_encode's i16 upload)."""
    return np.clip(np.rint(pcm * 32768.0), -32768, 32767).astype("<i2").tobytes()


class FrameTally:
    """Frames per call of the engines' batch and per-frame routes, counted
    by wrapping the module functions they call for the `with` block.
    `profile` is the per-frame codec module; a micro-batch span of `n`
    samples holds (n - olap) // hop frames."""

    def __init__(self, pipeline, profile, hop: int = CUT, olap: int = OLAP):
        self.targets = [(pipeline, "batch_encode", "enc_batch"),
                        (pipeline, "_decode_run", "dec_batch"),
                        (profile, "analogue", "enc_frame"),
                        (profile, "digital", "dec_frame")]
        self.hop, self.olap = hop, olap
        self.seen: dict[str, dict[int, int]] = {}

    def __enter__(self):
        self.saved = [getattr(mod, name) for mod, name, _ in self.targets]
        self.seen = {key: {} for _, _, key in self.targets}

        def wrap(fn, key):
            def counted(arg, *args, **kwargs):
                # frames: span length on the frame grid, or header count
                k = ((len(arg) - self.olap) // self.hop if key == "enc_batch"
                     else len(arg) if key == "dec_batch" else 1)
                self.seen[key][k] = self.seen[key].get(k, 0) + 1
                return fn(arg, *args, **kwargs)
            return counted

        for (mod, name, key), fn in zip(self.targets, self.saved):
            setattr(mod, name, wrap(fn, key))
        return self

    def __exit__(self, *exc):
        for (mod, name, _), fn in zip(self.targets, self.saved):
            setattr(mod, name, fn)

    def used(self) -> dict[str, dict[int, int]]:
        """{route: {frames per call: calls}} of the routes that ran."""
        return {key: dict(sorted(v.items())) for key, v in self.seen.items() if v}


def stream_encode(ft, torch, raw: bytes, push: int, dev, ecc=None) -> bytes:
    enc = ft.Encoder(1, SRATE, CHANNELS, BITS, FSIZE, "s16le", device=dev)
    enc.set_overlap_ratio(16)
    if ecc:
        enc.set_ecc(True, ecc)
    out = [enc.process(raw[i:i + push]).buf for i in range(0, len(raw), push)]
    out.append(enc.flush().buf)
    torch.cuda.synchronize()
    return b"".join(out)


def to_s32le(pcm: np.ndarray) -> bytes:
    """PCM as s32le bytes (x2^31, rounded and clamped)."""
    return np.clip(np.rint(pcm * 2.0 ** 31), -2 ** 31, 2 ** 31 - 1).astype("<i4").tobytes()


def stream_encode_p0(ft, torch, raw: bytes, push: int, dev) -> bytes:
    """s32le bytes through a profile 0 `Encoder` (p0_stereo_44k1) in `push`-byte pushes."""
    enc = ft.Encoder(0, SRATE, CHANNELS, P0_BITS, FSIZE, "s32le", device=dev)
    out = [enc.process(raw[i:i + push]).buf for i in range(0, len(raw), push)]
    out.append(enc.flush().buf)
    torch.cuda.synchronize()
    return b"".join(out)


def stream_decode(ft, torch, stream: bytes, push: int, dev, **kw) -> tuple[np.ndarray, float]:
    """(decoded PCM, seconds to the first non-empty DecodeResult)."""
    dec = ft.Decoder(device=dev, **kw)
    parts = []
    first = None
    t0 = time.perf_counter()
    for i in range(0, len(stream), push):
        p = dec.process(stream[i:i + push]).pcm
        if p.size:
            if first is None:
                first = time.perf_counter() - t0
            parts.append(p)
    parts.append(dec.flush().pcm)
    torch.cuda.synchronize()
    return np.concatenate([p for p in parts if p.size]), first


def timed(torch, fn):
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def trunc_inputs(shape: tuple[int, int, int], seed: int) -> np.ndarray:
    """[B, C, N] float32 DCT-like output with the truncation edges in frame
    0 (the f16 range, rounding to inf from 65520, f16 and f32 subnormals,
    signed zeros) and a NaN in the last frame when there are several."""
    y = (np.random.default_rng(seed).standard_normal(shape) * 0.3).astype(np.float32)
    edges = [65504.0, 65519.99, 65520.0, -65520.0, 6e-8, -3e-8, 6.1e-5, -0.0, 0.0, 1e-40]
    y[0, 0, :len(edges)] = edges
    if shape[0] > 1:
        y[-1, -1, 5] = np.nan
    return y


def trunc_random_words(shape: tuple[int, int, int], bits: int, little: bool,
                       seed: int) -> np.ndarray:
    """Payload words for trunc_unpack at [B, C, N] (int16 [B, C*N] at 16
    bits, int32 [B, C*N*bits/32] at 24 and 32) of random bytes, whose values
    are in part forced into the classes the unpacking treats apart: the
    most significant byte 0x7F or 0xFF (a NaN at 16 bits; at 24 and 32 a
    NaN or Inf where the next byte's top bit, the exponent's last, is set),
    Inf and NaN of either sign, signed zeros, subnormals of either sign;
    the byte order as `little` says."""
    b, c, n = shape
    bpv = bits // 8
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 256, (b, c * n, bpv), dtype=np.uint8)   # most significant byte first
    kind = rng.integers(0, 12, (b, c * n))
    sign = (rng.integers(0, 2, (b, c * n)) * 0x80).astype(np.uint8)
    exp_top = 0x7C if bits == 16 else 0x7F          # the exponent's bits in the first byte
    v[kind == 0, 0] = np.where(sign[kind == 0] != 0, 0xFF, 0x7F)
    for k, mantissa in ((1, False), (2, True)):     # Inf, NaN
        v[kind == k, 0] = sign[kind == k] | exp_top
        v[kind == k, 1:] = 0
        if bits != 16:
            v[kind == k, 1] = 0x80
        if mantissa:
            v[kind == k, -1] |= 1
    v[kind == 3, 0] = sign[kind == 3]               # signed zeros
    v[kind == 3, 1:] = 0
    v[kind == 4, 0] &= 0x80 | (0x7F ^ exp_top)      # subnormals (or zeros)
    if bits != 16:
        v[kind == 4, 1] &= 0x7F
    if little:
        v = v[..., ::-1]
    raw = np.ascontiguousarray(v).reshape(b, -1)
    return raw.view(np.int16 if bits == 16 else np.int32)


def nan_words(torch, y, bits: int):
    """The payload words of trunc_pack(y, bits) that hold a NaN of y
    [B, C, N]: value t*C + c of frame b is word t*C + c at 16 and 32 bits,
    and one of the three words of its group of four at 24."""
    b = y.shape[0]
    nan = torch.isnan(y.transpose(1, 2).reshape(b, -1))
    if bits == 24:
        return nan.reshape(b, -1, 4).any(-1).repeat_interleave(3, dim=1)
    return nan


def trunc_bounds(b: int, c: int, n: int) -> dict:
    """The trunc kernels' bounds at [b, c, n], P0_BITS."""
    m = b * c * n
    return {"trunc_pack": bound(m * 4 + m * P0_BITS // 8 + b * 4, m * 2),
            "trunc_unpack": bound(m * P0_BITS // 8 + m * 4, m)}


def check_trunc_kernels(torch, kernels, dev) -> dict:
    """trunc_pack and trunc_unpack against their plain versions on the card
    at TRUNC_SHAPES, every depth and byte order: every payload word equal
    but the one (16, 32 bits) or three (24 bits) that hold the NaN (its f16
    bits are the converter's own, and its frame leaves the fast path on its
    NaN max|x|), max|x| equal with the NaN in place; trunc_unpack's floats
    equal bit for bit (-0.0 is not +0.0) on trunc_pack's words, and on
    `trunc_random_words` as they lie and on a copy that starts one element
    past a 16-byte boundary; at TRUNC_ODD_SHAPES too. Returns the max |d|
    and the CUDA-event times of kernel and plain at the p0_stereo_44k1
    shape, with a call of each there (`thunks`) and at the streaming shape
    (`stream_thunks`), and the bounds of those calls (`bounds`,
    `stream_bounds`)."""
    out = {"pack_err": 0.0, "unpack_err": 0.0}
    unpacked = 0
    for si, shape in enumerate(TRUNC_SHAPES + TRUNC_ODD_SHAPES):
        b, c, n = shape
        y = torch.from_numpy(trunc_inputs(shape, 99 + si)).to(dev)
        for bits in (16, 24, 32):
            if bits == 24 and (c * n) % 4:
                continue
            keep = ~nan_words(torch, y, bits)
            if int((~keep).sum()) != (0 if b == 1 else 3 if bits == 24 else 1):
                raise AssertionError(f"trunc check {shape}: NaN words {int((~keep).sum())}")
            for little in (False, True):
                w_k, m_k = kernels.trunc_pack(y, bits, little)
                w_p, m_p = kernels.trunc_pack_plain(y, bits, little)
                torch.cuda.synchronize()
                d_w = float((w_k[keep].to(torch.int64) - w_p[keep].to(torch.int64)).abs().max())
                out["pack_err"] = max(out["pack_err"], d_w)
                if not (torch.equal(w_k[keep], w_p[keep])
                        and torch.equal(m_k.nan_to_num(-1.0), m_p.nan_to_num(-1.0))
                        and (b == 1 or bool(torch.isnan(m_k[-1])))):
                    raise AssertionError(f"trunc_pack {shape} bits={bits} little={little} "
                                         f"differs from its plain version: max |d| {d_w}")
                w_r = torch.from_numpy(trunc_random_words(shape, bits, little, 7 + si)).to(dev)
                for kind, w in (("packed", w_k), ("random", w_r),
                                ("random, offset", offset_view(torch, w_r))):
                    u_k = kernels.trunc_unpack(w, bits, little, n, c)
                    u_p = kernels.trunc_unpack_plain(w, bits, little, n, c)
                    d_u = float((u_k - u_p).abs().max())
                    out["unpack_err"] = max(out["unpack_err"], d_u)
                    unpacked += 1
                    if not bits_equal(torch, u_k, u_p):
                        raise AssertionError(f"trunc_unpack {shape} bits={bits} little={little} "
                                             f"on {kind} words differs from its plain version "
                                             f"bit for bit: max |d| {d_u}")
        if si == 0:
            w, _ = kernels.trunc_pack(y, P0_BITS, False)
            out["pack_ms"] = cuda_ms(torch, lambda: kernels.trunc_pack(y, P0_BITS, False))
            out["pack_plain_ms"] = cuda_ms(
                torch, lambda: kernels.trunc_pack_plain(y, P0_BITS, False))
            out["unpack_ms"] = cuda_ms(
                torch, lambda: kernels.trunc_unpack(w, P0_BITS, False, n, c))
            out["unpack_plain_ms"] = cuda_ms(
                torch, lambda: kernels.trunc_unpack_plain(w, P0_BITS, False, n, c))
            out["thunks"] = {
                "trunc_pack_kernel": lambda y=y: kernels.trunc_pack(y, P0_BITS, False),
                "trunc_unpack_kernel": lambda w=w, n=n, c=c: kernels.trunc_unpack(
                    w, P0_BITS, False, n, c)}
            out["bounds"] = trunc_bounds(b, c, n)
        elif si == 2:
            w, _ = kernels.trunc_pack(y, P0_BITS, False)
            out["stream_thunks"] = {
                "trunc_pack_kernel": lambda y=y: kernels.trunc_pack(y, P0_BITS, False),
                "trunc_unpack_kernel": lambda w=w, n=n, c=c: kernels.trunc_unpack(
                    w, P0_BITS, False, n, c)}
            out["stream_bounds"] = trunc_bounds(b, c, n)
    print(f"kernels trunc_pack / trunc_unpack at {list(TRUNC_SHAPES + TRUNC_ODD_SHAPES)}, bits "
          f"16/24/32 (24 where C * N % 4 == 0), both byte orders: equal to plain (max|d| "
          f"{out['pack_err']} / {out['unpack_err']}; trunc_unpack bit for bit on {unpacked} "
          f"packed, random and offset random payloads); "
          f"at {TRUNC_SHAPES[0]} {P0_BITS}-bit: trunc_pack {out['pack_ms']:.4f} ms vs plain "
          f"{out['pack_plain_ms']:.4f} ms, trunc_unpack {out['unpack_ms']:.4f} ms vs plain "
          f"{out['unpack_plain_ms']:.4f} ms")
    return out


def i24_inputs(shape: tuple[int, int, int], seed: int) -> np.ndarray:
    """[B, C, N] float32 PCM as the IDCT leaves it, with the values whose
    handling `i24_pack_plain` spells out at the start of frame 0: a NaN,
    both infinities, +-1.0, values past +-1, the largest float32 under 1,
    signed zeros, ties of the rounding and the float32 extremes."""
    b, n, ch = shape
    x = (np.random.default_rng(seed).standard_normal((b, ch, n)) * 0.4).astype(np.float32)
    step = 2.0 ** -23
    edges = [np.nan, np.inf, -np.inf, 1.0, -1.0, 1.5, -1.5, 0.99999994, -0.99999994, 0.0, -0.0,
             0.5 * step, 1.5 * step, 2.5 * step, -0.5 * step, -1.5 * step, 3e38, -3e38]
    x[0, 0, :len(edges)] = edges
    return x


def check_i24_kernels(torch, kernels, dev) -> dict:
    """i24_pack and i24_unpack against their plain versions on the card at
    I24_SHAPES, bit for bit: i24_pack on the transposed view the decoder
    hands it and on a contiguous copy, i24_unpack on i24_pack's words (the
    edge values' among them) and on random words. CUDA-event times of both
    and of their plain versions at the main run's shape, a call of each
    there (`thunks`) and at the smallest shape (`stream_thunks`), and each
    one's bound: 7 bytes a sample."""
    res = {"pack_err": 0, "unpack_err": 0.0, "thunks": {}, "stream_thunks": {}, "bounds": {},
           "stream_bounds": {}}
    rng = np.random.default_rng(2424)
    for si, shape in enumerate(I24_SHAPES):
        b, n, ch = shape
        view = torch.from_numpy(i24_inputs(shape, 240 + si)).to(dev).transpose(1, 2)
        for pcm in (view, view.contiguous()):
            (w_k,), (w_p,) = held(kernels, "i24_pack", pcm)
            torch.cuda.synchronize()
            if w_k.dtype != w_p.dtype or not torch.equal(w_k, w_p):
                res["pack_err"] = int((w_k != w_p).sum())
                raise AssertionError(
                    f"i24_pack {shape} contiguous={pcm.is_contiguous()} differs from its "
                    f"plain version in {res['pack_err']} of {w_k.numel()} words")
        if pcm.is_contiguous() == view.is_contiguous():
            raise AssertionError(f"i24_pack {shape}: the view and its copy are one form")
        # NaN -> 0, +Inf -> 2^23 - 1, -Inf -> -2^23 at the start of frame 0
        first = kernels.i24_unpack_plain(w_k).reshape(b, n, ch)[0, :3, 0].tolist()
        if first != [0.0, 1.0 - 2.0 ** -23, -1.0]:
            raise AssertionError(f"i24_pack {shape}: NaN, +Inf, -Inf gave {first}")
        rand = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, tuple(w_k.shape), dtype=np.int64)
                                .astype(np.int32)).to(dev)
        for words in (w_k, rand):
            (p_k,), (p_p,) = held(kernels, "i24_unpack", words)
            torch.cuda.synchronize()
            res["unpack_err"] = max(res["unpack_err"], max_abs(torch, p_k, p_p))
            if not bits_equal(torch, p_k, p_p):
                raise AssertionError(f"i24_unpack {tuple(words.shape)} differs from its plain "
                                     f"version: {ulp_report(torch, p_k, p_p)}")
        calls = {"i24_pack_kernel": lambda v=view: kernels.i24_pack(v),
                 "i24_unpack_kernel": lambda w=w_k: kernels.i24_unpack(w)}
        if si == 0:
            res["pack_ms"] = cuda_ms(torch, calls["i24_pack_kernel"])
            res["pack_plain_ms"] = cuda_ms(torch, lambda: kernels.i24_pack_plain(view), 5, 5)
            res["unpack_ms"] = cuda_ms(torch, calls["i24_unpack_kernel"])
            res["unpack_plain_ms"] = cuda_ms(torch, lambda: kernels.i24_unpack_plain(w_k), 5, 5)
            res["thunks"] = calls
            n_el = b * n * ch
            res["bounds"] = {"i24_pack": bound(n_el * 7, n_el * 6),
                             "i24_unpack": bound(n_el * 7, n_el * 4)}
        elif shape == I24_SHAPES[-1]:
            res["stream_thunks"] = calls
            n_el = b * n * ch
            res["stream_bounds"] = {"i24_pack": bound(n_el * 7, n_el * 6),
                                    "i24_unpack": bound(n_el * 7, n_el * 4)}
    print(f"kernels i24_pack (transposed view and contiguous) / i24_unpack at {list(I24_SHAPES)} "
          f"(NaN, +-Inf, +-1.0, values past +-1 and rounding ties in each): equal to plain bit "
          f"for bit; at {I24_SHAPES[0]}: i24_pack {res['pack_ms']:.4f} ms vs plain "
          f"{res['pack_plain_ms']:.4f} ms, i24_unpack {res['unpack_ms']:.4f} ms vs plain "
          f"{res['unpack_plain_ms']:.4f} ms")
    return res


def run_batch(ft, torch, name: str, pcm: np.ndarray, profile: int, srate: int, bits: int,
                 fsize: int, dev, after_warm=None, **kw) -> tuple[bytes, np.ndarray, float, float]:
    """Warm-up on a cut of the same track with the same tail frame, then
    (after `after_warm()`, where given: the launch counts' reset) one timed
    batch_encode and batch_decode on the card. Returns (stream,
    decoded PCM, encode wall, decode wall); the decode holds every sample
    (Profile 1 pads the last frame)."""
    enc_kw = {k: v for k, v in kw.items() if k != "i24_transfer"}
    dec_kw = {k: v for k, v in kw.items() if k == "i24_transfer"}
    warm = pcm[: 4 * fsize + len(pcm) % fsize]
    ft.batch_decode(ft.batch_encode(warm, profile, srate, bits, fsize, device=dev, **enc_kw),
                    device=dev, **dec_kw)
    torch.cuda.synchronize()
    if after_warm is not None:
        after_warm()
    stream, t_enc = timed(torch, lambda: ft.batch_encode(pcm, profile, srate, bits, fsize,
                                                         device=dev, **enc_kw))
    (out, sr), t_dec = timed(torch, lambda: ft.batch_decode(stream, device=dev, **dec_kw))
    n_ok = len(out) == len(pcm) if profile in (0, 4) else len(out) >= len(pcm)
    if sr != srate or out.shape[1] != pcm.shape[1] or not n_ok or not np.isfinite(out).all():
        raise AssertionError(f"{name}: decoded {out.shape} at {sr} Hz, expected {pcm.shape} "
                             f"at {srate}, or not finite")
    return stream, np.asarray(out, dtype=np.float64), t_enc, t_dec


def lossless_walls(name: str, frames: int, t_enc: float, t_dec: float) -> str:
    return (f"{name}: {frames} frames, enc {frames / t_enc:.1f} frames/s ({t_enc:.4f} s), "
            f"dec {frames / t_dec:.1f} frames/s ({t_dec:.4f} s)")


def lossless_phase(ft, torch, kernels, native, dev) -> dict:
    """The lossless configurations on the card (see the module docstring).
    Returns the trunc kernels' checks and the launches of the
    p0_stereo_44k1 main run."""
    from frad_python_tpu_torch.models import profile0
    from frad_python_tpu_torch.ops.packing import DEPTHS
    from frad_python_tpu_torch.ops.pcm import to_f64
    from frad_python_tpu_torch.parallel import pipeline
    from frad_python_tpu_torch.parallel.pipeline import _parse_frames

    res = check_trunc_kernels(torch, kernels, dev)
    res["i24"] = check_i24_kernels(torch, kernels, dev)
    pcm = make_audio(SECONDS, SRATE, CHANNELS)
    n_frames = -(-len(pcm) // FSIZE)

    # p0_stereo_44k1: the float32 fast path, then its int24 transfer variant
    warm = pcm[: 4 * FSIZE + len(pcm) % FSIZE]
    ft.batch_decode(ft.batch_encode(warm, 0, SRATE, P0_BITS, FSIZE, device=dev), device=dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    native.reset_calls()
    stream, t_enc = timed(torch, lambda: ft.batch_encode(pcm, 0, SRATE, P0_BITS, FSIZE,
                                                         device=dev))
    (out, sr), t_dec = timed(torch, lambda: ft.batch_decode(stream, device=dev))
    res["launches"] = {k.__name__: k.launches for k in kernels.KERNELS}
    calls = {w.__name__: w.calls for w in native.WRAPPERS}
    headers, payloads, tail = _parse_frames(stream)
    if (len(headers), tail, {h.profile for h in headers}) != (n_frames, b"", {0}) \
            or {h.bit_depth_index for h in headers} != {DEPTHS.index(P0_BITS)}:
        raise AssertionError(f"p0_stereo_44k1: {len(headers)} frames of profiles "
                             f"{ {h.profile for h in headers} }, plan {n_frames}")
    if out.shape != pcm.shape or sr != SRATE or not np.isfinite(out).all():
        raise AssertionError(f"p0_stereo_44k1: decoded {out.shape} at {sr} Hz")
    snr = snr_db(pcm, out)
    if snr < P0_SNR_FLOOR_DB:
        raise AssertionError(f"p0_stereo_44k1 SNR {snr:.4f} dB below {P0_SNR_FLOOR_DB} dB")
    for k in ("trunc_pack", "trunc_unpack"):
        if res["launches"][k] <= 0:
            raise AssertionError(f"kernel {k} was not launched by the p0_stereo_44k1 path")
    for k in ("frame_pack_batch", "frame_parse_batch"):
        if calls[k] <= 0:
            raise AssertionError(f"native {k} was not called by the p0_stereo_44k1 path")
    out_cpu, _ = ft.batch_decode(stream, device="cpu")
    d_cpu = float(np.abs(out_cpu - out).max())
    if d_cpu > LOSSLESS_CARD_VS_CPU_MAX_ABS:
        raise AssertionError(f"p0_stereo_44k1 card vs CPU decode {d_cpu}")
    with FormTally(only=("i24_pack", "i24_unpack")) as i24_forms:
        s24, out24, t_enc24, t_dec24 = run_batch(
            ft, torch, "p0_stereo_44k1 i24", pcm, 0, SRATE, P0_BITS, FSIZE, dev,
            after_warm=kernels.reset_launches, i24_upload=True, i24_transfer=True)
    res["i24"]["launches"] = {k.__name__: k.launches for k in kernels.KERNELS}
    i24_forms.require_held("the p0_stereo_44k1 i24 run")
    snr24 = snr_db(pcm, out24)
    d24 = float(np.abs(out24 - out).max())
    if snr24 < P0_SNR_FLOOR_DB \
            or min(res["i24"]["launches"][k] for k in ("i24_pack", "i24_unpack")) <= 0:
        raise AssertionError(f"p0_stereo_44k1 i24: SNR {snr24:.4f} dB (floor {P0_SNR_FLOOR_DB}), "
                             f"max|i24 - f32 run| {d24}, launches {res['i24']['launches']}")
    print(f"{lossless_walls('p0_stereo_44k1', n_frames, t_enc, t_dec)}, {len(stream)} bytes, "
          f"SNR {snr:.4f} dB (floor {P0_SNR_FLOOR_DB}), card vs cpu decode max|d| {d_cpu} "
          f"(tolerance {LOSSLESS_CARD_VS_CPU_MAX_ABS}); i24 upload/transfer: enc "
          f"{t_enc24:.4f} s, dec {t_dec24:.4f} s, SNR {snr24:.4f} dB, max|i24 - f32 run| {d24}, "
          f"launches {res['i24']['launches']}, forms {sorted(i24_forms.seen.items(), key=str)}; "
          f"launches {res['launches']}, native calls {calls}")

    # p4_mono_44k1: host work only, so the card's stream is the CPU's
    mono = make_audio(SECONDS, SRATE, 1)
    s4, out4, t_enc4, t_dec4 = run_batch(ft, torch, "p4_mono_44k1", mono, 4, SRATE, 16,
                                            FSIZE, dev)
    s4_cpu = ft.batch_encode(mono, 4, SRATE, 16, FSIZE, device="cpu")
    out4_cpu, _ = ft.batch_decode(s4_cpu, device="cpu")
    if s4 != s4_cpu or not np.array_equal(out4, out4_cpu) \
            or not np.array_equal(out4, mono.astype(np.float16).astype(np.float64)):
        raise AssertionError("p4_mono_44k1: the card's stream or decode differs from the CPU's "
                             "or from the f16 values of the input")
    print(f"{lossless_walls('p4_mono_44k1', n_frames, t_enc4, t_dec4)}, {len(s4)} bytes, "
          f"stream equal to the CPU's, decode equal to the CPU's and to the f16 input")

    # p0_stereo_48b / 64b: the float64 FFT form on the card
    for bits in (48, 64):
        s_d, out_d, t_e, t_d = run_batch(ft, torch, f"p0_stereo_{bits}b", pcm, 0, SRATE,
                                            bits, FSIZE, dev)
        s_cpu = ft.batch_encode(pcm, 0, SRATE, bits, FSIZE, device="cpu")
        _, p_card, _ = _parse_frames(s_d)
        _, p_cpu, _ = _parse_frames(s_cpu)
        differ = sum(a != b for a, b in zip(p_card, p_cpu))
        out_c, _ = ft.batch_decode(s_d, device="cpu")
        d = float(np.abs(out_c - out_d).max())
        snr_d = snr_db(pcm, out_d)
        if len(p_card) != len(p_cpu) or d > F64_CARD_VS_CPU_MAX_ABS or snr_d <= DEEP_SNR_DB[bits]:
            raise AssertionError(f"p0_stereo_{bits}b: {len(p_card)} vs {len(p_cpu)} frames, "
                                 f"card vs cpu decode {d}, SNR {snr_d:.2f} dB")
        print(f"{lossless_walls(f'p0_stereo_{bits}b', n_frames, t_e, t_d)}, SNR {snr_d:.2f} dB "
              f"(bound {DEEP_SNR_DB[bits]}), payloads differing from the CPU stream {differ} "
              f"of {len(p_card)}, card vs cpu decode max|d| {d} "
              f"(tolerance {F64_CARD_VS_CPU_MAX_ABS})")

    # hires_96k_8ch, cut to 10 s: N = 8192, the GEMM's largest matrix
    h = HIRES
    hi = make_audio(h["seconds"], h["srate"], h["channels"])
    kernels.reset_launches()
    s_h, out_h, t_eh, t_dh = run_batch(ft, torch, "hires_96k_8ch", hi, 0, h["srate"],
                                          h["bits"], h["fsize"], dev)
    l_h = {k.__name__: k.launches for k in kernels.KERNELS}
    out_hc, _ = ft.batch_decode(s_h, device="cpu")
    snr_h, snr_hc = snr_db(hi, out_h), snr_db(hi, out_hc)
    m = HIRES_FLOOR_FRAMES * h["fsize"]
    snr_hf = snr_db(hi[:m], out_h[:m])
    if snr_hf < HIRES_SNR_FLOOR_DB or snr_h < snr_hc - 0.1 \
            or min(l_h["trunc_pack"], l_h["trunc_unpack"]) <= 0:
        raise AssertionError(f"hires_96k_8ch: SNR {snr_hf:.4f} dB over the first "
                             f"{HIRES_FLOOR_FRAMES} frames (floor {HIRES_SNR_FLOOR_DB}), "
                             f"{snr_h:.4f} dB against the CPU decode's {snr_hc:.4f}, "
                             f"launches {l_h}")
    print(f"{lossless_walls('hires_96k_8ch (cut to 10 s)', -(-len(hi) // h['fsize']), t_eh, t_dh)}"
          f", SNR {snr_hf:.4f} dB over the first {HIRES_FLOOR_FRAMES} frames (floor "
          f"{HIRES_SNR_FLOOR_DB}), {snr_h:.4f} dB over all (CPU decode of the same stream "
          f"{snr_hc:.4f} dB), card vs cpu decode max|d| {float(np.abs(out_hc - out_h).max())}, "
          f"launches {l_h}")

    # Profile 1 above the main path's 2048 samples: at 8192 the DCT GEMM
    # cut along K, at 16384 the float32 FFT form; both kernels
    for fsize, floor in ((P1_MID_FSIZE, P1_MID_SNR_FLOOR_DB),
                         (P1_LONG_FSIZE, P1_LONG_SNR_FLOOR_DB)):
        frames_l, _ = pipeline.plan_frames(len(pcm), fsize, 16, True)
        pq_shape = (2 * (len(frames_l) - 1), fsize)
        res[f"p1_{fsize}"] = long_kernels(torch, kernels, dev, pq_shape,
                                          (len(frames_l), CHANNELS, fsize), fsize // 16)
        kernels.reset_launches()
        s_l, out_l, t_el, t_dl = run_batch(ft, torch, f"p1_{fsize}", pcm, 1, SRATE, BITS,
                                              fsize, dev, i16_upload=True)
        l_l = {k.__name__: k.launches for k in kernels.KERNELS}
        snr_l = snr_db(pcm, out_l)
        if snr_l < floor or min(l_l["power_quant"], l_l["overlap_add"]) <= 0:
            raise AssertionError(f"Profile 1 at {fsize}: SNR {snr_l:.4f} dB (floor {floor}), "
                                 f"launches {l_l}")
        print(f"{lossless_walls(f'p1 at {fsize} samples', len(frames_l), t_el, t_dl)}, "
              f"SNR {snr_l:.4f} dB (floor {floor}), launches {l_l}")

    # the p0_stereo_44k1 track as s32le bytes through the push engines
    raw = to_s32le(pcm)
    pcm32 = to_f64(np.frombuffer(raw, "<i4").reshape(-1, CHANNELS), np.dtype("<i4"))
    batch32 = ft.batch_encode(pcm32, 0, SRATE, P0_BITS, FSIZE, device=dev)
    warm_raw = raw[: (4 * FSIZE + 1000) * CHANNELS * 4]
    stream_decode(ft, torch, stream_encode_p0(ft, torch, warm_raw, PUSH, dev), PUSH, dev)
    kernels.reset_launches()
    with FrameTally(pipeline, profile0, hop=FSIZE, olap=0) as enc_t:
        s_s, t_se = timed(torch, lambda: stream_encode_p0(ft, torch, raw, PUSH, dev))
    with FrameTally(pipeline, profile0, hop=FSIZE, olap=0) as dec_t:
        (out_s, ttfa), t_sd = timed(torch, lambda: stream_decode(ft, torch, s_s, PUSH, dev))
    l_s = {k.__name__: k.launches for k in kernels.KERNELS}
    _, p_s, tail_s = _parse_frames(s_s)
    _, p_b, _ = _parse_frames(batch32)
    differ = sum(a != b for a, b in zip(p_s, p_b))
    out_b, _ = ft.batch_decode(s_s, device=dev)
    d_sb = float(np.abs(out_s - out_b).max()) if out_s.shape == out_b.shape else np.inf
    snr_s = snr_db(pcm32, out_s)
    if len(p_s) != len(p_b) or tail_s or d_sb > STREAM_VS_BATCH_MAX_ABS \
            or snr_s < P0_SNR_FLOOR_DB or min(l_s["trunc_pack"], l_s["trunc_unpack"]) <= 0:
        raise AssertionError(f"lossless streaming: {len(p_s)} vs {len(p_b)} frames, stream vs "
                             f"batch decode {d_sb}, SNR {snr_s:.4f} dB, launches {l_s}")
    print(f"stream p0_stereo_44k1 s32le: enc {PUSH}-byte pushes {t_se:.3f} s "
          f"({n_frames / t_se:.1f} frames/s), dec {PUSH}-byte pushes {t_sd:.3f} s "
          f"({n_frames / t_sd:.1f} frames/s, first audio after {ttfa * 1e3:.2f} ms); payloads "
          f"differing from the batch stream {differ} of {len(p_s)}; max|stream - batch| {d_sb} "
          f"(tolerance {STREAM_VS_BATCH_MAX_ABS}), SNR {snr_s:.4f} dB; frames per call: enc "
          f"{enc_t.used()}, dec {dec_t.used()}; launches {l_s}")
    return res


def long_kernels(torch, kernels, dev, pq_shape, oa_shape, olap: int) -> dict:
    """power_quant and overlap_add against their plain versions at the
    shapes of Profile 1 with oa_shape[2]-sample frames; CUDA-event times."""
    from frad_python_tpu_torch.kernels.overlap_add import crossfade_window

    rng = np.random.default_rng(777)
    freqs = torch.from_numpy((rng.standard_normal(pq_shape) * 1e-2).astype(np.float32)).to(dev)
    div = np.exp(rng.standard_normal(pq_shape) * 2.0) * 0.1
    div[:, -pq_shape[1] // 16:] = 0.0
    div = torch.from_numpy(div.astype(np.float32)).to(dev)
    pcm = torch.from_numpy(rng.standard_normal(oa_shape).astype(np.float32) * 0.3).to(dev)
    w = crossfade_window(olap, dev)
    cut = oa_shape[2] - olap
    got, want = kernels.power_quant(freqs, div, 2.0 ** 15), kernels.power_quant_plain(
        freqs, div, 2.0 ** 15)
    o_k, f_k = kernels.overlap_add(pcm, w, cut, True)
    o_p, f_p = kernels.overlap_add_plain(pcm, w, cut, True)
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(o_k, o_p) and torch.equal(f_k, f_p)):
        raise AssertionError(f"power_quant {pq_shape} or overlap_add {oa_shape} differs from "
                             "its plain version")
    out = {"pq_shape": pq_shape, "oa_shape": oa_shape,
           "pq_ms": cuda_ms(torch, lambda: kernels.power_quant(freqs, div, 2.0 ** 15)),
           "pq_plain_ms": cuda_ms(torch, lambda: kernels.power_quant_plain(freqs, div, 2.0 ** 15)),
           "oa_ms": cuda_ms(torch, lambda: kernels.overlap_add(pcm, w, cut, True)),
           "oa_plain_ms": cuda_ms(torch, lambda: kernels.overlap_add_plain(pcm, w, cut, True))}
    print(f"kernels at Profile 1 N={oa_shape[2]}: power_quant {pq_shape} equal, "
          f"{out['pq_ms']:.4f} ms vs plain {out['pq_plain_ms']:.4f} ms; overlap_add {oa_shape} "
          f"olap={olap} i16 equal, {out['oa_ms']:.4f} ms vs plain {out['oa_plain_ms']:.4f} ms")
    return out


def tns_inputs(lanes: int, n: int, dtype: str, seed: int):
    """(x [lanes, n], coeffs [lanes, 13], ac [lanes, 13]) for the TNS
    kernels. Lanes cycle through: an active stable filter (quantised
    coefficients with sum |a| < 1) on a spectrum-like x; a bypass
    ([1, 0, ...]); a dead lane (zero spectrum, zero autocorrelation); a
    tonal lane (autocorrelation of a slow cosine: the first reflection
    clamps at 0.96); a lane whose output passes 1e6 (a = [1, -1, 0, ...]
    summing x of size 1e5); a lane of lags 1.1e-10 * [1, 1, 2, 1, ...],
    whose first two reflections clamp at -0.96 and whose prediction error
    then falls under 1e-12 (the freeze: coefficients 3.. stay 0); and raw
    random lags."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((lanes, n)) * np.exp(rng.standard_normal((lanes, 1)))
    q = np.zeros((lanes, 13))
    q[:, 1] = rng.integers(-7, 8, lanes)
    q[:, 2] = rng.integers(-3, 4, lanes)
    q[:, 3:6] = rng.integers(-1, 2, (lanes, 3))
    coeffs = q / 15.0
    lag = np.arange(13)
    sig = rng.standard_normal((lanes, 256))
    sig = np.cumsum(sig, axis=1) * 0.2 + sig
    sig /= np.linalg.norm(sig, axis=1, keepdims=True)
    ac = np.stack([(sig[:, :256 - l] * sig[:, l:]).sum(1) for l in lag], axis=1)
    kind = np.arange(lanes) % 7
    coeffs[kind == 1, 1:] = 0.0
    x[kind == 2] = 0.0
    ac[kind == 2] = 0.0
    ac[kind == 3] = np.cos(0.01 * lag) * np.exp(-0.5 * (0.01 * lag) ** 2)
    coeffs[kind == 4, 1:] = 0.0
    coeffs[kind == 4, 1] = -1.0
    x[kind == 4] = rng.standard_normal((int((kind == 4).sum()), n)) * 1e5
    ac[kind == 5] = 1.1e-10
    ac[kind == 5, 2] = 2.2e-10
    ac[kind == 6] = rng.standard_normal((int((kind == 6).sum()), 13))
    coeffs[:, 0] = 1.0
    return tuple(np.ascontiguousarray(a, dtype=dtype) for a in (x, coeffs, ac))


def bits_equal(torch, a, b) -> bool:
    """Equal bit for bit (a NaN equals the same NaN, -0 differs from +0)."""
    it = {4: torch.int32, 8: torch.int64, 2: torch.int16}[a.element_size()]
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(it), b.view(it))


def check_tns_kernels(torch, kernels, dev) -> dict:
    """tns_iir against its plain version, bit for bit, at TNS_SHAPES,
    float32 and float64, and tns_fir_gate likewise on the same rows with
    `tns_inputs`' lags and every gate true (the Levinson recursion's dead,
    clamped and frozen lanes, reached through the plain recursion on the
    card); power_quant at
    P2_POWER_QUANT_FORMS and overlap_add at P2_OVERLAP_FORMS likewise:
    every form the Profile 2 and float64 runs launch. CUDA-event times of
    the kernels; of the plain versions at the main path's shape (the plain
    IIR, a Python loop over time, with one call, at float32 only)."""
    from frad_python_tpu_torch.kernels.overlap_add import crossfade_window

    res = {"iir_err": 0.0, "pq_err": 0.0, "oa_err": 0.0, "thunks": {},
           "stream_thunks": {}, "bounds": {}, "stream_bounds": {}}
    for dtype, shapes in TNS_SHAPES.items():
        for si, (lanes, n) in enumerate(shapes):
            x, coeffs, ac = (torch.from_numpy(a).to(dev)
                             for a in tns_inputs(lanes, n, dtype, 31 + lanes))
            (y_k,), (y_p,) = held(kernels, "tns_iir", x, coeffs)
            every = torch.ones(lanes, dtype=torch.bool, device=dev)
            got_f, want_f = held(kernels, "tns_fir_gate", x, ac, every)
            l_k = kernels.tns_levinson_plain(ac)
            torch.cuda.synchronize()
            kind = torch.arange(lanes, device=dev) % 7
            d_iir = float((y_k - y_p).abs().nan_to_num(float("inf")).max())
            res["iir_err"] = max(res["iir_err"], d_iir)
            if not bits_equal(torch, y_k, y_p):
                raise AssertionError(f"tns_iir {(lanes, n)} {dtype} differs from its plain "
                                     f"version: max |d| {d_iir}")
            if not (bits_equal(torch, got_f[0], want_f[0]) and bits_equal(torch, got_f[1], want_f[1])
                    and torch.equal(got_f[2], want_f[2])):
                raise AssertionError(f"tns_fir_gate {(lanes, n)} {dtype} on the recursion's "
                                     f"lanes differs from its plain version: "
                                     f"{ulp_report(torch, got_f[0], want_f[0])}")
            # lanes of every kind from 7 lanes on; fewer hold the first kinds
            peak = y_k[kind == 4].abs().amax(dim=-1)
            unit = torch.zeros(13, dtype=l_k.dtype, device=dev)
            unit[0] = 1.0
            if not (bits_equal(torch, y_k[kind == 1], x[kind == 1])
                    and bool(torch.isfinite(y_k).all()) and bool((peak > 1e6).all())
                    and bool((l_k[kind == 2] == unit).all())
                    and bool((l_k[kind == 5][:, 2] == torch.tensor(-0.96, dtype=l_k.dtype)).all())
                    and bool((l_k[kind == 5][:, 3:] == 0).all())):
                raise AssertionError(f"TNS kernel inputs {(lanes, n)} {dtype} miss a case: "
                                     f"bypass, blow-up {peak.tolist()[:3]}, dead, clamp or freeze")
            t = {"iir": cuda_ms(torch, lambda: kernels.tns_iir(x, coeffs))}
            line = (f"kernels tns_iir {(lanes, n)} / tns_fir_gate on the recursion's lanes "
                    f"{dtype}: equal bit for bit (TNS runs on {int(got_f[2].sum())} of {lanes} "
                    f"rows), tns_iir {t['iir']:.4f} ms")
            if si == 0 and dtype == "float32":
                t["iir_plain"] = cuda_ms(torch, lambda: kernels.tns_iir_plain(x, coeffs), 1, 1)
                line += f" vs plain {t['iir_plain']:.1f} ms"
                res["thunks"] = {"tns_iir_kernel": lambda x=x, c=coeffs: kernels.tns_iir(x, c)}
                res["bounds"] = tns_bounds(lanes, n)
            if (lanes, dtype) == (8, "float32"):
                res["stream_thunks"] = {"tns_iir_kernel": lambda x=x, c=coeffs: kernels.tns_iir(x, c)}
                res["stream_bounds"] = tns_bounds(lanes, n)
            res[(lanes, dtype)] = t
            print(line)

    # power_quant without a divisor and at float64, overlap_add at float64
    rng = np.random.default_rng(2468)
    for dtype, with_div, shapes in P2_POWER_QUANT_FORMS:
        for si, shape in enumerate(shapes):
            freqs = rng.standard_normal(shape) * 1e-2
            div = np.exp(rng.standard_normal(shape) * 2.0) * 0.1
            div[:, -shape[1] // 16:] = 0.0
            # no divisor: the spectrum as Profile 2 hands it over, divided
            fv = torch.from_numpy((freqs if with_div else freqs * 30.0).astype(dtype)).to(dev)
            dv = torch.from_numpy(div.astype(dtype)).to(dev) if with_div else None
            (got,), (want,) = held(kernels, "power_quant", fv, dv, 2.0 ** 15)
            torch.cuda.synchronize()
            err = float((got.to(torch.int64) - want.to(torch.int64)).abs().max())
            res["pq_err"] = max(res["pq_err"], err)
            if not bits_equal(torch, got, want) or int(got.abs().max()) < 1000:
                raise AssertionError(f"power_quant {shape} {dtype} divisor={with_div} differs "
                                     f"from its plain version: max |d| {err}")
            if si == 0:
                res[f"pq_{'div' if with_div else 'nodiv'}_{dtype}"] = (
                    cuda_ms(torch, lambda: kernels.power_quant(fv, dv, 2.0 ** 15)),
                    cuda_ms(torch, lambda: kernels.power_quant_plain(fv, dv, 2.0 ** 15)))
    for dtype, shape, olap, i16 in P2_OVERLAP_FORMS:
        pcm_k = torch.from_numpy((rng.standard_normal(shape) * 0.3).astype(dtype)).to(dev)
        w = crossfade_window(olap, dev, pcm_k.dtype)
        cut = shape[2] - olap
        (o_k, f_k), (o_p, f_p) = held(kernels, "overlap_add", pcm_k, w, cut, i16)
        torch.cuda.synchronize()
        err = max(float((o_k.double() - o_p.double()).abs().max()),
                  float((f_k - f_p).abs().max()))
        res["oa_err"] = max(res["oa_err"], err)
        if not (bits_equal(torch, o_k, o_p) and bits_equal(torch, f_k, f_p)
                and f_k.dtype == pcm_k.dtype):
            raise AssertionError(f"overlap_add {shape} {dtype} olap={olap} i16={i16} differs "
                                 f"from its plain version: max |d| {err}")
        if "oa_f64" not in res:
            res["oa_f64"] = (
                cuda_ms(torch, lambda: kernels.overlap_add(pcm_k, w, cut, i16)),
                cuda_ms(torch, lambda: kernels.overlap_add_plain(pcm_k, w, cut, i16)))
    shape = P2_POWER_QUANT_FORMS[0][2][0]
    print(f"kernels power_quant at {[f[:2] + (list(f[2]),) for f in P2_POWER_QUANT_FORMS]} and "
          f"overlap_add at {list(P2_OVERLAP_FORMS)}: all equal bit for bit; power_quant {shape} "
          f"no divisor f32 {res['pq_nodiv_float32'][0]:.4f} ms vs plain "
          f"{res['pq_nodiv_float32'][1]:.4f} ms, f64 {res['pq_nodiv_float64'][0]:.4f} vs "
          f"{res['pq_nodiv_float64'][1]:.4f} ms, f64 with divisor {res['pq_div_float64'][0]:.4f} "
          f"vs {res['pq_div_float64'][1]:.4f} ms; overlap_add {P2_OVERLAP_FORMS[0][1]} f64 emit "
          f"{res['oa_f64'][0]:.4f} vs {res['oa_f64'][1]:.4f} ms")
    return res


def egr_inputs(rows: int, m: int, seed: int) -> np.ndarray:
    """[rows, m] int32 symbol frames: Laplace rows of several scales, with
    a row of zeros (k = 0, every code one bit), a row whose only non-zero
    symbol is 1, the extremes -2^23 and 2^23 - 1, and from three rows on a
    row of wide symbols that overflows max_words in the middle."""
    rng = np.random.default_rng(seed)
    s = np.rint(rng.laplace(0, 1, (rows, m)) * np.exp(rng.standard_normal((rows, 1)) * 1.5 + 1))
    s[0] = 0
    s[1] = 0
    s[1, m // 3] = 1
    if rows > 2:
        s[2] = rng.integers(-(1 << 22), 1 << 22, m)
        s[-1, 0], s[-1, -1] = -(1 << 23), (1 << 23) - 1
    return s.astype(np.int32)


def check_egr_dequant(torch, kernels, dev) -> dict:
    """egr_pack at EGR_FORMS and dequant at DEQUANT_FORMS against their
    plain versions on the card. egr_pack: the compacted words, used,
    total_bits, k and overflow equal on every row, the padded words on
    every row that does not overflow. dequant: equal bit for bit; were it
    not, the count of differing elements and their distance in ulps is
    printed before the failure. CUDA-event times of both at the main
    path's forms, a call of each there (`thunks`), and each one's bound
    from the sizes of those inputs."""
    res = {"egr_err": 0, "deq_err": 0.0, "thunks": {}, "stream_thunks": {}, "bounds": {},
           "stream_bounds": {}}
    for fi, (rows, m) in enumerate(EGR_FORMS):
        max_words = max(m * 12 // 32, 16)
        sym = torch.from_numpy(egr_inputs(rows, m, 500 + fi)).to(dev)
        got, want = held(kernels, "egr_pack", sym, max_words)
        got_w = kernels.egr_pack(sym, max_words, True)[5]
        want_w = kernels.egr_pack_plain(sym, max_words, True)[5]
        torch.cuda.synchronize()
        keep = want[4] == 0
        names = ("flat", "used", "total_bits", "k", "overflow")
        bad = [n for n, g, w in zip(names, got, want)
               if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w)]
        if not torch.equal(got_w[keep], want_w[keep]):
            bad.append("words")
        if bad or (rows > 2 and int(want[4][2]) != 1) or bool(want[4][:2].any()):
            res["egr_err"] = 1
            raise AssertionError(f"egr_pack {(rows, m)} differs from its plain version in "
                                 f"{bad}; overflow rows {int((~keep).sum())}")
        egr_bound = bound(sym.numel() * 4 + got[0].numel() * 4 + 4 * rows * 4,
                          sym.numel() * 14, "int32")
        if fi == 0:
            res["egr_ms"] = cuda_ms(torch, lambda: kernels.egr_pack(sym, max_words))
            res["egr_plain_ms"] = cuda_ms(torch, lambda: kernels.egr_pack_plain(sym, max_words),
                                          5, 5)
            res["thunks"]["egr_"] = lambda sym=sym, mw=max_words: kernels.egr_pack(sym, mw)
            res["bounds"]["egr_pack"] = egr_bound
            res["egr_words"] = int(got[0].numel())
        elif (rows, m) == (4, 4096):
            res["stream_thunks"]["egr_"] = lambda sym=sym, mw=max_words: kernels.egr_pack(sym, mw)
            res["stream_bounds"]["egr_pack"] = egr_bound
            res["egr_ms_4"] = cuda_ms(torch, lambda: kernels.egr_pack(sym, max_words))
            res["egr_plain_ms_4"] = cuda_ms(
                torch, lambda: kernels.egr_pack_plain(sym, max_words), 5, 5)
    # rows of k = 31, 30, 29 and 28: the kernels code a row of k > 29 with
    # 64-bit values. At 12 bits a symbol such rows overflow and are not
    # packed, so this form gives them the words they need
    wide = np.random.default_rng(555).integers(-2 ** 31, 2 ** 31, (4, 200), dtype=np.int64)
    wide[0, 0] = -2 ** 31
    wide >>= np.arange(4)[:, None]
    sym = torch.from_numpy(wide.astype(np.int32)).to(dev)
    got, want = (kernels.egr_pack(sym, EGR_WIDE_WORDS, True),
                 kernels.egr_pack_plain(sym, EGR_WIDE_WORDS, True))
    torch.cuda.synchronize()
    if want[3].tolist() != [31, 30, 29, 28] or bool(want[4].any()) \
            or not all(g.shape == w.shape and torch.equal(g, w) for g, w in zip(got, want)):
        res["egr_err"] = 1
        raise AssertionError(f"egr_pack {tuple(sym.shape)} of full-range symbols differs from "
                             f"its plain version; k {want[3].tolist()}")
    # more rows than a pack block sums `used` over: the scan launch's path
    rows, m = EGR_MANY_ROWS
    sym = torch.from_numpy(egr_inputs(rows, m, 556)).to(dev)
    got, want = kernels.egr_pack(sym, 24, True), kernels.egr_pack_plain(sym, 24, True)
    torch.cuda.synchronize()
    keep = want[4] == 0
    if not all(g.shape == w.shape and torch.equal(g, w) for g, w in zip(got[:5], want[:5])) \
            or not torch.equal(got[5][keep], want[5][keep]):
        res["egr_err"] = 1
        raise AssertionError(f"egr_pack {EGR_MANY_ROWS} differs from its plain version")
    print(f"kernel egr_pack at {list(EGR_FORMS)} (zero, dmax = 1, extreme and overflowing rows "
          f"in each): equal to plain word for word; {EGR_FORMS[0]} {res['egr_ms']:.4f} ms vs "
          f"plain {res['egr_plain_ms']:.4f} ms ({res['egr_words']} words compacted: "
          f"{res['egr_words'] * 4} bytes to copy back as int32, {res['egr_words'] * 8} as the "
          f"plain version's int64); (4, 4096) {res['egr_ms_4']:.4f} vs "
          f"{res['egr_plain_ms_4']:.4f} ms")

    rng = np.random.default_rng(600)

    def dequant_held(s_d, t_d, factor):
        (got,), (want,) = held(kernels, "dequant", s_d, t_d, factor, SRATE)
        torch.cuda.synchronize()
        if not bits_equal(torch, got, want.contiguous()):
            res["deq_err"] = max_abs(torch, got, want)
            raise AssertionError(
                f"dequant {s_d.dtype} {tuple(s_d.shape)} thresholds={t_d is not None} "
                f"factor={factor} aligned={s_d.data_ptr() % 16 == 0} differs from its plain "
                f"version: {ulp_report(torch, got, want)} (max |d| {res['deq_err']})")

    for fi, (dtype, shape, with_thres) in enumerate(DEQUANT_FORMS):
        s_d, t_d = dequant_inputs(torch, rng, dtype, shape, dev)
        t_d = t_d if with_thres else None
        for factor in (2.0 ** 15, 2.0 ** 23):
            dequant_held(s_d, t_d, factor)
        deq_bound = dequant_bound(s_d, t_d)
        if fi == 0 or (dtype, shape) == ("int16", (4, 2048, 2)) and with_thres:
            key = "deq" if fi == 0 else "deq_4"
            res[f"{key}_ms"] = cuda_ms(torch, lambda: kernels.dequant(s_d, t_d, 2.0 ** 15, SRATE))
            res[f"{key}_plain_ms"] = cuda_ms(
                torch, lambda: kernels.dequant_plain(s_d, t_d, 2.0 ** 15, SRATE))
        if (dtype, shape) == ("int16", (4, 2048, 2)) and with_thres:
            res["stream_thunks"]["dequant_kernel"] = \
                lambda s=s_d, t=t_d: kernels.dequant(s, t, 2.0 ** 15, SRATE)
            res["stream_bounds"]["dequant"] = deq_bound
        if fi == 0:
            res["thunks"]["dequant_kernel"] = \
                lambda s=s_d, t=t_d: kernels.dequant(s, t, 2.0 ** 15, SRATE)
            res["bounds"]["dequant"] = deq_bound
    for dtype, shape in DEQUANT_EDGE_FORMS:
        s_d, t_d = dequant_inputs(torch, rng, dtype, shape, dev)
        for x, t in ((s_d, t_d), (offset_view(torch, s_d), offset_view(torch, t_d))):
            for thres in (t, None):
                dequant_held(x, thres, 2.0 ** 15)
    print(f"kernel dequant at {list(DEQUANT_EDGE_FORMS)}, with and without threshold symbols, "
          f"each also on storage not 16-byte aligned: equal to plain bit for bit")
    print(f"kernel dequant at {len(DEQUANT_FORMS)} forms {list(DEQUANT_FORMS)}, factors 2^15 "
          f"and 2^23 (zeros, signs and the int16 extremes in each; threshold symbols of both "
          f"signs): equal to plain bit for bit; {DEQUANT_FORMS[0]} {res['deq_ms']:.4f} ms vs "
          f"plain {res['deq_plain_ms']:.4f} ms; (4, 2048, 2) {res['deq_4_ms']:.4f} vs "
          f"{res['deq_4_plain_ms']:.4f} ms")
    return res


def dequant_inputs(torch, rng, dtype: str, shape: tuple[int, int, int], dev):
    """(symbols [B, N, C] of `dtype`, threshold symbols [B, 27, C] in the
    compute dtype) on `dev`: Laplace symbols with zeros, signs and the int16
    extremes in frame 0 (float symbols also magnitudes that are not
    integers: no table entry), threshold symbols of both signs."""
    b, n, c = shape
    edges = [0, -0.0, 1, -1, 2, -3, 32767, -32768]
    sym = np.rint(rng.laplace(0, 20, shape))
    sym[0, :len(edges), 0] = edges
    if dtype != "int16":
        sym[0, len(edges):len(edges) + 4, 0] = (0.5, -2.25, 255.5, -300.75)
    thres = np.rint(rng.laplace(0, 6, (b, 27, c)))
    thres[0, :4, 0] = (0, -0.0, 1, -1)
    compute = "float64" if dtype == "float64" else "float32"
    return (torch.from_numpy(sym.astype(dtype)).to(dev),
            torch.from_numpy(thres.astype(compute)).to(dev))


def dequant_bound(symbols, thres) -> tuple[float, str]:
    """dequant's bound on symbols [B, N, C] and threshold symbols [B, 27, C]
    (or None): the symbols read and the output written once, and with
    thresholds those and the per-bin tables (a band byte and two weights a
    bin); a power (~40 operations) and the scale a value, and with
    thresholds three operations a value for the divisor and ~50 a
    threshold."""
    n = symbols.shape[1]
    n_el = symbols.numel()
    item = 8 if symbols.element_size() == 8 else 4          # the compute dtype's
    nbytes = n_el * symbols.element_size() + n_el * item
    ops = n_el * 41
    if thres is not None:
        nbytes += thres.numel() * item + n * (1 + 2 * item)
        ops += n_el * 4 + thres.numel() * 50
    return bound(nbytes, ops, "float64" if item == 8 else "float32")


def ulp_report(torch, got, want) -> str:
    """How far two float tensors of one dtype are apart: differing elements
    and their largest distance in units of the last place."""
    it = torch.int64 if got.element_size() == 8 else torch.int32
    d = (got.contiguous().view(it).to(torch.int64)
         - want.contiguous().view(it).to(torch.int64)).abs()
    return (f"{int((d != 0).sum())} of {got.numel()} elements differ, by at most "
            f"{int(d.max())} ulp")


def max_abs(torch, a, b) -> float:
    return float((a.double() - b.double()).abs().nan_to_num(0.0, posinf=float("inf")).max()) \
        if a.numel() else 0.0


def mask_thres_inputs(rows: int, n: int, dtype: str, seed: int) -> np.ndarray:
    """Spectra [rows, n] whose thresholds meet every case of the chain:
    rows scaled over 16 decades, so that thresholds fall on both sides of
    the AHT floor and of the clamp at 1 and symbols reach past 20; the
    first row's first band all zero (a band sum of 0: the floor); the bins
    past the active bands are there as in every row."""
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.uniform(-13.0, 3.0, (rows, 1))
    x = rng.standard_normal((rows, n)) * scale
    x[0, : max(1, n // 64)] = 0.0
    return x.astype(dtype)


def thres_chain_cases(torch, x, srate: int, loss: float) -> dict:
    """Which cases the plain chain meets on spectra x: thresholds on the
    AHT floor, under 1 (clamped), symbols past 20 and 0, and bands past the
    active ones."""
    from frad_python_tpu_torch.kernels.mask_thres import band_sums_plain, thres_quant_plain
    from frad_python_tpu_torch.ops import psycho

    k = psycho.device_consts(x.shape[1], srate, x.device, x.dtype)
    a = torch.abs(x) * 2.0 ** 15
    th = psycho.thres_from_sums(band_sums_plain(a * a, k), k["inv_w"], k["aht"], k["nb"], loss)
    tq = thres_quant_plain(th)
    act = th[:, :k["nb"]]
    return {"floor": bool((act == k["aht"][:k["nb"]] * loss).any()),
            "clamp": bool((act < 1).any()), "large": bool((tq > 20).any()),
            "zero": bool((tq == 0).any()), "past": k["nb"] < psycho.SUBBANDS}


def check_thres_kernels(torch, kernels, dev) -> dict:
    """mask_thres at MASK_THRES_FORMS and thres_expand at THRES_EXPAND_FORMS
    against their plain versions on the card, bit for bit (were they not,
    the count of differing elements and their distance in ulps is in the
    failure). mask_thres on `mask_thres_inputs` at two loss levels;
    thres_expand on symbols of both signs, zeros included. CUDA-event
    times at the main path's forms and at the streaming engines' (8 rows,
    4 frames), a call of each there (`thunks`) and each one's bound."""
    from frad_python_tpu_torch.ops import psycho

    res = {"mt_err": 0.0, "te_err": 0.0, "thunks": {}, "stream_thunks": {}, "bounds": {},
           "stream_bounds": {}}
    met = set()
    factor = 2.0 ** 15
    for fi, (dtype, rows, n, ch) in enumerate(MASK_THRES_FORMS):
        x = torch.from_numpy(mask_thres_inputs(rows, n, dtype, 700 + fi)).to(dev)
        for loss in (0.5, 1.8329800000000002):
            args = (x, factor, loss, SRATE, ch)
            (div_k, tq_k), (div_p, tq_p) = held(kernels, "mask_thres", *args)
            torch.cuda.synchronize()
            res["mt_err"] = max(res["mt_err"], max_abs(torch, div_k, div_p),
                                max_abs(torch, tq_k, tq_p))
            if not (bits_equal(torch, div_k, div_p) and tq_k.dtype == tq_p.dtype
                    and torch.equal(tq_k, tq_p)):
                raise AssertionError(
                    f"mask_thres {dtype} {(rows, n)} loss={loss} differs from its plain "
                    f"version: div {ulp_report(torch, div_k, div_p)}, "
                    f"{int((tq_k != tq_p).sum())} of {tq_k.numel()} symbols differ")
            met |= {c for c, hit in thres_chain_cases(torch, x, SRATE, loss).items()
                    if hit}
        item = x.element_size()
        mt_bound = bound(2 * rows * n * item + rows * psycho.SUBBANDS * (8 if item == 8 else 4),
                         rows * n * 6 + rows * psycho.SUBBANDS * 60, dtype)
        key = {(POWER_QUANT_SHAPE[0], FSIZE, "float32"): "mt",
               (8, FSIZE, "float32"): "mt_4"}.get((rows, n, dtype))
        if key:
            args = (x, factor, 0.5, SRATE, ch)
            res[f"{key}_ms"] = cuda_ms(torch, lambda: kernels.mask_thres(*args))
            res[f"{key}_plain_ms"] = cuda_ms(torch, lambda: kernels.mask_thres_plain(*args))
            which = "thunks" if key == "mt" else "stream_thunks"
            res[which]["mask_thres_kernel"] = lambda a=args: kernels.mask_thres(*a)
            res["bounds" if key == "mt" else "stream_bounds"]["mask_thres"] = mt_bound
    missed = {"floor", "clamp", "large", "zero", "past"} - met
    if missed:
        raise AssertionError(f"mask_thres inputs miss cases: {sorted(missed)}")
    print(f"kernel mask_thres at {len(MASK_THRES_FORMS)} forms {list(MASK_THRES_FORMS)}, two "
          f"loss levels each: divisor and symbols equal to plain bit for bit; "
          f"{MASK_THRES_FORMS[0][:3]} {res['mt_ms']:.4f} ms vs plain {res['mt_plain_ms']:.4f} "
          f"ms; 8 rows {res['mt_4_ms']:.4f} vs {res['mt_4_plain_ms']:.4f} ms")

    rng = np.random.default_rng(701)
    for dtype, b, n, ch in THRES_EXPAND_FORMS:
        sym = np.rint(rng.laplace(0, 6, (b, psycho.SUBBANDS, ch)))
        sym[0, :4, 0] = (0, -0.0, 1, -1)
        t_d = torch.from_numpy(sym.astype(dtype)).to(dev)
        (got,), (want,) = held(kernels, "thres_expand", t_d, n, SRATE)
        torch.cuda.synchronize()
        res["te_err"] = max(res["te_err"], max_abs(torch, got, want))
        if not bits_equal(torch, got, want):
            raise AssertionError(f"thres_expand {dtype} {tuple(t_d.shape)} n={n} differs from "
                                 f"its plain version: {ulp_report(torch, got, want)}")
        key = {(OVERLAP_SHAPE[0], FSIZE, "float32", CHANNELS): "te",
               (4, FSIZE, "float32", CHANNELS): "te_4"}.get((b, n, dtype, ch))
        if key:
            res[f"{key}_ms"] = cuda_ms(torch, lambda: kernels.thres_expand(t_d, n, SRATE))
            res[f"{key}_plain_ms"] = cuda_ms(
                torch, lambda: kernels.thres_expand_plain(t_d, n, SRATE))
            te_bound = bound(t_d.numel() * t_d.element_size() + b * ch * n * t_d.element_size(),
                             b * ch * n * 6 + t_d.numel() * 50, dtype)
            which = "thunks" if key == "te" else "stream_thunks"
            res[which]["thres_expand_kernel"] = \
                lambda t=t_d, n=n: kernels.thres_expand(t, n, SRATE)
            res["bounds" if key == "te" else "stream_bounds"]["thres_expand"] = te_bound
    print(f"kernel thres_expand at {len(THRES_EXPAND_FORMS)} forms {list(THRES_EXPAND_FORMS)} "
          f"(zeros and both signs in each): divisor equal to plain bit for bit; "
          f"{OVERLAP_SHAPE[0]} frames {res['te_ms']:.4f} ms vs plain {res['te_plain_ms']:.4f} "
          f"ms; 4 frames {res['te_4_ms']:.4f} vs {res['te_4_plain_ms']:.4f} ms")
    return res


#: what a lossy batch call's trace may show around its threshold chain: the
#: kernels that may follow mask_thres in an encode
AFTER_MASK_THRES = ("power_quant", "tns_autocorr")


def gemm_kernel(name: str) -> bool:
    """A cuBLAS GEMM or GEMV kernel, by its name in a trace."""
    low = name.lower()
    return "gemm" in low or "gemv" in low or "splitkreduce" in low


def traced_kernels(torch, fn) -> list[str]:
    """The device kernels of one call of `fn`, in the order they ran, from
    one `torch.profiler` call (copies and memsets left out; a lead kernel
    of no interest may come first)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    lead = torch.zeros(1, device=DEVICE)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        lead.add_(1)         # a trace can miss its first kernel: let that be this one
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                     and not e.name.startswith(("Memcpy", "Memset"))),
                    key=lambda e: e.time_range.start)
    return [e.name for e in events]


def gemm_calls(names: list[str]) -> int:
    """GEMMs in a trace: runs of consecutive GEMM kernels (cuBLAS may close
    a GEMM with a split-K reduction)."""
    return sum(gemm_kernel(n) and (i == 0 or not gemm_kernel(names[i - 1]))
               for i, n in enumerate(names))


def threshold_chain_fault(enc: list[str], dec: list[str], profile: int) -> str:
    """What is wrong with the kernels (by name, in order) of one lossy
    batch_encode and one batch_decode call of `profile`, or "": in the
    encode each mask_thres launch directly follows a GEMM (the DCT's) and
    is directly followed by power_quant or tns_autocorr, and no other GEMM
    runs; a Profile 1 decode launches no thres_expand (dequant expands the
    thresholds) and each of its GEMMs (the IDCT's) directly follows a
    dequant launch; a Profile 2 decode runs as many GEMMs as thres_expand
    launches."""
    mt = [i for i, n in enumerate(enc) if "mask_thres" in n]
    if not mt or gemm_calls(enc) != len(mt) or any(
            not gemm_kernel(enc[i - 1]) or i + 1 >= len(enc)
            or not any(k in enc[i + 1] for k in AFTER_MASK_THRES) for i in mt):
        return f"the encode's kernels around the threshold chain are {short_names(enc)}"
    te = sum("thres_expand" in n for n in dec)
    if profile == 1:
        starts = [i for i, n in enumerate(dec)
                  if gemm_kernel(n) and (i == 0 or not gemm_kernel(dec[i - 1]))]
        if te or not starts or any(i == 0 or "dequant" not in dec[i - 1] for i in starts):
            return (f"the decode ran {te} thres_expand launches and {len(starts)} GEMMs, each "
                    f"to follow a dequant launch: {short_names(dec)}")
    elif not te or gemm_calls(dec) != te:
        return (f"the decode ran {te} thres_expand launches and {gemm_calls(dec)} GEMMs: "
                f"{short_names(dec)}")
    return ""


def short_names(names: list[str]) -> list[str]:
    """Kernel names without their return type, namespaces and arguments."""
    out = []
    for n in names:
        for lead in ("void ", "(anonymous namespace)::", "at::native::", "cutlass::"):
            n = n.removeprefix(lead)
        out.append(n.split("<")[0].split("(")[0][:40])
    return out


def check_threshold_chains(ft, torch, dev) -> None:
    """One traced batch_encode and batch_decode of 1 s of the track as each
    lossy profile, held to `threshold_chain_fault`."""
    pcm = make_audio(1.0, SRATE, CHANNELS)
    for profile in (1, 2):
        stream = ft.batch_encode(pcm, profile, SRATE, BITS, FSIZE, device=dev)
        enc = traced_kernels(torch, lambda: ft.batch_encode(pcm, profile, SRATE, BITS, FSIZE,
                                                            device=dev))
        dec = traced_kernels(torch, lambda: ft.batch_decode(stream, device=dev))
        fault = threshold_chain_fault(enc, dec, profile)
        if fault:
            raise AssertionError(f"profile {profile} threshold chains: {fault}")
        after = short_names([enc[i + 1] for i, n in enumerate(enc) if "mask_thres" in n])
        expand = ("no thres_expand, dequant right before each" if profile == 1
                  else "as many thres_expand")
        print(f"profile {profile} threshold chains, 1 s: batch_encode ran {len(enc)} kernels, "
              f"{len(after)} times a DCT GEMM -> mask_thres -> {after[0]} and no other GEMM; "
              f"batch_decode ran {len(dec)} kernels, {gemm_calls(dec)} GEMMs (the IDCT's) and "
              f"{expand}; encode kernels {short_names(enc)}; decode kernels "
              f"{short_names(dec)}")



#: kinds of lanes `analysis_inputs` cycles through
ANALYSIS_KINDS = 14


def analysis_inputs(lanes: int, n: int, dtype: str, seed: int):
    """(freqs [lanes, n], div [lanes, n]) for the TNS analysis kernels; the
    rows of freqs / div cycle through ANALYSIS_KINDS kinds: 0 a decaying
    tone (TNS runs), 1 decaying noise, 2 white noise (the flatness gate),
    3 the constant 1e-8 (the energy gate), 4 zeros, 5 a near-constant row
    (the tiny-coefficient gate), 6-11 tone and noise mixed 0.2 to 0.8 (the
    flatness gate's edge), 12 the tone at 5e6 (its residual passes 1e6),
    13 the tone with one infinite bin. The divisors span two decades and
    are 0 over the last sixteenth of the bins of the kinds without noise
    at full scale (0, 1, 3, 4, 5, 12, 13)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    kind = np.arange(lanes) % ANALYSIS_KINDS
    noise = rng.standard_normal((lanes, n))
    amp = 1.0 + 0.1 * rng.random((lanes, 1))
    tone = np.exp(-t / 40.0) * np.sin(t * 0.7) * 50 * amp
    slow = np.exp(-t / 30.0) * np.sin(t * 0.3) * 30 * amp
    x = noise.copy()
    x[kind == 0] = tone[kind == 0]
    x[kind == 1] = (np.exp(-t / 15.0) * noise * 20)[kind == 1]
    x[kind == 3] = 1e-8
    x[kind == 4] = 0.0
    x[kind == 5] = (1.0 + 1e-4 * noise)[kind == 5]
    for i, mix in enumerate((0.2, 0.4, 0.5, 0.55, 0.6, 0.8)):
        x[kind == 6 + i] = ((1 - mix) * slow + mix * noise)[kind == 6 + i]
    x[kind == 12] = tone[kind == 12] * 1e5
    x[kind == 13] = tone[kind == 13]
    div = np.exp(rng.standard_normal((lanes, n))) * 0.1
    freqs = x * div
    freqs[kind == 13, 5] = np.inf
    # (zeros at the top of a noisy row would pull its flatness under the gate)
    div[(kind < 2) | (kind > 11) | ((kind > 2) & (kind < 6)), n - n // 16:] = 0.0
    return tuple(np.ascontiguousarray(a, dtype=dtype) for a in (freqs, div))


#: kinds of rows of `fir_gate_inputs`
FIR_KINDS = 7


def fir_gate_inputs(torch, x, ac_good):
    """(x [L, N], ac [L, 13], gate [L]) for tns_fir_gate on rows that a
    natural spectrum does not give, the gate true on every row, rows
    cycling through FIR_KINDS kinds: 0 and 6 a tone row of `x` with its
    lags `ac_good` (TNS runs); 1-4 the lags of an AR(1) process of
    coefficient rho, [1, rho, rho^2, ..., rho^12], whose LPC is [1, -rho,
    0, ...]: 1 rho = 0.0005 (the coefficients sum under 0.01), 2 rho = 0.02
    (each rounds to 0), 3 a smooth positive row with rho = -0.9 (lpc[1] =
    0.9: the residual is larger than the row, gain 0), 4 values near the
    dtype's largest with rho = -0.9 (the residual overflows); 5 a NaN in
    the tone row."""
    lanes, n = x.shape
    kind = torch.arange(lanes, device=x.device) % FIR_KINDS
    xb = x[0].expand(lanes, n).clone()
    ac = ac_good.expand(lanes, 13).clone()
    for k, rho in ((1, 0.0005), (2, 0.02), (3, -0.9), (4, -0.9)):
        ac[kind == k] = torch.tensor([rho ** j for j in range(13)], dtype=x.dtype,
                                     device=x.device)
    xb[kind == 3] = 1.0 + torch.arange(n, device=x.device, dtype=x.dtype) / n
    xb[kind == 4] = xb[kind == 4].sign() * (torch.finfo(x.dtype).max * 0.9)
    xb[kind == 5, 7] = float("nan")
    return xb, ac, torch.ones(lanes, dtype=torch.bool, device=x.device)


#: tns_fir_gate's forms that no run launches, (dtype, [L, N]) on
#: `analysis_inputs`: rows of 1001 samples, of which only every fourth
#: (float32) or second (float64) starts on a 16-byte boundary, in x and in
#: out; and float64 rows too long for x and the residual both in a block's
#: shared memory (the kernel keeps the residual in out)
FIR_GATE_EXTRA_FORMS = (("float32", (6, 1001)), ("float64", (6, 1001)),
                        ("float64", (2, 16384)))


def offset_view(torch, a):
    """A copy of `a` in a buffer one element longer, starting at its second
    element: contiguous, but its rows are not 16-byte aligned."""
    buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)
    view = buf[1:].view(a.shape)
    view.copy_(a)
    return view


def check_tns_analysis_kernels(torch, kernels, dev) -> dict:
    """tns_autocorr and tns_fir_gate against their plain versions on the
    card, bit for bit, at TNS_SHAPES, float32 and float64: as the chain
    tns_autocorr -> tns_fir_gate on `analysis_inputs` (with a divisor, and
    at each dtype's first shape without; there and at 8 lanes also on
    `offset_view`s, rows that are not 16-byte aligned), and tns_fir_gate
    alone on `fir_gate_inputs`; then tns_fir_gate at FIR_GATE_EXTRA_FORMS.
    From 14 lanes on, every gate must be met from both sides. CUDA-event
    times of the kernels, of the plain versions at each dtype's first shape
    and at 8 lanes of float32; a call of each at the main path's shape
    (`thunks`) and each one's bound, tns_fir_gate's work from the rows whose
    gate is true (the recursion and the filter run on those)."""
    from frad_python_tpu_torch.ops import tns

    res = {"ac_err": 0.0, "fg_err": 0.0, "thunks": {}, "stream_thunks": {}, "bounds": {},
           "stream_bounds": {}}

    def same(name, form, got, want):
        names = {"tns_autocorr": ("x", "ac", "gate"), "tns_fir_gate": ("out", "lpc_out", "run")}
        for what, g, w in zip(names[name], got, want):
            ok = torch.equal(g, w) if g.dtype == torch.bool else bits_equal(torch, g, w)
            if not ok:
                detail = (f"{int((g != w).sum())} of {g.numel()} lanes" if g.dtype == torch.bool
                          else ulp_report(torch, g, w))
                raise AssertionError(f"{name} {form} differs from its plain version in "
                                     f"{what}: {detail}")

    for dtype, shapes in TNS_SHAPES.items():
        window = tns._lag_window(getattr(torch, dtype), dev)
        for si, (lanes, n) in enumerate(shapes):
            form = f"{(lanes, n)} {dtype}"
            freqs, div = (torch.from_numpy(a).to(dev)
                          for a in analysis_inputs(lanes, n, dtype, 900 + lanes))
            got, want = held(kernels, "tns_autocorr", freqs, div, window)
            torch.cuda.synchronize()
            same("tns_autocorr", form, got, want)
            x, ac, gate = got
            res["ac_err"] = max(res["ac_err"], max_abs(torch, ac, want[1]),
                                max_abs(torch, x.nan_to_num(0.0, 0.0, 0.0),
                                        want[0].nan_to_num(0.0, 0.0, 0.0)))
            if si == 0:
                got0, want0 = held(kernels, "tns_autocorr", x, None, window)
                torch.cuda.synchronize()
                same("tns_autocorr", form + " no divisor", got0, want0)
                same("tns_autocorr", form + " with and without the divisor",
                     (x,) + got0[1:], got)
            if si == 0 or lanes == 8:
                # rows one element past a 16-byte boundary
                got_o, want_o = held(kernels, "tns_autocorr", offset_view(torch, freqs),
                                     offset_view(torch, div), window)
                torch.cuda.synchronize()
                same("tns_autocorr", form + " offset views", got_o, want_o)
                same("tns_autocorr", form + " offset views against aligned rows", got_o, got)
            got_f, want_f = held(kernels, "tns_fir_gate", x, ac, gate)
            xb, ac_b, gate_b = fir_gate_inputs(torch, x, ac[0])
            got_b, want_b = held(kernels, "tns_fir_gate", xb, ac_b, gate_b)
            torch.cuda.synchronize()
            same("tns_fir_gate", form, got_f, want_f)
            same("tns_fir_gate", form + " (gates)", got_b, want_b)
            if si == 0 or lanes == 8:
                got_o, want_o = held(kernels, "tns_fir_gate", offset_view(torch, x),
                                     offset_view(torch, ac), offset_view(torch, gate))
                torch.cuda.synchronize()
                same("tns_fir_gate", form + " offset views", got_o, want_o)
                same("tns_fir_gate", form + " offset views against aligned rows", got_o, got_f)
            res["fg_err"] = max(res["fg_err"],
                                max_abs(torch, got_f[0].nan_to_num(0.0, 0.0, 0.0),
                                        want_f[0].nan_to_num(0.0, 0.0, 0.0)),
                                max_abs(torch, got_f[1], want_f[1]))
            run, run_b = got_f[2], got_b[2]
            kind = torch.arange(lanes, device=dev) % ANALYSIS_KINDS
            kind_b = torch.arange(lanes, device=dev) % FIR_KINDS
            off = (kind == 2) | (kind == 3) | (kind == 4) | (kind == 12) | (kind == 13)
            if lanes >= ANALYSIS_KINDS and not (
                    bool(run[kind == 0].all()) and not bool(run[off].any())
                    and bool(gate[kind == 12].all()) and not bool(gate[kind == 3].any())
                    and not bool(gate[kind == 2].any())
                    and bits_equal(torch, got_f[0][~run], x[~run])
                    and not bool(got_f[1][~run].any()) and bool(got_f[1][run].any())
                    and bool(run_b[(kind_b == 0) | (kind_b == 6)].all())
                    and not bool(run_b[(kind_b > 0) & (kind_b < 6)].any())
                    and bits_equal(torch, got_b[0][~run_b], xb[~run_b])):
                raise AssertionError(
                    f"TNS analysis inputs {form} miss a case: run by kind "
                    f"{[int(run[kind == k].sum()) for k in range(ANALYSIS_KINDS)]}, gate by kind "
                    f"{[int(gate[kind == k].sum()) for k in range(ANALYSIS_KINDS)]}, run of the "
                    f"gate rows by kind "
                    f"{[int(run_b[kind_b == k].sum()) for k in range(FIR_KINDS)]}")
            t = {"ac": cuda_ms(torch, lambda: kernels.tns_autocorr(freqs, div, window)),
                 "fg": cuda_ms(torch, lambda: kernels.tns_fir_gate(x, ac, gate))}
            line = (f"kernels tns_autocorr / tns_fir_gate {form}: equal bit for bit (chain and "
                    f"gate rows; TNS runs on {int(run.sum())} of {lanes} rows, "
                    f"{int(gate.sum())} pass the first gates), tns_autocorr {t['ac']:.4f} ms, "
                    f"tns_fir_gate {t['fg']:.4f} ms")
            if si == 0 or (lanes, dtype) == (8, "float32"):
                t["ac_plain"] = cuda_ms(
                    torch, lambda: kernels.tns_autocorr_plain(freqs, div, window), 3, 2)
                t["fg_plain"] = cuda_ms(
                    torch, lambda: kernels.tns_fir_gate_plain(x, ac, gate), 3, 2)
                line += f" vs plain {t['ac_plain']:.3f} / {t['fg_plain']:.3f} ms"
            if dtype == "float32" and (si == 0 or lanes == 8):
                res["thunks" if si == 0 else "stream_thunks"] = {
                    "tns_autocorr_kernel":
                        lambda f=freqs, d=div, w=window: kernels.tns_autocorr(f, d, w),
                    "tns_fir_gate_kernel":
                        lambda x=x, a=ac, g=gate: kernels.tns_fir_gate(x, a, g)}
            if dtype == "float32" and (si == 0 or lanes == 8):
                entered = int(gate.sum())
                res["bounds" if si == 0 else "stream_bounds"] = {
                    "tns_autocorr": bound(3 * lanes * n * 4 + lanes * 14 * 4 + lanes,
                                          lanes * n * 40),
                    "tns_fir_gate": bound(2 * lanes * n * 4 + 2 * lanes * 13 * 4 + 2 * lanes,
                                          entered * (n * 34 + 360))}
            res[(lanes, dtype)] = t
            print(line)
    for dtype, (lanes, n) in FIR_GATE_EXTRA_FORMS:
        freqs, div = (torch.from_numpy(a).to(dev)
                      for a in analysis_inputs(lanes, n, dtype, 700 + n))
        x, ac, gate = kernels.tns_autocorr_plain(freqs, div, tns._lag_window(freqs.dtype, dev))
        got, want = held(kernels, "tns_fir_gate", x, ac, gate)
        torch.cuda.synchronize()
        same("tns_fir_gate", f"{(lanes, n)} {dtype}", got, want)
        if not bool(got[2].any()):
            raise AssertionError(f"tns_fir_gate {(lanes, n)} {dtype}: TNS runs on no row")
    print(f"kernel tns_fir_gate at {list(FIR_GATE_EXTRA_FORMS)}: equal bit for bit")
    return res


def tns_lpc_rows(stream: bytes) -> np.ndarray:
    """[lanes, 13] quantised LPC rows of the Profile 2 payloads, a lane per
    (frame, channel)."""
    from frad_python_tpu_torch.models import profile2
    from frad_python_tpu_torch.parallel.pipeline import _parse_frames

    headers, payloads, _ = _parse_frames(stream)
    rows = [profile2.untrim_streams(profile2.unpack_streams(p), h.fsize, h.channels)[2]
            .reshape(profile2.ORDER1, h.channels).T
            for h, p in zip(headers, payloads) if p is not None]
    return np.concatenate(rows) if rows else np.zeros((0, profile2.ORDER1))


def tns_lane_share(stream: bytes) -> tuple[int, int]:
    """(lanes with a non-zero LPC row, lanes) over the Profile 2 payloads."""
    rows = tns_lpc_rows(stream)
    return int((rows != 0).any(axis=1).sum()), len(rows)


def stage_summary(timer) -> str:
    """A StageTimer's summary on one line."""
    return "; ".join(" ".join(line.split()) for line in timer.summary().splitlines())


def tns_phase(ft, torch, kernels, native, dev) -> dict:
    """Profile 2 on the card (see the module docstring). Returns the
    kernel checks, the launches of the batch and of the streaming runs, and
    a call of each TNS kernel at the main path's shape (`thunks`)."""
    from frad_python_tpu_torch.models import profile2
    from frad_python_tpu_torch.parallel import pipeline
    from frad_python_tpu_torch.parallel.pipeline import _parse_frames
    from frad_python_tpu_torch.utils.tracing import StageTimer

    res = check_tns_kernels(torch, kernels, dev)
    res["analysis"] = check_tns_analysis_kernels(torch, kernels, dev)
    res["thunks"].update(res["analysis"]["thunks"])
    res["stream_thunks"].update(res["analysis"]["stream_thunks"])
    res["bounds"].update(res["analysis"]["bounds"])
    res["stream_bounds"].update(res["analysis"]["stream_bounds"])
    pcm = make_audio(SECONDS, SRATE, CHANNELS)
    frames, terms = pipeline.plan_frames(len(pcm), FSIZE, 16, True)
    n = len(frames)

    # batch: one encode and one decode of the 30 s track
    warm = make_audio(1.0, SRATE, CHANNELS)
    warm_s = ft.batch_encode(warm, 2, SRATE, BITS, FSIZE, device=dev)
    ft.batch_decode(warm_s, device=dev)
    stream_decode(ft, torch, warm_s, PUSH, dev)
    torch.cuda.synchronize()
    forms = FormTally()
    pipeline.STAGES = stages = StageTimer()
    kernels.reset_launches()
    native.reset_calls()
    with forms:
        stream, t_enc = timed(torch, lambda: ft.batch_encode(pcm, 2, SRATE, BITS, FSIZE,
                                                             device=dev))
        (out, sr), t_dec = timed(torch, lambda: ft.batch_decode(stream, device=dev))
    res["launches"] = {k.__name__: k.launches for k in kernels.KERNELS}
    pipeline.STAGES = None
    calls = {w.__name__: w.calls for w in native.WRAPPERS}
    headers, payloads, tail = _parse_frames(stream)
    if (sum(p is not None for p in payloads), sum(p is None for p in payloads), tail,
            {h.profile for h in headers}) != (n, terms, b"", {2}):
        raise AssertionError(f"profile 2 stream: {len(headers)} headers of profiles "
                             f"{ {h.profile for h in headers} }, plan {n} + {terms}")
    if sr != SRATE or out.shape[1] != CHANNELS or len(out) < len(pcm) \
            or not np.isfinite(out).all():
        raise AssertionError(f"profile 2: decoded {out.shape} at {sr} Hz, or not finite")
    snr = snr_db(pcm, out)
    active, lanes = tns_lane_share(stream)
    if snr < P2_SNR_FLOOR_DB or active <= 0:
        raise AssertionError(f"profile 2: SNR {snr:.4f} dB (floor {P2_SNR_FLOOR_DB}), TNS ran "
                             f"on {active} of {lanes} lanes")
    for name in P2_KERNELS:
        if res["launches"][name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the profile 2 batch path")
    if calls["p1_unpack_batch"] <= 0:
        raise AssertionError("native p1_unpack_batch was not called by the profile 2 decode")
    out_cpu, _ = ft.batch_decode(stream, device="cpu")
    d_cpu = float(np.abs(out_cpu - out).max()) if out_cpu.shape == out.shape else float("inf")
    if d_cpu > P2_CARD_VS_CPU_MAX_ABS:
        raise AssertionError(f"profile 2 card vs CPU decode differ by {d_cpu} > "
                             f"{P2_CARD_VS_CPU_MAX_ABS}")
    # the same encode on the CPU (plain versions): the gates decide alike
    lpc_card = tns_lpc_rows(stream)
    lpc_cpu = tns_lpc_rows(ft.batch_encode(pcm, 2, SRATE, BITS, FSIZE, device="cpu"))
    lpc_differ = int((lpc_card != lpc_cpu).any(axis=1).sum()) \
        if lpc_card.shape == lpc_cpu.shape else lanes
    if lpc_differ > TNS_CARD_VS_CPU_LANES:
        raise AssertionError(f"profile 2: the card's quantised LPC differs from the CPU "
                             f"encode's on {lpc_differ} of {lanes} lanes "
                             f"(allowed {TNS_CARD_VS_CPU_LANES})")
    print(f"p2_stereo_44k1: {n} frames + {terms} terminators, {len(stream)} bytes, TNS ran on "
          f"{active} of {lanes} lanes ({active / lanes:.4f}; the CPU encode's "
          f"{int((lpc_cpu != 0).any(axis=1).sum())}, LPC rows differing {lpc_differ}), SNR "
          f"{snr:.4f} dB (floor "
          f"{P2_SNR_FLOOR_DB}), enc {n / t_enc:.1f} frames/s ({t_enc:.3f} s), dec "
          f"{n / t_dec:.1f} frames/s ({t_dec:.3f} s), card vs cpu decode max|d| {d_cpu} "
          f"(tolerance {P2_CARD_VS_CPU_MAX_ABS}), launches {res['launches']}, native calls "
          f"{calls}")
    print(f"stages p2 batch encode + decode: {stage_summary(stages)}")

    # streaming: the Decoder in 32 KiB pushes over the same stream
    kernels.reset_launches()
    with forms, FrameTally(pipeline, profile2) as dec_tally:
        (out_s, ttfa), t_s = timed(torch, lambda: stream_decode(ft, torch, stream, PUSH, dev))
    res["stream_launches"] = {k.__name__: k.launches for k in kernels.KERNELS}
    d_sb = float(np.abs(out_s - out).max()) if out_s.shape == out.shape else float("inf")
    if d_sb > STREAM_VS_BATCH_MAX_ABS or snr_db(pcm, out_s) < P2_SNR_FLOOR_DB \
            or min(res["stream_launches"][k]
                   for k in ("tns_iir", "overlap_add", "thres_expand")) <= 0:
        raise AssertionError(f"profile 2 streaming decode: max|stream - batch| {d_sb}, SNR "
                             f"{snr_db(pcm, out_s):.4f} dB, launches {res['stream_launches']}")
    # the Encoder refuses profile 2 in its gauntlet, as the JAX package's
    # does; an engine whose loaded state names profile 2 encodes it
    enc = ft.Encoder(1, SRATE, CHANNELS, BITS, FSIZE, "s16le", device=dev)
    enc.set_overlap_ratio(16)
    state = enc.state_dict()
    state["profile"] = 2
    enc.load_state_dict(state)
    raw = to_s16le(pcm)
    pipeline.STAGES = stages = StageTimer()
    kernels.reset_launches()
    with forms:
        s_enc, t_se = timed(torch, lambda: b"".join(
            [enc.process(raw[i:i + PUSH]).buf for i in range(0, len(raw), PUSH)]
            + [enc.flush().buf]))
    l_enc = {k.__name__: k.launches for k in kernels.KERNELS}
    pipeline.STAGES = None
    for k in l_enc:
        res["stream_launches"][k] += l_enc[k]
    out_e, _ = ft.batch_decode(s_enc, device=dev)
    h_e, p_e, _ = _parse_frames(s_enc)
    if {h.profile for h in h_e} != {2} or sum(p is not None for p in p_e) != n \
            or snr_db(pcm, out_e) < P2_SNR_FLOOR_DB \
            or min(l_enc[k] for k in P2_ENCODE_KERNELS) <= 0:
        raise AssertionError(f"profile 2 streaming encode: {len(h_e)} headers, SNR "
                             f"{snr_db(pcm, out_e):.4f} dB, launches {l_enc}")
    print(f"stream p2: dec {PUSH}-byte pushes {t_s:.3f} s ({n / t_s:.1f} frames/s, first audio "
          f"after {ttfa * 1e3:.2f} ms), max|stream - batch| {d_sb} (tolerance "
          f"{STREAM_VS_BATCH_MAX_ABS}), SNR {snr_db(pcm, out_s):.4f} dB, frames per call "
          f"{dec_tally.used()}; enc (state dict with profile 2) {t_se:.3f} s "
          f"({n / t_se:.1f} frames/s), SNR {snr_db(pcm, out_e):.4f} dB; launches "
          f"{res['stream_launches']}")
    print(f"stages p2 Encoder, {PUSH}-byte pushes: {stage_summary(stages)}")

    # profiles 1 and 2 at float64 (the JAX package's default off the TPU)
    short = make_audio(F64_SECONDS, SRATE, CHANNELS)
    n64 = len(pipeline.plan_frames(len(short), FSIZE, 16, True)[0])
    for profile in (1, 2):
        # first-use set-up (cuFFT plans are per batch shape): the same track
        ft.batch_decode(ft.batch_encode(short, profile, SRATE, BITS, FSIZE,
                                        compute_dtype="float64", device=dev),
                        compute_dtype="float64", device=dev)
        torch.cuda.synchronize()
        kernels.reset_launches()
        with forms:
            s64, t_e = timed(torch, lambda: ft.batch_encode(
                short, profile, SRATE, BITS, FSIZE, compute_dtype="float64", device=dev))
            (o64, _), t_d = timed(torch, lambda: ft.batch_decode(
                s64, compute_dtype="float64", device=dev))
        l64 = {k.__name__: k.launches for k in kernels.KERNELS}
        o_cpu, _ = ft.batch_decode(s64, compute_dtype="float64", device="cpu")
        s_cpu = ft.batch_encode(short, profile, SRATE, BITS, FSIZE, compute_dtype="float64",
                                device="cpu")
        differ = sum(a != b for a, b in zip(_parse_frames(s64)[1], _parse_frames(s_cpu)[1]))
        d64 = float(np.abs(o_cpu - o64).max()) if o_cpu.shape == o64.shape else float("inf")
        snr64 = snr_db(short, o64)
        # float64 symbols are int64 and take the host EGR coder: no egr_pack
        need = P2_KERNELS if profile == 2 else tuple(k for k in P1_KERNELS if k != "egr_pack")
        if d64 > F64_LOSSY_CARD_VS_CPU_MAX_ABS or snr64 < F64_SNR_FLOOR_DB[profile] \
                or min(l64[k] for k in need) <= 0:
            raise AssertionError(f"profile {profile} float64: card vs cpu decode {d64}, SNR "
                                 f"{snr64:.4f} dB (floor {F64_SNR_FLOOR_DB[profile]}), "
                                 f"launches {l64}")
        print(f"profile {profile} float64, {F64_SECONDS:g} s: {n64} frames, enc {t_e:.3f} s, "
              f"dec {t_d:.3f} s, SNR {snr64:.4f} dB (floor {F64_SNR_FLOOR_DB[profile]}), "
              f"payloads differing from the CPU stream {differ} of {n64}, card vs cpu decode "
              f"max|d| {d64} (tolerance {F64_LOSSY_CARD_VS_CPU_MAX_ABS}), launches {l64}")
    forms.require_held("the Profile 2 and float64 runs")
    print(f"forms launched by the Profile 2 and float64 runs, each held against its plain "
          f"version above (form: launches): "
          + ", ".join(f"{f}: {c}" for f, c in sorted(forms.seen.items(), key=str)))
    return res


def cli_phase(ft, torch, kernels, dev, pcm: np.ndarray, smi: str) -> dict:
    """The command line on the card, in a temporary directory: every
    action through `app.main.main` with no `--device` (CUDA), and one
    `python3 -m frad_python_tpu_torch encode` subprocess. Returns the walls
    per action."""
    from frad_python_tpu_torch.app.encode import loss_level_from_cli
    from frad_python_tpu_torch.app.main import main as cli_main
    from frad_python_tpu_torch.container import head
    from frad_python_tpu_torch.ops.pcm import to_f64
    from frad_python_tpu_torch.utils.damage import damage_stream

    repo = Path(__file__).resolve().parent
    png = b"\x89PNG\r\n\x1a\n" + bytes(range(256)) * 8
    raw = to_s16le(pcm)
    s16 = np.dtype("<i2")
    content = to_f64(np.frombuffer(raw, s16).reshape(-1, CHANNELS), s16)
    geometry = ["--srate", str(SRATE), "--ch", str(CHANNELS), "--pcm", "s16le",
                "--bits", str(BITS), "--fr", str(FSIZE)]
    walls = {}
    here = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)                    # `meta parse` exports beside the working directory
        try:
            Path("track.pcm").write_bytes(raw)
            Path("cover.png").write_bytes(png)

            def run(name: str, argv: list[str]) -> None:
                _, walls[name] = timed(torch, lambda: cli_main(["frad-torch"] + argv))

            def read_s16(path: str) -> np.ndarray:
                return np.frombuffer(Path(path).read_bytes(), s16).reshape(-1, CHANNELS) / 32768.0

            # Profile 1: encode (batch path), the file's bytes, decode
            kernels.reset_launches()
            run("encode", ["encode", "track.pcm", "--profile", "1", "--tag", "TITLE", "smoke",
                           "--img", "cover.png", "-o", "track.frad", "-y"] + geometry)
            run("decode", ["decode", "track.frad", "--pcm", "s16le", "-o", "back", "-y"])
            launches = {k.__name__: k.launches for k in kernels.KERNELS}
            header = head.builder([("TITLE", b"smoke")], png)
            stream = ft.batch_encode(content, 1, SRATE, BITS, FSIZE,
                                     loss_level=loss_level_from_cli(0), device=dev)
            file = Path("track.frad").read_bytes()
            if file != header + stream:
                raise AssertionError("cli encode: the file is not head.builder(...) + the bytes "
                                     "of batch_encode on the same input")
            out, _ = ft.batch_decode(stream, device=dev)
            want = np.frombuffer(
                (np.asarray(out) * 32768.0).astype(s16).tobytes(), s16).reshape(-1, CHANNELS)
            back = read_s16("back.pcm")
            snr = snr_db(pcm, back)
            if not np.array_equal(back * 32768.0, want) or snr < CLI_P1_SNR_FLOOR_DB:
                raise AssertionError(f"cli decode: PCM differs from batch_decode's through the "
                                     f"same cast, or SNR {snr:.4f} dB below {CLI_P1_SNR_FLOOR_DB}")
            for name in P1_KERNELS:
                if launches[name] <= 0:
                    raise AssertionError(f"kernel {name} was not launched by the cli's encode "
                                         f"and decode: {launches}")

            # the engines: --no-turbo encode, and a decode fed in the pipe's reads
            kernels.reset_launches()
            run("encode_no_turbo", ["encode", "track.pcm", "--profile", "1", "--no-turbo",
                                    "-o", "engine.frad", "-y"] + geometry)

            class Pipe:
                def __init__(self, data: bytes = b""):
                    self.buffer = io.BytesIO(data)

                def isatty(self) -> bool:
                    return False

            stdin, stdout = sys.stdin, sys.stdout
            piped = Pipe()
            sys.stdin, sys.stdout = Pipe(Path("engine.frad").read_bytes()), piped
            try:
                run("decode_pipe", ["decode", "-", "--pcm", "s16le", "-o", "-"])
            finally:
                sys.stdin, sys.stdout = stdin, stdout
            l_engine = {k.__name__: k.launches for k in kernels.KERNELS}
            back_e = np.frombuffer(piped.buffer.getvalue(), s16).reshape(-1, CHANNELS) / 32768.0
            snr_e = snr_db(pcm, back_e)
            if len(back_e) != len(back) or snr_e < CLI_P1_SNR_FLOOR_DB \
                    or min(l_engine[k] for k in P1_KERNELS) <= 0:
                raise AssertionError(f"cli engines: {len(back_e)} samples, SNR {snr_e:.4f} dB, "
                                     f"launches {l_engine}")

            # profile 0 at 24 bits
            run("encode_p0", ["encode", "track.pcm", "--profile", "0", "-o", "p0.frad", "-y"]
                + geometry[:6] + ["--bits", str(P0_BITS), "--fr", str(FSIZE)])
            run("decode_p0", ["decode", "p0.frad", "--pcm", "f64le", "-o", "p0back", "-y"])
            back0 = np.frombuffer(Path("p0back.pcm").read_bytes(), "<f8").reshape(-1, CHANNELS)
            snr0 = snr_db(content, back0)
            if back0.shape != content.shape or snr0 < CLI_P0_SNR_FLOOR_DB:
                raise AssertionError(f"cli profile 0: {back0.shape}, SNR {snr0:.4f} dB below "
                                     f"{CLI_P0_SNR_FLOOR_DB}")

            # repair of a damaged armored file
            run("encode_ecc", ["encode", "track.pcm", "--profile", "1", "--ecc",
                               str(ECC_RATIO[0]), str(ECC_RATIO[1]), "-o", "armored.frad", "-y"]
                + geometry)
            armored = Path("armored.frad").read_bytes()
            n_head = len(head.builder([], b""))
            Path("damaged.frad").write_bytes(armored[:n_head] + damage_stream(armored[n_head:]))
            run("repair", ["repair", "damaged.frad", "--ecc", str(ECC_RATIO[0]),
                           str(ECC_RATIO[1]), "-o", "repaired.frad", "-y"])
            if Path("damaged.frad").read_bytes() == armored \
                    or Path("repaired.frad").read_bytes() != armored:
                raise AssertionError("cli repair of the damaged armored file differs from the "
                                     "armored file")

            # meta: add, parse, remove
            run("meta_add", ["meta", "add", "track.frad", "--meta", "ARTIST", "chip"])
            run("meta_parse", ["meta", "parse", "track.frad"])
            keys = [m["key"] for m in json.loads(Path("track.json").read_text())]
            run("meta_remove", ["meta", "remove", "track.frad", "--meta", "TITLE"])
            cli_main(["frad-torch", "meta", "parse", "track.frad"])
            keys2 = [m["key"] for m in json.loads(Path("track.json").read_text())]
            after = Path("track.frad").read_bytes()
            if keys != ["TITLE", "ARTIST"] or keys2 != ["ARTIST"] \
                    or Path("track.png").read_bytes() != png \
                    or after != head.builder([("ARTIST", b"chip")], png) + stream:
                raise AssertionError(f"cli meta: keys {keys} then {keys2}, or the audio moved")

            # the real entry point: a process of its own, the build at first
            # use (cached from this run), its exit code
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-m", "frad_python_tpu_torch", "encode", "track.pcm",
                 "--profile", "1", "--tag", "TITLE", "smoke", "--img", "cover.png", "-o",
                 "sub.frad", "-y", "--log", "1"] + geometry,
                env=dict(os.environ, PYTHONPATH=str(repo)), capture_output=True, text=True,
                timeout=600)
            walls["subprocess_encode"] = time.perf_counter() - t0
            if res.returncode != 0 or Path("sub.frad").read_bytes() != file \
                    or "size=" not in res.stderr:
                raise AssertionError(f"python3 -m frad_python_tpu_torch encode: exit code "
                                     f"{res.returncode}, or another file than in process:\n"
                                     f"{res.stderr[-2000:]}")
        finally:
            os.chdir(here)
    n = len(_frames_of(pcm))
    print(f"cli ({smi}): " + ", ".join(f"{k} {v:.4f} s" for k, v in walls.items())
          + f"; encode = header + batch_encode's bytes ({len(file)} bytes, {n} frames), decode "
          f"= batch_decode's PCM, SNR {snr:.4f} dB (floor {CLI_P1_SNR_FLOOR_DB}); engines SNR "
          f"{snr_e:.4f} dB; profile 0 {P0_BITS}-bit SNR {snr0:.4f} dB (floor "
          f"{CLI_P0_SNR_FLOOR_DB}); repair equal to the armored file; meta {keys} -> {keys2}; "
          f"subprocess equal to the in-process file; launches encode + decode {launches}, "
          f"engines {l_engine}")
    return walls


def halo_bound(shape: tuple[int, int, int], dtype: str, i16: bool) -> tuple[float, str]:
    """overlap_add's bound with a halo at [B, C, N] (olap = OLAP, cut =
    CUT): the frames, the window, the halo, the output and the fragment
    moved once; every frame's head blended (3 operations a sample) and each
    output sample emitted (2)."""
    b, c, n = shape
    item = 8 if dtype == "float64" else 4
    nbytes = (b * c * n * item + OLAP * item + c * OLAP * item
              + b * CUT * c * (2 if i16 else item) + OLAP * c * item)
    return bound(nbytes, b * c * CUT * 2 + b * c * OLAP * 3, dtype)


def check_halo_kernel(torch, kernels, dev) -> dict:
    """overlap_add with a halo at HALO_SHAPES x HALO_EMITS, bit for bit
    against overlap_add_plain with the same halo; at each also without a
    halo (a data-rank 0 block), with the halo and the frames each on storage
    not 16-byte aligned. CUDA-event times of the kernel with a halo, without
    one and of the plain version at [172] and [4] (float emit), device times
    there from the profiler, and their bounds."""
    from frad_python_tpu_torch.parallel.sharded import halo_window

    rng = np.random.default_rng(8642)
    res = {"err": 0.0}
    for shape in HALO_SHAPES:
        for dtype, i16 in HALO_EMITS:
            pcm = torch.from_numpy((rng.standard_normal(shape) * 0.6).astype(dtype)).to(dev)
            halo = torch.from_numpy(
                (rng.standard_normal((shape[1], OLAP)) * 0.6).astype(dtype)).to(dev)
            w = halo_window(OLAP, pcm.dtype, dev)
            for x, h in ((pcm, halo), (pcm, offset_view(torch, halo)),
                         (offset_view(torch, pcm), halo), (pcm, None)):
                (out_k, frag_k), (out_p, frag_p) = held(kernels, "overlap_add", x, w, CUT, i16,
                                                        h)
                torch.cuda.synchronize()
                res["err"] = max(res["err"], max_abs(torch, out_k, out_p),
                                 max_abs(torch, frag_k, frag_p))
                if not (bits_equal(torch, out_k, out_p) and bits_equal(torch, frag_k, frag_p)):
                    raise AssertionError(
                        f"overlap_add {shape} {dtype} i16={i16} halo={h is not None} aligned="
                        f"{(x.data_ptr() % 16, 0 if h is None else h.data_ptr() % 16)} differs "
                        f"from its plain version: max |d| {res['err']}")
            if shape != HALO_SHAPES[1] and (dtype, i16) == ("float32", False):
                key = shape[0]
                res[key] = {
                    "ms": cuda_ms(torch, lambda: kernels.overlap_add(pcm, w, CUT, False, halo)),
                    "ms_no_halo": cuda_ms(torch, lambda: kernels.overlap_add(pcm, w, CUT, False)),
                    "plain_ms": cuda_ms(
                        torch, lambda: kernels.overlap_add_plain(pcm, w, CUT, False, halo)),
                    "bound": halo_bound(shape, dtype, False),
                    "thunks": {
                        "device_ms": lambda p=pcm, w=w, h=halo: kernels.overlap_add(p, w, CUT,
                                                                                    False, h),
                        "device_ms_no_halo": lambda p=pcm, w=w: kernels.overlap_add(p, w, CUT,
                                                                                    False)}}
    for key in (HALO_SHAPES[0][0], HALO_SHAPES[2][0]):
        for name, thunk in res[key].pop("thunks").items():
            ms, made = kept_device_ms(torch, {"overlap_add_kernel": thunk})
            if ms["overlap_add_kernel"] is None:
                raise AssertionError(f"overlap_add [{key}] {name}: no device time in {made} "
                                     f"recordings")
            res[key][name] = ms["overlap_add_kernel"]
    print(f"kernel overlap_add with a halo at {list(HALO_SHAPES)} x {list(HALO_EMITS)} (and "
          f"without one, halo and frames each also not 16-byte aligned): equal to plain bit "
          f"for bit; f32 emit, CUDA events (ms): "
          + "; ".join(f"[{k}] halo {res[k]['ms']:.4f}, no halo {res[k]['ms_no_halo']:.4f}, plain "
                      f"{res[k]['plain_ms']:.4f}, profiler {res[k]['device_ms']:.4f} (no halo "
                      f"{res[k]['device_ms_no_halo']:.4f}), bound {res[k]['bound'][0]:.5f} by "
                      f"{res[k]['bound'][1]}"
                      for k in (HALO_SHAPES[0][0], HALO_SHAPES[2][0])))
    return res


def track_frames(pcm: np.ndarray) -> np.ndarray:
    """The track's frames as the batch pipeline plans them, [frames, FSIZE,
    C] float64, the last one zero-padded."""
    from frad_python_tpu_torch.parallel.pipeline import plan_frames

    frames = plan_frames(len(pcm), FSIZE, 16, True)[0]
    out = np.zeros((len(frames), FSIZE, pcm.shape[1]))
    for i, (start, ln) in enumerate(frames):
        out[i, :ln] = pcm[start:start + ln]
    return out


def held_form(torch, kernels, dev, form: tuple, seed: int) -> None:
    """Holds a kernel against its plain version at `form` (a
    `kernel_form`) on synthetic inputs of that shape, dtype and options,
    bit for bit; raises where they differ or no inputs can be made."""
    from frad_python_tpu_torch.kernels.overlap_add import crossfade_window

    name, shape, dtype = form[:3]
    rng = np.random.default_rng(seed)
    if name == "overlap_add":
        olap, cut, i16 = form[3:6]
        pcm = torch.from_numpy((rng.standard_normal(shape) * 0.6).astype(dtype)).to(dev)
        args = (pcm, crossfade_window(olap, dev, pcm.dtype), cut, i16)
        if len(form) > 6:
            args += (torch.from_numpy((rng.standard_normal((shape[1], olap)) * 0.6)
                                      .astype(dtype)).to(dev),)
    elif name == "power_quant":
        freqs = rng.standard_normal(shape) * 1e-2
        div = np.exp(rng.standard_normal(shape) * 2.0) * 0.1
        div[:, -shape[1] // 16:] = 0.0
        args = (torch.from_numpy((freqs if form[3] else freqs * 30.0).astype(dtype)).to(dev),
                torch.from_numpy(div.astype(dtype)).to(dev) if form[3] else None, 2.0 ** 15)
    elif name == "mask_thres":
        x = torch.from_numpy(mask_thres_inputs(shape[0], shape[1], dtype, seed)).to(dev)
        args = (x, 2.0 ** 15, 0.5, form[3], form[4])
    elif name == "dequant":
        s_d, t_d = dequant_inputs(torch, rng, dtype, shape, dev)
        args = (s_d, t_d if form[3] else None, 2.0 ** 15, form[4] or SRATE)
    elif name == "egr_pack":
        args = (torch.from_numpy(egr_inputs(shape[0], shape[1], seed)).to(dev), form[3])
    elif name == "tns_iir":
        x, coeffs, _ = tns_inputs(shape[0], shape[1], dtype, seed)
        args = (torch.from_numpy(x).to(dev), torch.from_numpy(coeffs).to(dev))
    elif name in ("tns_autocorr", "tns_fir_gate"):
        from frad_python_tpu_torch.ops import tns

        freqs, div = (torch.from_numpy(a).to(dev)
                      for a in analysis_inputs(shape[0], shape[1], dtype, seed))
        window = tns._lag_window(freqs.dtype, dev)
        if name == "tns_autocorr":
            args = (freqs, div if form[3] else None, window)
        else:
            args = tuple(t.contiguous() for t in kernels.tns_autocorr_plain(freqs, div, window))
    elif name == "thres_expand":
        sym = np.rint(rng.laplace(0, 6, shape)).astype(dtype)
        args = (torch.from_numpy(sym).to(dev), form[3], form[4])
    elif name == "i24_unpack":
        args = (torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64)
                                 .astype(np.int32)).to(dev),)
    elif name == "i24_pack":
        view = torch.from_numpy(i24_inputs(shape, seed)).to(dev).transpose(1, 2)
        args = (view.contiguous() if form[3] else view,)
    else:
        raise AssertionError(f"no inputs to hold {form} with")
    got, want = held(kernels, name, *args)
    torch.cuda.synchronize()
    if kernel_form(name, *args) != form or len(got) != len(want) or not all(
            bits_equal(torch, g, w) if g.is_floating_point()
            else g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{name} at {form} differs from its plain version")


def spanwise_encode(ft, torch, multihost, dev, pcm, name: str, profile: int, bits: int,
                    compact: bool, floor: float, kw: dict) -> None:
    """`pcm` encoded in SHARDS spans (`host_span`, final only on the last),
    joined by `gather_bitstream` (the identity at one process), against one
    `batch_encode` of it with the same options. At float64 the bytes must
    be equal. At float32 the DCT GEMM sums a span's fewer rows in another
    order than the whole batch's (cuBLAS picks its kernel by shape), so a
    symbol may round the other way: the frame plan and headers must be
    equal and the joined stream must decode above `floor`; the payloads
    that differ are counted."""
    from frad_python_tpu_torch.parallel.pipeline import _parse_frames

    ratio = 16 if compact else 0
    ref = ft.batch_encode(pcm, profile, SRATE, bits, FSIZE, device=dev, **kw)
    parts, t0 = [], time.perf_counter()
    for pid in range(SHARDS):
        span = multihost.host_span(len(pcm), FSIZE, ratio, compact, pid, SHARDS)
        parts.append(ft.batch_encode(pcm[span.start:span.stop], profile, SRATE, bits, FSIZE,
                                     final=pid == SHARDS - 1, device=dev, **kw))
    torch.cuda.synchronize()
    t_spans = time.perf_counter() - t0
    joined = multihost.gather_bitstream(b"".join(parts))
    (h_j, p_j, tail_j), (h_r, p_r, tail_r) = _parse_frames(joined), _parse_frames(ref)
    differ = sum(a != b for a, b in zip(p_j, p_r))
    out, _ = ft.batch_decode(joined, device=dev)
    snr = snr_db(pcm, out)
    equal = joined == ref
    plan_equal = ([(h.profile, h.srate, h.channels, h.fsize) for h in h_j]
                  == [(h.profile, h.srate, h.channels, h.fsize) for h in h_r]
                  and [p is None for p in p_j] == [p is None for p in p_r]
                  and tail_j == tail_r == b"")
    dtype = kw["compute_dtype"]
    print(f"spanwise {name} {dtype}: {SHARDS} spans ({[len(p) for p in parts]} bytes, "
          f"{t_spans:.3f} s) joined by gather_bitstream against one batch_encode "
          f"({len(ref)} bytes): equal {equal}, {differ} of {len(p_r)} payloads differ, decode "
          f"SNR {snr:.4f} dB (floor {floor})")
    if not plan_equal or snr < floor or (dtype == "float64" and not equal):
        raise AssertionError(f"spanwise {name} {dtype}: equal {equal}, frame plan equal "
                             f"{plan_equal}, {differ} payloads differ, SNR {snr:.4f} dB")


def shard_phase(ft, torch, kernels, dev) -> dict:
    """The sharded path on the card (see the module docstring): the halo
    form of overlap_add, training_step_equivalent at world size 1 over NCCL
    at float32 and float64 against the single-device cores, the per-rank
    overlap-add by hand over SHARDS blocks, and spanwise encodes of two
    configurations joined against one encode. A tally over the runs holds
    every form they launch (those no table above holds, after them, on
    inputs of that form). Returns the halo checks and the launches."""
    import torch.distributed as dist

    from frad_python_tpu_torch.models import batch
    from frad_python_tpu_torch.ops.policy import to_device, to_host
    from frad_python_tpu_torch.parallel import multihost, sharded

    res = {"halo": check_halo_kernel(torch, kernels, dev), "launches": {}}
    pcm = make_audio(SECONDS, SRATE, CHANNELS)
    frames = track_frames(pcm)
    factor, loss = 2.0 ** 15, 0.5
    t0 = time.perf_counter()
    mesh = sharded.make_mesh(1)
    t_mesh = time.perf_counter() - t0
    if dist.get_backend() != "nccl" or mesh.device_type != "cuda":
        raise AssertionError(f"the CUDA mesh runs on {dist.get_backend()} / {mesh.device_type}")
    tally = FormTally()
    lines = []
    with contextlib.ExitStack() as group, tally:
        group.callback(dist.destroy_process_group)
        sharded.training_step_equivalent(mesh, frames[:4], SRATE, loss, factor)   # warm-up
        step = {}
        for dtype in ("float32", "float64"):
            x = frames.astype(dtype)
            kernels.reset_launches()
            (out, t_step) = timed(torch, lambda: sharded.training_step_equivalent(
                mesh, x, SRATE, loss, factor))
            res["launches"][dtype] = {k.__name__: k.launches for k in kernels.KERNELS}
            fq, tq = sharded.sharded_p1_encode(mesh, x, SRATE, loss, factor)
            rfq, rtq = to_host(*batch.p1_encode_core(to_device(x, dev), SRATE, loss, factor))
            if not (np.array_equal(fq, rfq) and np.array_equal(tq, rtq)):
                raise AssertionError(f"sharded_p1_encode {dtype}: {int((fq != rfq).sum())} "
                                     f"symbols differ from p1_encode_core")
            dec = batch.p1_decode_core(to_device(fq.astype(np.float64), dev),
                                       to_device(tq.astype(np.float64), dev), SRATE, factor)
            (ref,) = to_host(batch.overlap_add_core(dec, OLAP, CUT))
            # the decode is float64 at either input dtype, as in the JAX
            # package: the same cores on the same card give the same bits
            d = float(np.abs(out - ref).max()) if out.shape == ref.shape else float("inf")
            same = out.shape == ref.shape and np.array_equal(out, ref)
            if not (same and np.isfinite(out).all()):
                raise AssertionError(f"training_step_equivalent {dtype}: max |d| {d} from "
                                     f"p1_decode_core + overlap_add_core")
            used = [k for k in ("mask_thres", "power_quant", "dequant", "overlap_add")
                    if res["launches"][dtype][k] <= 0]
            if used:
                raise AssertionError(f"training_step_equivalent {dtype} launched no {used}")
            step[dtype] = (out, to_host(dec.contiguous())[0])
            lines.append(f"{dtype} {out.shape} {t_step:.3f} s, bit-equal {same} (max |d| {d}), "
                         f"launches {res['launches'][dtype]}")
        print(f"sharded: NCCL mesh of 1 in {t_mesh:.3f} s; training_step_equivalent on the "
              f"{SECONDS:.0f} s track against the single-device cores (symbols equal): "
              + "; ".join(lines))

        # the per-rank body by hand: SHARDS blocks, each halo the previous
        # block's last tail
        decoded = step["float64"][1]
        for dtype in ("float64", "float32"):
            padded, pad = sharded.pad_to_multiple(decoded.astype(dtype), SHARDS)
            bl = len(padded) // SHARDS
            blocks = [to_device(padded[k * bl:(k + 1) * bl], dev).transpose(1, 2).contiguous()
                      for k in range(SHARDS)]
            kernels.reset_launches()
            outs = [sharded.local_overlap_add(
                blocks[k], None if k == 0 else blocks[k - 1][-1, :, CUT:CUT + OLAP].contiguous(),
                OLAP, CUT) for k in range(SHARDS)]
            launches = kernels.overlap_add.launches
            (joined,) = to_host(torch.cat(outs)[:len(decoded)])
            if dtype == "float64":
                want = step["float64"][0]
            else:
                whole = to_device(decoded.astype(dtype), dev).transpose(1, 2).contiguous()
                (want,) = to_host(kernels.overlap_add_plain(
                    whole, sharded.halo_window(OLAP, whole.dtype, dev), CUT, False)[0])
            if launches != SHARDS or joined.shape != want.shape \
                    or not np.array_equal(joined, want):
                raise AssertionError(f"by-hand {SHARDS} shards {dtype} ({launches} launches, "
                                     f"pad {pad}) differ from the world-size-1 result "
                                     f"(float64) or the plain blend (float32)")
        print(f"sharded by hand: {SHARDS} blocks of {bl} frames ({pad} padding), halos passed "
              f"by hand, one overlap_add launch each: float64 equal to the world-size-1 result, "
              f"float32 equal to the plain blend, bit for bit")

        # spanwise encodes: SHARDS spans, final only on the last, joined
        for dtype in ("float64", "float32"):
            for name, profile, bits, compact, kw, floor in SPAN_CONFIGS:
                spanwise_encode(ft, torch, multihost, dev, pcm, name, profile, bits, compact,
                                floor, dict(kw, compute_dtype=dtype))
        from frad_python_tpu_torch.ops.dct import dct2

        x = to_device(frames[:-1].astype(np.float32), dev).transpose(1, 2)
        part = len(x) // SHARDS
        (whole, alone) = to_host(dct2(x)[:part], dct2(x[:part].contiguous()))
        print(f"the DCT GEMM at float32 on the card: the first {part} of {len(x)} frames "
              f"transformed alone differ from the same rows of the whole batch in "
              f"{int((whole != alone).sum())} of {whole.size} coefficients (max |d| "
              f"{float(np.abs(whole - alone).max())})")
    for i, form in enumerate(tally.unchecked()):
        held_form(torch, kernels, dev, form, 9000 + i)
    tally.require_held("the sharded phase")
    print(f"forms the sharded phase launched ({len(tally.seen)}), each held against its plain "
          f"version: " + ", ".join(f"{f}: {c}" for f, c in sorted(tally.seen.items(), key=str)))
    return res


#: the local split's logical devices on one card (`batch._data_devices`)
LOCAL_BLOCKS = 4
#: decoded float32 PCM of one stream, split against one call, at 2048-sample
#: frames: the GEMMs of a block's rows sum in another order than the whole
#: batch's. A float32 sum's rounding grows with its terms: at N samples a
#: frame the bound is N / 2048 times this (hires_96k_8ch: 8e-6)
LOCAL_SPLIT_MAX_ABS = 2e-6
#: the same with the int16 emit (`i16_transfer`): a sample whose float32
#: value moves by an ulp may round one int16 step the other way
LOCAL_SPLIT_I16_MAX_ABS = 1.0 / 32768.0
#: the local split's configurations: (name, seconds, srate, channels,
#: profile, bits, frame size, float32 encode / decode options, float32 SNR
#: floor, frames the floor is taken over (None: all)); Profile 2 at 5 s is
#: held to the floor of that content at float64 (the JAX package's SNR
#: there minus 0.1 dB) and to the unsplit call's SNR
LOCAL_SPLIT_CASES = (
    ("p1_stereo_44k1", SECONDS, SRATE, CHANNELS, 1, BITS, FSIZE, dict(i16_upload=True),
     dict(i16_transfer=True), SNR_FLOOR_DB, None),
    ("p0_stereo_44k1", SECONDS, SRATE, CHANNELS, 0, P0_BITS, FSIZE, {}, {}, P0_SNR_FLOOR_DB,
     None),
    ("p0_stereo_44k1_i24", SECONDS, SRATE, CHANNELS, 0, P0_BITS, FSIZE, dict(i24_upload=True),
     dict(i24_transfer=True), P0_SNR_FLOOR_DB, None),
    ("hires_96k_8ch", HIRES["seconds"], HIRES["srate"], HIRES["channels"], 0, HIRES["bits"],
     HIRES["fsize"], {}, {}, HIRES_SNR_FLOOR_DB, HIRES_FLOOR_FRAMES),
    ("p2_stereo_44k1_5s", F64_SECONDS, SRATE, CHANNELS, 2, BITS, FSIZE, {}, {},
     F64_SNR_FLOOR_DB[2], None),
)


def sync_all(torch) -> None:
    """Wait for every visible card."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def header_plan(stream: bytes) -> list:
    from frad_python_tpu_torch.parallel.pipeline import _parse_frames

    hs, ps, tail = _parse_frames(stream)
    return [(h.profile, h.bit_depth_index, h.channels, h.srate, h.fsize, p is None)
            for h, p in zip(hs, ps)] + [tail]


def local_split_case(ft, torch, kernels, batch, devices, case: tuple, dtype: str) -> dict:
    """One configuration at `dtype` split over `devices` (patched into
    `batch._data_devices`) against the same calls in one piece
    (`sharding_disabled`): at float64 the stream and the decoded PCM bit
    for bit; at float32 the frame plan, the SNR floor and the decode of the
    unsplit stream within LOCAL_SPLIT_MAX_ABS scaled to the frame (as
    floats; with the int16 emit too, within LOCAL_SPLIT_I16_MAX_ABS), the
    payloads that differ
    counted. Returns walls, launches, blocks and the halo launches."""
    from frad_python_tpu_torch.parallel.pipeline import _parse_frames

    name, seconds, srate, ch, profile, bits, fsize, ekw, dkw, floor, floor_frames = case
    pcm = make_audio(seconds, srate, ch)
    if dtype == "float64":
        ekw, dkw = {}, {}
    dev = torch.device(DEVICE)

    def enc():
        return ft.batch_encode(pcm, profile, srate, bits, fsize, compute_dtype=dtype,
                               device=dev, **ekw)

    def dec(stream, **kw):
        return ft.batch_decode(stream, compute_dtype=dtype, device=dev, **{**dkw, **kw})[0]

    def walled(fn):
        t0 = time.perf_counter()
        out = fn()
        sync_all(torch)
        return out, time.perf_counter() - t0

    with batch.sharding_disabled():
        dec(enc())                                          # first-use set-up
        ref, t_enc1 = walled(enc)
        ref_out, t_dec1 = walled(lambda: dec(ref))
        ref_float = dec(ref, i16_transfer=False)
    real_devices, real_place = batch._data_devices, batch.place_rows
    placed = []

    def place(arr, device=None, upload=None, nreal=None):
        got = real_place(arr, device, upload, nreal)
        placed.append((arr.shape[0] if nreal is None else nreal, len(got.blocks), got.pad,
                       sorted({str(b.device) for b in got.blocks})))
        return got

    batch._data_devices, batch.place_rows = (lambda d: list(devices)), place
    try:
        dec(enc())
        placed.clear()
        sync_all(torch)
        kernels.reset_launches()
        got, t_enc = walled(enc)
        got_ref_out, t_dec = walled(lambda: dec(ref))
        launches = {k.__name__: k.launches for k in kernels.KERNELS}
        got_out = dec(got)
        got_ref_float = dec(ref, i16_transfer=False)
    finally:
        batch._data_devices, batch.place_rows = real_devices, real_place
    split = [p for p in placed if p[1] > 1]
    if not split or any(p[1] != len(devices) for p in split):
        raise AssertionError(f"local split {name} {dtype}: blocks {placed}")
    differ = sum(a != b for a, b in zip(_parse_frames(got)[1], _parse_frames(ref)[1]))
    m = len(pcm) if floor_frames is None else floor_frames * fsize
    snr = snr_db(pcm[:m], got_out[:m])
    d, d_float = (float(np.abs(a - b).max()) if a.shape == b.shape else float("inf")
                  for a, b in ((got_ref_out, ref_out), (got_ref_float, ref_float)))
    tol = LOCAL_SPLIT_MAX_ABS * max(fsize, FSIZE) / FSIZE
    need = {0: ("trunc_pack", "trunc_unpack") if dtype == "float32" else (),
            1: P1_KERNELS if dtype == "float32" else
            tuple(k for k in P1_KERNELS if k != "egr_pack"), 2: P2_KERNELS}[profile]
    if ekw.get("i24_upload"):
        need = need + ("i24_pack", "i24_unpack")
    missing = [k for k in need if launches[k] <= 0]
    if dtype == "float64":
        ok = got == ref and got_ref_out.shape == ref_out.shape \
            and np.array_equal(got_ref_out, ref_out) and np.array_equal(got_out, ref_out)
    else:
        ok = header_plan(got) == header_plan(ref) and snr >= floor \
            and d_float <= tol and d <= (
                LOCAL_SPLIT_I16_MAX_ABS if dkw.get("i16_transfer") else tol) \
            and (profile != 2 or snr >= snr_db(
                pcm[:m], ref_out[:m]) - 0.1)
    if not ok or missing or not np.isfinite(got_out).all():
        raise AssertionError(
            f"local split {name} {dtype} over {len(devices)} blocks: stream equal "
            f"{got == ref}, plan equal {header_plan(got) == header_plan(ref)}, {differ} payloads "
            f"differ, SNR {snr:.4f} dB (floor {floor}), max |split - one call| {d} (as floats "
            f"{d_float}; tolerance {tol}), kernels not launched {missing}")
    over = "" if floor_frames is None else f" over the first {floor_frames} frames"
    print(f"local split {name} {dtype} over {sorted(set(map(str, devices)))} x "
          f"{len(devices)}: blocks (rows, blocks, pad, cards) {sorted(set(map(str, split)))}; "
          f"stream equal {got == ref}, {differ} of {len(header_plan(ref)) - 1} payloads differ, "
          f"SNR {snr:.4f} dB (floor {floor}{over}), "
          f"max |split - one call| decoding one stream {d} (as floats {d_float}; tolerance "
          f"{tol}); walls enc {t_enc:.4f} s (one call "
          f"{t_enc1:.4f} s), dec {t_dec:.4f} s (one call {t_dec1:.4f} s); launches {launches}")
    return {"launches": launches, "t_enc": t_enc, "t_dec": t_dec, "t_enc1": t_enc1,
            "t_dec1": t_dec1, "differ": differ}


def local_split_phase(ft, torch, kernels) -> dict:
    """The frame-batch split of `models/batch.py` on the card: every
    LOCAL_SPLIT_CASES configuration at float32 and float64 over
    LOCAL_BLOCKS logical devices of one card ([cuda:0] * 4 patched into
    `_data_devices`), and when the machine shows more than one card, over
    all of them, each against the same calls in one piece
    (`local_split_case`). A tally over the split runs holds every form they
    launch against the plain versions (on inputs of that form) and counts
    the overlap-adds with a halo. Returns each run's results."""
    from frad_python_tpu_torch.models import batch

    dev = torch.device(DEVICE)
    sharding, batch.SHARDING = batch.SHARDING, True
    card = torch.device("cuda", torch.cuda.current_device()) if dev.type == "cuda" else dev
    layouts = [[card] * LOCAL_BLOCKS]
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        layouts.append([torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    res = {}
    tally = FormTally()
    with tally, contextlib.ExitStack() as restore:
        restore.callback(setattr, batch, "SHARDING", sharding)
        for devices in layouts:
            for case in LOCAL_SPLIT_CASES:
                # the int24 transfer forms are float32's: at float64 that
                # case is p0_stereo_44k1's
                for dtype in ("float32",) if case[7].get("i24_upload") else ("float32", "float64"):
                    res[(len(set(devices)), case[0], dtype)] = local_split_case(
                        ft, torch, kernels, batch, devices, case, dtype)
    halos = {f: c for f, c in tally.seen.items() if f[0] == "overlap_add" and f[-1] == "halo"}
    if not halos:
        raise AssertionError("the local split launched no overlap_add with a halo")
    for i, form in enumerate(tally.unchecked()):
        held_form(torch, kernels, dev, form, 9500 + i)
    tally.require_held("the local split phase")
    print(f"local split: overlap_add launches with a halo {sum(halos.values())} ({halos}); "
          f"forms launched ({len(tally.seen)}), each held against its plain version: "
          + ", ".join(f"{f}: {c}" for f, c in sorted(tally.seen.items(), key=str)))
    res["halo_launches"] = sum(halos.values())
    return res


def _frames_of(pcm: np.ndarray) -> list:
    from frad_python_tpu_torch.parallel.pipeline import plan_frames
    return plan_frames(len(pcm), FSIZE, 16, True)[0]


def early_bounds(freqs, pcm, i16_emit: bool) -> dict:
    """The bounds of power_quant on the float32 spectra `freqs` [rows, bins]
    with a divisor and of overlap_add on the IDCT output `pcm` [b, c, nn]
    (int16 or float32 emit), at the shapes of the tensors timed."""
    rows, bins = freqs.shape
    b, c, nn = pcm.shape
    return {
        "power_quant": bound(rows * bins * 12, rows * bins * 8),
        "overlap_add": bound(b * c * nn * 4 + OLAP * 4 + b * CUT * c * (2 if i16_emit else 4)
                             + OLAP * c * 4, b * c * CUT * 2 + (b - 1) * c * OLAP * 3)}


def tns_bounds(lanes: int, n: int) -> dict:
    """The bound of tns_iir at [lanes, n], float32."""
    return {"tns_iir": bound(2 * lanes * n * 4 + lanes * 13 * 4, lanes * n * 25)}


def kernel_yardsticks(torch, thunks: dict, stream_thunks: dict, bounds: dict,
                      stream_bounds: dict) -> dict:
    """For the thirteen kernels at their main-path shapes (float32): the device
    time of one launch of each on its check's inputs (`thunks`, {kernel
    function name: call}; `egr_` sums egr_pack's three kernels) from one
    `torch.profiler` call, the same at STREAMING_SHAPES (`stream_thunks`)
    from a second, and each kernel's bound at both from the bytes it must
    move and the operations it does (`bounds`, `stream_bounds`: worked out
    beside the checks, from the inputs of those same calls). A kernel that
    a recording did not keep is recorded again (`kept_device_ms`); one
    still missing fails the run."""
    if set(stream_thunks) != set(thunks) or len(thunks) != len(STREAMING_SHAPES):
        raise AssertionError(f"yardsticks: calls at the main shapes {sorted(thunks)}, at the "
                             f"streaming shapes {sorted(stream_thunks)}")

    def named(ms: dict) -> dict:
        return {("egr_pack" if k == "egr_" else k.removesuffix("_kernel")): v
                for k, v in ms.items()}

    device_ms, made = kept_device_ms(torch, thunks)
    stream_ms, stream_made = kept_device_ms(torch, stream_thunks)
    print(f"profiler recordings the kernels' device times took: {made} at the main shapes, "
          f"{stream_made} at the streaming shapes")
    stream_ms = named(stream_ms)
    device_ms = {("egr_pack_kernel" if k == "egr_" else k): v for k, v in device_ms.items()}
    if set(bounds) != set(STREAMING_SHAPES) or set(stream_bounds) != set(STREAMING_SHAPES):
        raise AssertionError(f"yardsticks: bounds of {sorted(bounds)} and {sorted(stream_bounds)}")
    print("device time of one launch each on its check's inputs, not the runs' data, one "
          "torch.profiler call (ms): "
          + ", ".join(f"{k.removesuffix('_kernel')} {v:.4f}" if v is not None
                      else f"{k.removesuffix('_kernel')} not in the trace"
                      for k, v in device_ms.items())
          + "; bounds (ms): " + ", ".join(f"{k} {v[0]:.5f} by {v[1]}" for k, v in bounds.items()))
    print("bounds at the streaming shapes (µs): "
          + ", ".join(f"{k} {v[0] * 1e3:.5g} by {v[1]}" for k, v in stream_bounds.items()))
    print("device time of one launch each at the streaming shapes, one torch.profiler call "
          "(ms): " + ", ".join(f"{k} {STREAMING_SHAPES[k]} "
                               + (f"{v:.4f}" if v is not None else "not in the trace")
                               for k, v in stream_ms.items()))
    missing = sorted(k for ms in (device_ms, stream_ms) for k, v in ms.items() if v is None)
    if missing:
        raise AssertionError(f"yardsticks: no device time in the traces for {missing}")
    return {"device_ms": {k.removesuffix("_kernel"): v for k, v in device_ms.items()},
            "stream_ms": stream_ms, "bounds": bounds, "stream_bounds": stream_bounds}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import frad_python_tpu_torch as ft
    from frad_python_tpu_torch import kernels, native
    from frad_python_tpu_torch.kernels import build
    from frad_python_tpu_torch.kernels.overlap_add import crossfade_window
    from frad_python_tpu_torch.models.profiles import compact
    from frad_python_tpu_torch.native import build as native_build
    from frad_python_tpu_torch.parallel import pipeline
    from frad_python_tpu_torch.parallel.pipeline import _parse_frames, plan_frames
    from frad_python_tpu_torch.utils.damage import damage_stream
    from frad_python_tpu_torch.utils.tracing import StageTimer

    # the phases before the local split hold one card's forms and launches:
    # on a machine with more cards they run on one, as does the command
    # line's subprocess (the local split turns the split on for itself)
    from frad_python_tpu_torch.models import batch

    if torch.cuda.device_count() > 1:
        batch.SHARDING = False
        os.environ["FRAD_TORCH_NO_SHARD"] = "1"

    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"card: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    dev = torch.device(DEVICE)

    # 2. build
    t0 = time.perf_counter()
    path, compiled = build.build()
    build.library()
    print(f"build: {'compiled' if compiled else 'cached'} {path.name} in "
          f"{time.perf_counter() - t0:.2f} s")

    # 2b. the C++ host module: every symbol binds, and its DEFLATE output
    # equals this machine's zlib.compress
    if not native.enabled():
        raise RuntimeError("FRAD_TORCH_NO_NATIVE is set: the main path must run the native module")
    t0 = time.perf_counter()
    npath, ncompiled = native_build.build()
    native.library()
    t_native = time.perf_counter() - t0
    check_native_pack(native)
    print(f"native: {'compiled' if ncompiled else 'cached'} {npath.name} in {t_native:.2f} s, "
          f"{len(native.SIGNATURES)} symbols bound, p1_pack_batch equals zlib.compress")

    # 3. kernels against their plain versions at the main path's shapes
    rng = np.random.default_rng(1234)
    freqs = (rng.standard_normal(POWER_QUANT_SHAPE) * 1e-2).astype(np.float32)
    # divisors over five decades, so symbols run from 0 to ~1e4 and many
    # land near a rounding boundary; the top bins divide by 0 as bins past
    # the last active band do
    div = (np.exp(rng.standard_normal(POWER_QUANT_SHAPE) * 2.0) * 0.1).astype(np.float32)
    div[:, -128:] = 0.0
    f_d, d_d = torch.from_numpy(freqs).to(dev), torch.from_numpy(div).to(dev)
    factor = 2.0 ** 15
    (got,), (want,) = held(kernels, "power_quant", f_d, d_d, factor)
    torch.cuda.synchronize()
    pq_err = float((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"power_quant differs from its plain version: max |d| {pq_err}")
    pq_ms = cuda_ms(torch, lambda: kernels.power_quant(f_d, d_d, factor))
    pq_plain_ms = cuda_ms(torch, lambda: kernels.power_quant_plain(f_d, d_d, factor))
    print(f"kernel power_quant {POWER_QUANT_SHAPE}: equal, max|d| {pq_err}, "
          f"{pq_ms:.4f} ms vs plain {pq_plain_ms:.4f} ms")

    pcm_k = torch.from_numpy(rng.standard_normal(OVERLAP_SHAPE).astype(np.float32) * 0.3).to(dev)
    w = crossfade_window(OLAP, dev)
    oa = {}
    oa_err = 0.0
    for i16 in (True, False):
        (out_k, frag_k), (out_p, frag_p) = held(kernels, "overlap_add", pcm_k, w, CUT, i16)
        torch.cuda.synchronize()
        err = max(float((out_k.double() - out_p.double()).abs().max()),
                  float((frag_k - frag_p).abs().max()))
        oa_err = max(oa_err, err)
        if not (torch.equal(out_k, out_p) and torch.equal(frag_k, frag_p)):
            raise AssertionError(f"overlap_add (i16={i16}) differs from its plain version: "
                                 f"max |d| {err}")
        oa[i16] = (cuda_ms(torch, lambda: kernels.overlap_add(pcm_k, w, CUT, i16)),
                   cuda_ms(torch, lambda: kernels.overlap_add_plain(pcm_k, w, CUT, i16)))
        print(f"kernel overlap_add {OVERLAP_SHAPE} i16={i16}: equal, max|d| {err}, "
              f"{oa[i16][0]:.4f} ms vs plain {oa[i16][1]:.4f} ms")

    # 3b. egr_pack, dequant, mask_thres and thres_expand at every form the
    # runs below launch them at; from here to the end a tally of their
    # launches holds the runs to that
    new = check_egr_dequant(torch, kernels, dev)
    thres = check_thres_kernels(torch, kernels, dev)
    tally_stack = contextlib.ExitStack()
    new_forms = tally_stack.enter_context(
        FormTally(only=("egr_pack", "dequant", "mask_thres", "thres_expand")))

    # 4. the slice end to end on the card
    pcm = make_audio(SECONDS, SRATE, CHANNELS)
    warm = make_audio(1.0, SRATE, CHANNELS)          # first-use set-up outside the timing
    ft.batch_decode(ft.batch_encode(warm, 1, SRATE, BITS, FSIZE, i16_upload=True, device=dev),
                    i16_transfer=True, device=dev)
    torch.cuda.synchronize()
    check_threshold_chains(ft, torch, dev)

    pipeline.STAGES = stages = StageTimer()
    kernels.reset_launches()
    native.reset_calls()
    egr_words_before = new_forms.egr_words
    t0 = time.perf_counter()
    stream = ft.batch_encode(pcm, 1, SRATE, BITS, FSIZE, i16_upload=True, device=dev)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    out, srate = ft.batch_decode(stream, i16_transfer=True, device=dev)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    calls = {w.__name__: w.calls for w in native.WRAPPERS}
    pipeline.STAGES = None
    main_egr_words = new_forms.egr_words - egr_words_before

    frames, terms = plan_frames(len(pcm), FSIZE, 16, True)
    headers, payloads, tail = _parse_frames(stream)
    n_payload = sum(p is not None for p in payloads)
    n_term = sum(p is None for p in payloads)
    if (n_payload, n_term, tail) != (len(frames), terms, b""):
        raise AssertionError(f"stream holds {n_payload} frames + {n_term} terminators, "
                             f"plan says {len(frames)} + {terms}")
    dlens = [compact.get_samples_min_ge(ln) for _, ln in frames]
    expect = sum(d * 15 // 16 for d in dlens) + (dlens[-1] - dlens[-1] * 15 // 16)
    if out.shape != (expect, CHANNELS) or srate != SRATE:
        raise AssertionError(f"decoded {out.shape} at {srate} Hz, expected ({expect}, {CHANNELS})")
    if not np.isfinite(out).all():
        raise AssertionError("decoded PCM is not finite")
    snr = snr_db(pcm, out)
    if snr < SNR_FLOOR_DB:
        raise AssertionError(f"SNR {snr:.4f} dB below the floor {SNR_FLOOR_DB} dB")
    for name in P1_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the main path")
    if launches["thres_expand"]:
        raise AssertionError("the main path launched thres_expand: a Profile 1 decode expands "
                             "its thresholds inside dequant")
    for name in ("p1_pack_batch", "frame_pack_batch", "frame_parse_batch", "p1_unpack_batch"):
        if calls[name] <= 0:
            raise AssertionError(f"native {name} was not called by the main path")
    print(f"slice: {len(frames)} frames + {terms} terminators, {len(stream)} bytes, "
          f"{out.shape[0]} samples, SNR {snr:.4f} dB (floor {SNR_FLOOR_DB}), "
          f"enc {len(frames) / t_enc:.1f} frames/s ({t_enc:.3f} s), "
          f"dec {len(frames) / t_dec:.1f} frames/s ({t_dec:.3f} s), launches {launches}, "
          f"native calls {calls}; egr_pack's compacted words copied back: {main_egr_words} "
          f"({main_egr_words * 4} bytes as int32)")
    print(f"stages p1 batch encode + decode: {stage_summary(stages)}")

    # 5. the card's stream decoded on the CPU (plain versions)
    out_cpu, _ = ft.batch_decode(stream, i16_transfer=True, device="cpu")
    d = float(np.abs(out_cpu - out).max()) if out_cpu.shape == out.shape else float("inf")
    if d > CARD_VS_CPU_MAX_ABS:
        raise AssertionError(f"card vs CPU decode differ by {d} > {CARD_VS_CPU_MAX_ABS}")
    print(f"card vs cpu decode: max|d| {d} (tolerance {CARD_VS_CPU_MAX_ABS}), "
          f"cpu SNR {snr_db(pcm, out_cpu):.4f} dB")

    # 6. the same track armored, damaged, repaired and decoded with repair
    kernels.reset_launches()
    native.reset_calls()
    t0 = time.perf_counter()
    armored = ft.batch_encode(pcm, 1, SRATE, BITS, FSIZE, i16_upload=True, enable_ecc=True,
                              ecc_ratio=ECC_RATIO, device=dev)
    torch.cuda.synchronize()
    t_enc_e = time.perf_counter() - t0
    damaged = damage_stream(armored)
    t0 = time.perf_counter()
    repaired = ft.batch_repair(damaged, ECC_RATIO)
    t_rep = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_fixed, _ = ft.batch_decode(damaged, fix_error=True, i16_transfer=True, device=dev)
    torch.cuda.synchronize()
    t_dec_e = time.perf_counter() - t0
    out_clean, _ = ft.batch_decode(armored, i16_transfer=True, device=dev)
    torch.cuda.synchronize()
    launches_e = {k.__name__: k.launches for k in kernels.KERNELS}
    calls_e = {w.__name__: w.calls for w in native.WRAPPERS}

    headers, payloads, tail = _parse_frames(armored)
    n_payload = sum(p is not None for p in payloads)
    n_term = sum(p is None for p in payloads)
    if (n_payload, n_term, tail) != (len(frames), terms, b""):
        raise AssertionError(f"armored stream holds {n_payload} frames + {n_term} "
                             f"terminators, plan says {len(frames)} + {terms}")
    if not all(h.ecc for h in headers) or {(h.ecc_dsize, h.ecc_codesize) for h, p in
                                           zip(headers, payloads) if p is not None} != {ECC_RATIO}:
        raise AssertionError(f"armored stream headers do not all carry ECC at {ECC_RATIO}")
    if damaged == armored or len(damaged) != len(armored):
        raise AssertionError("damage_stream must change bytes and keep the length")
    if repaired != armored:
        raise AssertionError("batch_repair of the damaged stream differs from the armored stream")
    if out_fixed.shape != out_clean.shape or not np.array_equal(out_fixed, out_clean):
        raise AssertionError("fix_error decode of the damaged stream differs from the clean decode")
    snr_e = snr_db(pcm, out_fixed)
    if snr_e < SNR_FLOOR_DB:
        raise AssertionError(f"ECC SNR {snr_e:.4f} dB below the floor {SNR_FLOOR_DB} dB")
    for name in P1_KERNELS:
        if launches_e[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the ECC path")
    for name in ("unarmor_batch", "frame_pack_batch"):
        if calls_e[name] <= 0:
            raise AssertionError(f"native {name} was not called by the ECC path")
    print(f"ecc {ECC_RATIO}: {len(armored)} bytes ({len(armored) / len(stream):.4f}x), "
          f"damaged {sum(a != b for a, b in zip(armored, damaged))} bytes, repaired equal, "
          f"fix_error decode equal to clean, SNR {snr_e:.4f} dB, "
          f"enc {len(frames) / t_enc_e:.1f} frames/s ({t_enc_e:.3f} s), "
          f"repair {len(frames) / t_rep:.1f} frames/s ({t_rep:.3f} s), "
          f"dec fix_error {len(frames) / t_dec_e:.1f} frames/s ({t_dec_e:.3f} s), "
          f"launches {launches_e}, native calls {calls_e}")

    # 7. the streaming engines: kernels at their shapes, then the track as
    # s16le bytes through Encoder, Decoder and Repairer
    from frad_python_tpu_torch.models import profile1

    pq_s_err, oa_s_err = check_stream_shapes(torch, kernels, crossfade_window, dev)
    raw = to_s16le(pcm)
    warm_raw = to_s16le(warm)                  # first-use set-up outside the timing
    for push in (PUSH, len(warm_raw)):
        warm_s = stream_encode(ft, torch, warm_raw, push, dev)
    stream_decode(ft, torch, warm_s, PUSH, dev)
    stream_decode(ft, torch, warm_s, PUSH, dev, exact=True)

    kernels.reset_launches()
    with FrameTally(pipeline, profile1) as enc_tally:
        s32, t_s_enc = timed(torch, lambda: stream_encode(ft, torch, raw, PUSH, dev))
    launches_s_enc = {k.__name__: k.launches for k in kernels.KERNELS}
    sdeep, t_s_deep = timed(torch, lambda: stream_encode(ft, torch, raw, len(raw), dev))
    h32, p32, tail32 = _parse_frames(s32)
    hdeep, pdeep, taildeep = _parse_frames(sdeep)
    if ([p is None for p in p32] != [p is None for p in pdeep] or tail32 or taildeep
            or sum(p is not None for p in p32) != len(frames)
            or sum(p is None for p in p32) != terms):
        raise AssertionError("streaming encodes do not follow the frame plan")
    differ = sum(a != b for a, b in zip(p32, pdeep) if a is not None)

    kernels.reset_launches()
    with FrameTally(pipeline, profile1) as dec_tally:
        (out_s, ttfa), t_s_dec = timed(torch, lambda: stream_decode(ft, torch, s32, PUSH, dev))
    launches_s_dec = {k.__name__: k.launches for k in kernels.KERNELS}
    (out_x, ttfa_x), t_s_exact = timed(
        torch, lambda: stream_decode(ft, torch, s32, PUSH, dev, exact=True))
    out_b, _ = ft.batch_decode(s32, i16_transfer=False, device=dev)
    if out_s.shape != out_b.shape or out_x.shape != out_b.shape:
        raise AssertionError(f"streaming decodes {out_s.shape}, {out_x.shape} against "
                             f"batch {out_b.shape}")
    d_sb = float(np.abs(out_s - out_b).max())
    if d_sb > STREAM_VS_BATCH_MAX_ABS:
        raise AssertionError(f"streaming decode differs from batch_decode by {d_sb} > "
                             f"{STREAM_VS_BATCH_MAX_ABS}")
    snr_s, snr_x = snr_db(pcm, out_s), snr_db(pcm, out_x)
    if not (np.isfinite(out_s).all() and np.isfinite(out_x).all()):
        raise AssertionError("streaming decode is not finite")
    if min(snr_s, snr_x) < SNR_FLOOR_DB:
        raise AssertionError(f"streaming SNR {snr_s:.4f} / exact {snr_x:.4f} dB below the "
                             f"floor {SNR_FLOOR_DB} dB")
    if launches_s_enc["power_quant"] <= 0 or launches_s_dec["overlap_add"] <= 0 \
            or launches_s_dec["thres_expand"]:
        raise AssertionError(f"streaming phase launches: encode {launches_s_enc}, "
                             f"decode {launches_s_dec}")
    n = len(frames)
    print(f"stream: enc {PUSH}-byte pushes {t_s_enc:.3f} s ({n / t_s_enc:.1f} frames/s), "
          f"enc one push {t_s_deep:.3f} s ({n / t_s_deep:.1f} frames/s), payloads differing "
          f"{differ} of {n}; dec {PUSH}-byte pushes {t_s_dec:.3f} s ({n / t_s_dec:.1f} "
          f"frames/s, first audio after {ttfa * 1e3:.2f} ms), dec exact {t_s_exact:.3f} s "
          f"({n / t_s_exact:.1f} frames/s, first audio after {ttfa_x * 1e3:.2f} ms); "
          f"max|stream - batch| {d_sb} (tolerance {STREAM_VS_BATCH_MAX_ABS}), SNR "
          f"{snr_s:.4f} / exact {snr_x:.4f} dB; frames per call: enc {enc_tally.used()}, "
          f"dec {dec_tally.used()}; launches enc {launches_s_enc}, dec {launches_s_dec}")

    kernels.reset_launches()
    armored_s, t_s_enc_e = timed(
        torch, lambda: stream_encode(ft, torch, raw, PUSH, dev, ecc=ECC_RATIO))
    damaged_s = damage_stream(armored_s)

    def repair_pushes() -> bytes:
        rep = ft.Repairer(ECC_RATIO)
        parts = [rep.process(damaged_s[i:i + PUSH]) for i in range(0, len(damaged_s), PUSH)]
        return b"".join(parts) + rep.flush()

    repaired_s, t_s_rep = timed(torch, repair_pushes)
    (fixed_s, _), t_s_fix = timed(
        torch, lambda: stream_decode(ft, torch, damaged_s, PUSH, dev, fix_error=True))
    clean_s, _ = stream_decode(ft, torch, armored_s, PUSH, dev, fix_error=True)
    launches_s_ecc = {k.__name__: k.launches for k in kernels.KERNELS}
    if damaged_s == armored_s or repaired_s != armored_s \
            or repaired_s != ft.batch_repair(damaged_s, ECC_RATIO):
        raise AssertionError("Repairer of the damaged stream differs from batch_repair or "
                             "from the armored stream")
    if fixed_s.shape != clean_s.shape or not np.array_equal(fixed_s, clean_s):
        raise AssertionError("fix_error streaming decode of the damaged stream differs from "
                             "the clean streaming decode")
    if snr_db(pcm, fixed_s) < SNR_FLOOR_DB or min(launches_s_ecc[k] for k in P1_KERNELS) <= 0:
        raise AssertionError(f"ECC streaming: SNR {snr_db(pcm, fixed_s):.4f} dB, launches "
                             f"{launches_s_ecc}")
    stream_launches = {k: launches_s_enc[k] + launches_s_dec[k] + launches_s_ecc[k]
                       for k in launches_s_enc}
    print(f"stream ecc {ECC_RATIO}: enc {t_s_enc_e:.3f} s ({n / t_s_enc_e:.1f} frames/s), "
          f"damaged {sum(a != b for a, b in zip(armored_s, damaged_s))} bytes, Repairer "
          f"{t_s_rep:.3f} s ({n / t_s_rep:.1f} frames/s) equal to batch_repair and the "
          f"armored stream, dec fix_error {t_s_fix:.3f} s ({n / t_s_fix:.1f} frames/s) equal "
          f"to the clean streaming decode, SNR {snr_db(pcm, fixed_s):.4f} dB, launches "
          f"{launches_s_ecc}")

    # 8. the lossless profiles 0 and 4, and Profile 1 above the GEMM's cap
    lossless = lossless_phase(ft, torch, kernels, native, dev)
    mid, long = lossless[f"p1_{P1_MID_FSIZE}"], lossless[f"p1_{P1_LONG_FSIZE}"]

    # 9. Profile 2 (TNS), and the lossy profiles at float64
    p2 = tns_phase(ft, torch, kernels, native, dev)
    tns_lanes = TNS_SHAPES["float32"][0][0]
    big = p2[(tns_lanes, "float32")]
    ana = p2["analysis"]
    big_a = ana[(tns_lanes, "float32")]

    # 10. the command line, then the tally of egr_pack's and dequant's forms
    cli_phase(ft, torch, kernels, dev, pcm, smi)
    tally_stack.close()
    new_forms.require_held("the runs")
    print("forms at which the runs launched egr_pack, dequant, mask_thres and thres_expand, each "
          "held against its plain version above (form: launches): "
          + ", ".join(f"{f}: {c}" for f, c in sorted(new_forms.seen.items(), key=str)))

    # 11. the sharded path: NCCL at world size 1, the per-rank body by hand,
    # spanwise encodes
    shard = shard_phase(ft, torch, kernels, dev)

    # 12. the frame-batch split of the batch cores over a card's logical
    # blocks, and over every card when there are more
    local_split_phase(ft, torch, kernels)

    i24 = lossless["i24"]
    f_s, d_s, pcm_s = f_d[:8].contiguous(), d_d[:8].contiguous(), pcm_k[:4].contiguous()
    yards = kernel_yardsticks(torch, {
        "power_quant_kernel": lambda: kernels.power_quant(f_d, d_d, factor),
        "overlap_add_kernel": lambda: kernels.overlap_add(pcm_k, w, CUT, True),
        **lossless["thunks"], **p2["thunks"], **new["thunks"], **thres["thunks"],
        **i24["thunks"]}, {
        "power_quant_kernel": lambda: kernels.power_quant(f_s, d_s, factor),
        "overlap_add_kernel": lambda: kernels.overlap_add(pcm_s, w, CUT, False),
        **lossless["stream_thunks"], **p2["stream_thunks"], **new["stream_thunks"],
        **thres["stream_thunks"], **i24["stream_thunks"]},
        {**early_bounds(f_d, pcm_k, True), **lossless["bounds"], **p2["bounds"],
         **new["bounds"], **thres["bounds"], **i24["bounds"]},
        {**early_bounds(f_s, pcm_s, False), **lossless["stream_bounds"], **p2["stream_bounds"],
         **new["stream_bounds"], **thres["stream_bounds"], **i24["stream_bounds"]})

    def yard(name: str) -> dict:
        """The keys every kernel's entry carries beside its own times:
        its bound, `bound_ms_streaming` (the same at `streaming_shape`),
        `library_ms` (no single PyTorch call computes any of the thirteen
        functions), `device_ms_synthetic` (one launch on the check's
        inputs under the profiler, not the runs' data), `device_ms_streaming`
        (the same at `streaming_shape`), and for the
        kernels of the Profile 2 path their launches there."""
        out = {"bound_ms": yards["bounds"][name][0], "bound_by": yards["bounds"][name][1],
               "bound_ms_streaming": yards["stream_bounds"][name][0],
               "library_ms": None, "device_ms_synthetic": yards["device_ms"][name],
               "device_ms_streaming": yards["stream_ms"][name],
               "streaming_shape": STREAMING_SHAPES[name]}
        if name in P2_KERNELS:
            out.update(launches_p2=p2["launches"][name],
                       streaming_launches_p2=p2["stream_launches"][name])
        out["launches_sharded_step"] = sum(shard["launches"][dt][name] for dt in shard["launches"])
        return out

    halo = {f"{k}_{b}": v for b in (HALO_SHAPES[0][0], HALO_SHAPES[2][0])
            for k, v in (("ms", shard["halo"][b]["ms"]),
                         ("ms_no_halo", shard["halo"][b]["ms_no_halo"]),
                         ("plain_ms", shard["halo"][b]["plain_ms"]),
                         ("device_ms", shard["halo"][b]["device_ms"]),
                         ("device_ms_no_halo", shard["halo"][b]["device_ms_no_halo"]),
                         ("bound_ms", shard["halo"][b]["bound"][0]),
                         ("bound_by", shard["halo"][b]["bound"][1]))}

    print(json.dumps({"kernels": [
        {"name": "power_quant", "route": "cuda",
         "source": "frad_python_tpu_torch/csrc/power_quant.cu",
         "replaces": "frad_python_tpu/research/pallas_kernels.py:58",
         "launches": launches["power_quant"], "max_abs_err": max(pq_err, pq_s_err),
         "ms": pq_ms, "plain_ms": pq_plain_ms,
         "streaming_launches": stream_launches["power_quant"],
         "ms_8192": mid["pq_ms"], "plain_ms_8192": mid["pq_plain_ms"],
         "ms_16384": long["pq_ms"], "plain_ms_16384": long["pq_plain_ms"],
         "ms_nodiv": p2["pq_nodiv_float32"][0], "plain_ms_nodiv": p2["pq_nodiv_float32"][1],
         "ms_f64": p2["pq_div_float64"][0], "plain_ms_f64": p2["pq_div_float64"][1],
         **yard("power_quant")},
        {"name": "overlap_add", "route": "cuda",
         "source": "frad_python_tpu_torch/csrc/overlap_add.cu",
         "replaces": "frad_python_tpu/research/pallas_kernels.py:90",
         "launches": launches["overlap_add"], "max_abs_err": max(oa_err, oa_s_err),
         "ms": oa[True][0], "plain_ms": oa[True][1],
         "ms_f32": oa[False][0], "plain_ms_f32": oa[False][1],
         "streaming_launches": stream_launches["overlap_add"],
         "ms_8192": mid["oa_ms"], "plain_ms_8192": mid["oa_plain_ms"],
         "ms_16384": long["oa_ms"], "plain_ms_16384": long["oa_plain_ms"],
         "ms_f64": p2["oa_f64"][0], "plain_ms_f64": p2["oa_f64"][1],
         "max_abs_err_halo": shard["halo"]["err"], "halo": halo, **yard("overlap_add")},
        {"name": "trunc_pack", "route": "cuda",
         "source": "frad_python_tpu_torch/csrc/trunc_pack.cu",
         "replaces": "frad_python_tpu/ops/bitpack.py:184",
         "launches": lossless["launches"]["trunc_pack"], "max_abs_err": lossless["pack_err"],
         "ms": lossless["pack_ms"], "plain_ms": lossless["pack_plain_ms"],
         **yard("trunc_pack")},
        {"name": "trunc_unpack", "route": "cuda",
         "source": "frad_python_tpu_torch/csrc/trunc_unpack.cu",
         "replaces": "frad_python_tpu/ops/bitpack.py:218",
         "launches": lossless["launches"]["trunc_unpack"],
         "max_abs_err": lossless["unpack_err"],
         "ms": lossless["unpack_ms"], "plain_ms": lossless["unpack_plain_ms"],
         **yard("trunc_unpack")},
        {"name": "tns_iir", "route": "cuda",
         "source": "frad_python_tpu_torch/csrc/tns_iir.cu",
         "replaces": "frad_python_tpu/ops/tns_jax.py:96",
         "launches": p2["launches"]["tns_iir"], "max_abs_err": p2["iir_err"],
         "ms": big["iir"], "plain_ms": big["iir_plain"],
         "ms_f64": p2[(tns_lanes, "float64")]["iir"],
         "ms_8_lanes": p2[(8, "float32")]["iir"], **yard("tns_iir")},
        {"name": "egr_pack", "route": "cuda",
         "source": "frad_python_tpu_torch/csrc/egr_pack.cu",
         "replaces": "frad_python_tpu/ops/bitpack.py:34",
         "launches": launches["egr_pack"], "max_abs_err": new["egr_err"],
         "ms": new["egr_ms"], "plain_ms": new["egr_plain_ms"],
         "ms_4_rows": new["egr_ms_4"], "plain_ms_4_rows": new["egr_plain_ms_4"],
         "streaming_launches": stream_launches["egr_pack"],
         "words_copied_back": main_egr_words, **yard("egr_pack")},
        {"name": "dequant", "route": "cuda",
         "source": "frad_python_tpu_torch/csrc/dequant.cu",
         "replaces": "frad_python_tpu/models/batch.py:350",
         "launches": launches["dequant"], "max_abs_err": new["deq_err"],
         "ms": new["deq_ms"], "plain_ms": new["deq_plain_ms"],
         "ms_4_frames": new["deq_4_ms"], "plain_ms_4_frames": new["deq_4_plain_ms"],
         "streaming_launches": stream_launches["dequant"], **yard("dequant")},
        {"name": "tns_autocorr", "route": "cuda",
         "source": "frad_python_tpu_torch/csrc/tns_autocorr.cu",
         "replaces": "frad_python_tpu/ops/tns_jax.py:31",
         "launches": p2["launches"]["tns_autocorr"], "max_abs_err": ana["ac_err"],
         "ms": big_a["ac"], "plain_ms": big_a["ac_plain"],
         "ms_f64": ana[(tns_lanes, "float64")]["ac"],
         "plain_ms_f64": ana[(tns_lanes, "float64")]["ac_plain"],
         "ms_8_lanes": ana[(8, "float32")]["ac"],
         "plain_ms_8_lanes": ana[(8, "float32")]["ac_plain"], **yard("tns_autocorr")},
        {"name": "tns_fir_gate", "route": "cuda",
         "source": "frad_python_tpu_torch/csrc/tns_fir_gate.cu",
         "replaces": "frad_python_tpu/ops/tns_jax.py:45, frad_python_tpu/ops/tns_jax.py:87",
         "launches": p2["launches"]["tns_fir_gate"], "max_abs_err": ana["fg_err"],
         "ms": big_a["fg"], "plain_ms": big_a["fg_plain"],
         "ms_f64": ana[(tns_lanes, "float64")]["fg"],
         "plain_ms_f64": ana[(tns_lanes, "float64")]["fg_plain"],
         "ms_8_lanes": ana[(8, "float32")]["fg"],
         "plain_ms_8_lanes": ana[(8, "float32")]["fg_plain"], **yard("tns_fir_gate")},
        {"name": "mask_thres", "route": "cuda",
         "source": "frad_python_tpu_torch/csrc/mask_thres.cu",
         "replaces": "frad_python_tpu/ops/psycho.py:156, frad_python_tpu/ops/psycho.py:188",
         "launches": p2["launches"]["mask_thres"], "max_abs_err": thres["mt_err"],
         "ms": thres["mt_ms"], "plain_ms": thres["mt_plain_ms"],
         "ms_8_rows": thres["mt_4_ms"], "plain_ms_8_rows": thres["mt_4_plain_ms"],
         "launches_p1": launches["mask_thres"],
         "streaming_launches": stream_launches["mask_thres"], **yard("mask_thres")},
        {"name": "thres_expand", "route": "cuda",
         "source": "frad_python_tpu_torch/csrc/thres_expand.cu",
         "replaces": "frad_python_tpu/models/batch.py:359, frad_python_tpu/ops/psycho.py:188",
         "launches": p2["launches"]["thres_expand"], "max_abs_err": thres["te_err"],
         "ms": thres["te_ms"], "plain_ms": thres["te_plain_ms"],
         "ms_4_frames": thres["te_4_ms"], "plain_ms_4_frames": thres["te_4_plain_ms"],
         "launches_p1": launches["thres_expand"],
         "streaming_launches": stream_launches["thres_expand"], **yard("thres_expand")},
        {"name": "i24_pack", "route": "cuda",
         "source": "frad_python_tpu_torch/csrc/i24_pack.cu",
         "replaces": "frad_python_tpu/ops/bitpack.py:124",
         "launches": i24["launches"]["i24_pack"], "max_abs_err": i24["pack_err"],
         "ms": i24["pack_ms"], "plain_ms": i24["pack_plain_ms"], **yard("i24_pack")},
        {"name": "i24_unpack", "route": "cuda",
         "source": "frad_python_tpu_torch/csrc/i24_unpack.cu",
         "replaces": "frad_python_tpu/ops/bitpack.py:137",
         "launches": i24["launches"]["i24_unpack"], "max_abs_err": i24["unpack_err"],
         "ms": i24["unpack_ms"], "plain_ms": i24["unpack_plain_ms"], **yard("i24_unpack")},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
