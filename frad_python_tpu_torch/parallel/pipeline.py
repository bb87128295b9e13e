"""Whole-file batch codec pipeline of profiles 0, 1, 2 and 4, with ECC
armor and repair.

`batch_encode` plans every frame of a stream up front, runs the tensor
domain on one device as one call over the uniform frames, and finishes
the byte domain on the host. Profile 1: PCM upload -> DCT/mask/quant core
-> `egr_pack` kernel (EGR bit-pack and compaction of each frame's used
words), then EGR thresholds and DEFLATE. Profile 2: the Profile 1 core
with the TNS analysis, then the host EGR coder and DEFLATE frame by frame. Profile 0: the DCT, then the truncated-float
pack, fused on the device (`trunc_pack` kernel) at float32 for 16/24/32
bits, or on the host (`packing`) after a float32 GEMM or float64 FFT
DCT; a frame whose coefficients leave the container float escalates to a
deeper depth. Profile 4 packs the PCM on the host. Then Reed-Solomon
armor and ASFH framing. `batch_decode` parses the frames on the host,
strips (and with `fix_error` repairs) the armor, decodes each uniform run
with one device call (Profile 1: dequant -> IDCT -> overlap-add; Profile
2: the same with the TNS synthesis before the IDCT; Profile
0: `trunc_unpack` kernel -> IDCT, or the host unpack and the IDCT), and
carries the overlap fragment across runs and terminators. `batch_repair`
re-armors a stream on the host alone.

The host byte domain runs in the C++ host module (`native`), threaded,
in a few batched calls per run; FRAD_TORCH_NO_NATIVE=1 selects the numpy
paths instead. Each step of the walk over a stream's frames is written
once: `_scan_frames` finds the frames (one C++ scan or its numpy twin) for
`batch_decode` and `batch_repair`; `_frame_batch` frames a group (one C++
pass, or frame by frame) for `batch_encode` and `batch_repair`; and the
run walk, `run_length` (how far a run of one header configuration
reaches), `batchable` (whether it decodes batched after the carried
overlap fragment) and `decode_blended` (`_decode_run`, then the crossfade
of the fragment into the run's head), serves `batch_decode` and the
streaming `Decoder`.

Streams are format-identical to the JAX package's `parallel.pipeline`:
fed the same quantised symbols, the packer and framer give the same
bytes, and `batch_repair` gives the JAX function's bytes. What a batch
cannot decode (a stream with no payload frame, an unparsable tail, a
fragment longer than the next run's emit window) goes to the streaming
`Decoder` with the carried overlap state, as in the JAX package; so do
frames of a reserved profile, which decode as profile 0, and a lossless
run the batch cannot split into frames (a payload of a partial value),
which the JAX package's `batch_decode` raises on.

At float64 the lossy profiles take the JAX package's float64 routes: int64
symbols through the host EGR coder, the Python payload unpack, no int16
upload or transfer. The JAX package's TPU transfer machinery (`_spans`,
`_put_concurrent`, `_fetch`, the upload thread pool) and its emulated-f64
routing (`_deep_transform_batch`) are not ported: each run is one device
call with pinned, non-blocking copies, and float64 runs on the device.

`STAGES` is the JAX pipeline's stage timer: None by default; set to a
`utils.tracing.StageTimer`, `batch_encode` and `batch_decode` (and the
engines, which call them) add each stage's host wall and the bytes copied
each way under the JAX package's stage names. A stage's wall is host time:
CUDA launches are asynchronous and the timer adds no synchronisation, so
the device time of `enc:core` / `dec:core` shows in the copy-back stage
that waits for it (`enc:d2h`, `dec:d2h`), as with XLA's dispatch. Some
stages open inside others: in Profiles 1 and 2 `enc:stage` (the native
pass that casts the frames from the track into the upload's buffer; the
numpy route's `enc:gather` and `enc:host-conv` instead), `enc:h2d` /
`dec:h2d` (the upload) inside `enc:core` / `dec:core`, whose rest is the launches;
`enc:pack-native` / `dec:unpack-native` (the C++ pass's wrapper, which
then logs the pass's counters in `native.p1_pack_batch.passes` /
`native.p1_unpack_batch.passes`) inside `enc:pack` / `dec:unpack`, whose
rest is the glue around it; likewise `enc:frame-native` (armor, headers,
CRCs: `native.frame_pack_batch.passes`) inside `enc:frame` and
`dec:unarmor-native` (CRC check, parity strip, repair:
`native.unarmor_batch.passes`) inside `dec:ecc`. The port adds those
four, `enc:stage`, `enc:host-conv` and `dec:emit` (the fragment heads of
`decode_blended` and `batch_decode`'s join of the PCM) to the JAX
package's names.
"""

from __future__ import annotations

import contextlib
import struct
import zlib

import numpy as np
import torch

from .. import models, native
from ..common import FRM_SIGN
from ..container import ecc as ecc_mod
from ..container.asfh import ASFH, COMPLETE, FORCE_FLUSH, INVALID
from ..kernels.egr_pack import egr_pack
from ..models import batch, profile0, profile1, profile2
from ..models.profiles import COMPACT, compact
from ..ops import bitpack, golomb, packing, policy, psycho
from ..ops.window import hanning_in_overlap
from ..repairer import DEFAULT_ECC_RATIO, sanitize_ecc_ratio
from ..utils.tracing import StageTimer

#: when set, the pipeline's stages add their host wall and link bytes here
STAGES: StageTimer | None = None
_NO_STAGE = contextlib.nullcontext()


def _stage(name: str):
    return _NO_STAGE if STAGES is None else STAGES.stage(name)


def _meter(direction: str, nbytes: int) -> None:
    """Record `nbytes` copied to ('h2d') or from ('d2h') the device."""
    if STAGES is not None:
        STAGES.add_bytes(direction, nbytes)


def _up(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """`policy.to_device`, metered."""
    _meter("h2d", arr.nbytes)
    return policy.to_device(arr, device)


def _down(*tensors: torch.Tensor) -> list[np.ndarray]:
    """`policy.to_host`, metered."""
    outs = policy.to_host(*tensors)
    _meter("d2h", sum(o.nbytes for o in outs))
    return outs


def plan_frames(total: int, fsize: int, overlap_ratio: int, is_compact: bool
                ) -> tuple[list[tuple[int, int]], int]:
    """The streaming engine's read plan.

    Returns ([(start, length), ...], n_terminators). Frame i covers
    samples [start, start+length); overlapping regions are re-read,
    mirroring the fragment carry. n_terminators is how many force-flush
    headers a process()+flush() sequence would emit (compact only).
    """
    n = compact.get_samples_min_ge(fsize) if is_compact else fsize
    olap_active = is_compact and overlap_ratio > 1

    frames: list[tuple[int, int]] = []
    pos = 0
    frag = 0
    while True:
        new = n - frag
        if pos + new > total:
            break
        frames.append((pos - frag, n))
        frag = (n - n * (overlap_ratio - 1) // overlap_ratio) if olap_active else 0
        pos += new

    remaining = total - pos
    has_tail = remaining > 0 or frag > 0
    if has_tail:
        frames.append((pos - frag, frag + remaining))

    if not is_compact:
        terms = 0
    else:
        terms = 2 if has_tail else 1
    return frames, terms


class _BlobParts:
    """A batch of equal-length payloads kept as ONE joined blob: the
    lossless packers emit a single-depth batch as one byte string, and the
    native framer slices it by offset instead of taking B bytes objects."""

    __slots__ = ("blob", "per", "bdi", "flen", "n")

    def __init__(self, blob: bytes, per: int, bdi: int, flen: int, n: int):
        self.blob, self.per, self.bdi, self.flen, self.n = blob, per, bdi, flen, n

    def as_parts(self) -> list[tuple[bytes, int, int]]:
        return [(self.blob[i * self.per:(i + 1) * self.per], self.bdi, self.flen)
                for i in range(self.n)]


def _asfh_for(profile: int, bit_depth_index: int, channels: int, srate: int, fsize: int,
              *, ecc: bool, ecc_ratio: tuple[int, int], little_endian: bool,
              overlap_ratio: int) -> ASFH:
    """A frame header of `profile` (compact or lossless layout)."""
    a = ASFH()
    a.profile = profile
    a.bit_depth_index = bit_depth_index
    a.channels = channels
    a.srate = srate
    a.fsize = fsize
    a.ecc = ecc
    a.ecc_dsize, a.ecc_codesize = ecc_ratio if ecc else (0, 0)
    a.endian = little_endian
    a.overlap_ratio = overlap_ratio
    return a


def _to_i16(a: np.ndarray) -> np.ndarray:
    """PCM -> int16 at x32768 (2 bytes/sample upload, -96 dB floor, far
    below the lossy profile's masking noise): the numpy route's cast, whose
    rounding and clamp `native.stage_frames` repeats."""
    return np.clip(np.rint(a * 32768.0), -32768, 32767).astype(np.int16)


def _gather(pcm: np.ndarray, frs: list[tuple[int, int]], length: int) -> np.ndarray:
    """[len(frs), length, C] frames (zero past the end of the PCM): a view
    of the PCM for contiguous non-overlapping frames (the lossless
    profiles), a copy otherwise."""
    s0 = frs[0][0]
    if s0 >= 0 and all(s == s0 + i * length for i, (s, _) in enumerate(frs)) \
            and s0 + len(frs) * length <= len(pcm):
        return pcm[s0: s0 + len(frs) * length].reshape(len(frs), length, pcm.shape[1])
    out = np.zeros((len(frs), length, pcm.shape[1]), dtype=np.float64)
    for i, (s, ln) in enumerate(frs):
        sa = max(s, 0)
        out[i, sa - s: ln] = pcm[sa: s + ln]
    return out


def _egr_pack_rows(rows: batch.Rows, max_words: int):
    """The `egr_pack` kernel on each block's real rows of int32 symbols, on
    its card -> (compacted words, used, total bits, k, overflow, threshold
    symbols), joined in frame order on the host, and {frame: symbols} of
    the frames whose stream overflowed `max_words` (for the host coder).
    The wrapper waits for a block's row sums to know its length, so the
    packs drain card by card, after every block's core was launched."""
    packs, syms = [], []
    with _stage("enc:egr-pack"):
        for (fq, _), k in zip(rows.blocks, rows.real()):
            if k:
                sym = (fq if k == len(fq) else fq[:k]).contiguous()
                syms.append(sym)
                packs.append(egr_pack(sym, max_words, False, _down))
    tqs = [tq if k == len(tq) else tq[:k] for (_, tq), k in zip(rows.blocks, rows.real()) if k]
    with _stage("enc:d2h"):
        hs = _down(*(p[0] for p in packs), *tqs)
    join = (lambda a: a[0]) if len(packs) == 1 else np.concatenate
    flat_h = join(hs[:len(packs)]).view(np.uint32)   # int32 words hold the uint32 bit pattern
    used_h, nbits_h, ks_h, ovf_h = (join([p[j] for p in packs]) for j in range(1, 5))
    fq_ovf: dict[int, np.ndarray] = {}
    if ovf_h.any():
        # (rare) frames whose stream overflowed max_words: host EGR, their
        # symbols fetched from the cards that hold them
        picks, first = [], 0
        for sym, p in zip(syms, packs):
            local = np.flatnonzero(p[4])
            if local.size:
                picks.append((first + local, sym[torch.as_tensor(local, device=sym.device)]))
            first += len(sym)
        with _stage("enc:d2h"):
            got = _down(*(t for _, t in picks))
        for (idx, _), h in zip(picks, got):
            fq_ovf.update(zip(idx.tolist(), h))
    return flat_h, used_h, nbits_h, ks_h, ovf_h, join(hs[len(packs):]), fq_ovf


def _place_frames(pcm: np.ndarray, frs: list[tuple[int, int]], dlen: int, dtype: str,
                  device: torch.device) -> batch.Placed:
    """The lossy encode's frames [B, dlen, C] (`_gather`'s, zero from flen
    on) as `dtype` (float32, float64, or int16 at x32768), uploaded row-split
    by `place_rows`. Natively one threaded pass (`enc:stage`) casts each
    frame from the track straight into the buffer that is uploaded: pinned
    on CUDA, with the split's padding rows zero. Without the native module,
    the float64 frames are gathered (`enc:gather`), then cast
    (`enc:host-conv`)."""
    b, flen, channels = len(frs), frs[0][1], pcm.shape[1]
    if not native.enabled():
        with _stage("enc:gather"):
            arr = _gather(pcm, frs, flen)
            if dlen != flen:
                arr = np.pad(arr, ((0, 0), (0, dlen - flen), (0, 0)))
        with _stage("enc:host-conv"):
            arr = _to_i16(arr) if dtype == "int16" else arr.astype(dtype)
        with _stage("enc:h2d"):
            return batch.place_rows(arr, device, _up)
    with _stage("enc:stage"):
        shape = (batch.padded_rows(b, device), dlen, channels)
        if device.type == "cuda":
            buf = torch.empty(shape, dtype=getattr(torch, dtype), pin_memory=True)
            host = buf.numpy()
        else:
            buf = host = np.empty(shape, dtype)
        native.stage_frames(pcm, [s for s, _ in frs], flen, host[:b])
        host[b:] = 0
    with _stage("enc:h2d"):
        return batch.place_rows(buf, device, _up, nreal=b)


def _encode_frames(pcm: np.ndarray, frs: list[tuple[int, int]], profile: int, srate: int,
                   bit_depth: int, loss_level: float, dtype: str, i16_upload: bool,
                   device: torch.device) -> list[tuple[bytes, int, int]]:
    """Profile 1 or 2 payloads of equal-length frames: [(payload, bdi, flen)]."""
    if not frs:
        return []
    channels = pcm.shape[1]
    dlen, srate_v, ll = profile1.frame_params(frs[0][1], srate, loss_level)
    depths = models.BIT_DEPTHS[profile]
    bits = bit_depth if bit_depth in depths else 16
    factor = profile1._scale_factor(bits)
    bdi = depths.index(bits)
    b = len(frs)

    if profile == 2:
        # one core call a card, then the host EGR coder and DEFLATE per frame
        with _stage("enc:core"):
            placed = _place_frames(pcm, frs, dlen, dtype, device)
            rows = batch.run_rows(batch.p2_encode_core, (placed,), device, srate_v, ll, factor)
        with _stage("enc:d2h"):
            fqh, tqh, lqh = rows.fetch(_down)
        with _stage("enc:pack"):
            return [(profile2.pack_streams(fqh[i].ravel(), tqh[i].ravel(), lqh[i].ravel()),
                     bdi, frs[i][1]) for i in range(b)]

    i16 = i16_upload and dtype == "float32"
    with _stage("enc:core"):
        placed = _place_frames(pcm, frs, dlen, "int16" if i16 else dtype, device)
        rows = batch.run_rows(batch.p1_encode_core_i16 if i16 else batch.p1_encode_core,
                              (placed,), device, srate_v, ll, factor)
    m = dlen * channels
    # [B, N, C] -> interleaved rows, on each block's card
    rows = batch.Rows([(fq.reshape(-1, m), tq.reshape(-1, psycho.SUBBANDS * channels))
                       for fq, tq in rows.blocks], rows.pad)

    # single frames, depths over 24 bits (symbols may pass 2^23) and the
    # int64 symbols of float64 take the host EGR coder; the rest bit-pack
    # on the device, so the fetch carries the stream's own bytes instead
    # of int32 symbols
    if bits > 24 or b == 1 or dtype != "float32":
        with _stage("enc:d2h"):
            fqh, tqh = rows.fetch(_down)
        with _stage("enc:pack"):
            return [(profile1.pack_streams(fqh[i], tqh[i]), bdi, frs[i][1])
                    for i in range(b)]

    max_words = max(m * 12 // 32, 16)
    flat_h, used_h, nbits_h, ks_h, ovf_h, tqh, fq_ovf = _egr_pack_rows(rows, max_words)
    offs = np.cumsum(used_h, dtype=np.int64) - used_h

    with _stage("enc:pack"):
        if native.enabled():
            # one threaded C++ pass: threshold EGR, word serialisation and
            # DEFLATE of every frame, over the compacted words rebuilt into
            # rows padded to the widest frame
            w = max(int(used_h.max()), 1)
            flat_pad = np.concatenate([flat_h, np.zeros(w, dtype=np.uint32)])
            padded = flat_pad[offs[:, None] + np.arange(w)]
            with _stage("enc:pack-native"):
                payloads = native.p1_pack_batch(padded, nbits_h, ks_h, ovf_h, tqh,
                                                stats=STAGES is not None)
            return [(p if p is not None else profile1.pack_streams(fq_ovf[i], tqh[i]),
                     bdi, frs[i][1]) for i, p in enumerate(payloads)]

        results = []
        for i in range(b):
            if i in fq_ovf:
                freqs_gol = golomb.encode(fq_ovf[i])
            else:
                o = int(offs[i])
                freqs_gol = bitpack.words_to_stream(flat_h[o:o + int(used_h[i])],
                                                    nbits_h[i], ks_h[i])
            thres_gol = golomb.encode(tqh[i])
            frad = struct.pack(">I", len(thres_gol)) + thres_gol + freqs_gol
            results.append((zlib.compress(frad, wbits=-15), bdi, frs[i][1]))
        return results


def _encode_lossless(pcm: np.ndarray, frs: list[tuple[int, int]], profile: int,
                     bit_depth: int, little_endian: bool, dtype: str, i24_upload: bool,
                     device: torch.device) -> _BlobParts | list[tuple[bytes, int, int]]:
    """Profile 0 or 4 payloads of equal-length frames, as one joined blob
    when every frame keeps the stream depth, else [(payload, bdi, flen)]."""
    if not frs:
        return []
    channels = pcm.shape[1]
    flen = frs[0][1]
    b = len(frs)
    with _stage("enc:gather"):
        arr = _gather(pcm, frs, flen)
    base_bits = bit_depth if bit_depth in packing.DEPTHS else 16
    limit = packing.FLOAT_MAX[packing.DEPTHS.index(base_bits)]

    if profile == 0:
        if (dtype == "float32" and base_bits in bitpack.TRUNC_DEVICE_BITS
                and (flen * channels) % 4 == 0):
            # fast path: the DCT and the truncated-float pack on the
            # device, so both copies carry payload-sized bytes; a frame
            # that escalates sends the batch down the general path
            use_i24 = i24_upload and base_bits == 24
            with _stage("enc:h2d"):
                placed = batch.place_rows(
                    bitpack.pcm_to_i24_words_host(arr).reshape(b, -1).view(np.int32)
                    if use_i24 else arr.astype(np.float32), device, _up)
            with _stage("enc:core"):
                if use_i24:
                    rows = batch.run_rows(batch.p0_encode_pack_core_i24, (placed,), device,
                                          base_bits, little_endian, flen, channels)
                else:
                    rows = batch.run_rows(batch.p0_encode_pack_core, (placed,), device,
                                          base_bits, little_endian)
            with _stage("enc:d2h"):
                (maxabs,) = rows.fetch(_down, (1,))
            if np.all(maxabs <= limit):
                with _stage("enc:d2h"):
                    (words,) = rows.fetch(_down, (0,))
                return _BlobParts(words.tobytes(), words.shape[1] * words.itemsize,
                                  packing.DEPTHS.index(base_bits), flen, b)
        dt = "float64" if base_bits >= policy.DEEP_BITS else dtype
        with _stage("enc:core"):
            (coeffs,) = batch.run_rows(batch.p0_encode_core, (arr.astype(dt),), device,
                                       upload=_up).fetch(_down)
    else:
        coeffs = arr
    flat = coeffs.reshape(b, -1)
    fused_blob = None
    with _stage("enc:maxabs"):
        if not flat.size:
            maxabs = np.zeros(b)
        elif coeffs.dtype == np.float64 and base_bits != 12 and native.enabled():
            # one pass packs at the stream depth and takes each row's max; the
            # blob is used unless a row escalates
            fused_blob, maxabs = native.pack_floats_maxabs(flat, base_bits, little_endian)
        elif coeffs.dtype == np.float64 and native.enabled():
            maxabs = native.maxabs_rows(flat)
        else:
            maxabs = np.maximum(flat.max(axis=1), -flat.min(axis=1))
    if profile == 0 and coeffs.dtype != np.float64 and any(
            profile0._escalates_deep(float(m), base_bits) for m in maxabs):
        # escalation reaches a container deeper than float32 (perhaps
        # through an f32 overflow to inf): the whole batch again at float64
        (coeffs,) = batch.run_rows(batch.p0_encode_core, (arr,), device,
                                   upload=_up).fetch(_down)
        maxabs = np.max(np.abs(coeffs.reshape(b, -1)), axis=1)
    depths = [packing.needed_depth(float(m), base_bits) for m in maxabs]
    if fused_blob is not None and all(d == base_bits for d in depths):
        return _BlobParts(fused_blob, len(fused_blob) // b, packing.DEPTHS.index(base_bits),
                          flen, b)
    # frames grouped by depth, each group packed in one pass (byte-aligned
    # depths concatenate); 12-bit frames carry their own nibble padding
    results: list[tuple[bytes, int, int] | None] = [None] * b
    for d in sorted(set(depths)):
        idxs = [i for i, dd in enumerate(depths) if dd == d]
        bdi = packing.DEPTHS.index(d)
        if d == 12:
            for i in idxs:
                results[i] = (packing.pack_floats(coeffs[i].ravel(), d, little_endian), bdi,
                              frs[i][1])
            continue
        group = coeffs if len(idxs) == b else coeffs[idxs]
        with _stage("enc:host-pack"):
            blob = packing.pack_floats(group.reshape(-1), d, little_endian)
        per = len(blob) // len(idxs)
        if len(idxs) == b:
            return _BlobParts(blob, per, bdi, flen, b)
        for j, i in enumerate(idxs):
            results[i] = (blob[j * per:(j + 1) * per], bdi, frs[i][1])
    return results


def _frame_batch(parts: _BlobParts | list[tuple[bytes, int, int]], *, profile: int,
                 channels: int, srate: int, overlap_ratio: int, little_endian: bool,
                 ecc_ratio: tuple[int, int] | None) -> bytes:
    """Frames of one header configuration, from a `_BlobParts` or [(payload,
    bdi, flen)]: RS armor at `ecc_ratio` (None: no ECC), ASFH header and CRC
    per frame. One threaded C++ pass (`enc:frame-native`); frame by frame,
    as the JAX package frames, without the native module and for an ECC
    data size of 0 or less, which cannot be cut into blocks."""
    if not native.enabled() or (ecc_ratio is not None and ecc_ratio[0] <= 0):
        header = dict(ecc=ecc_ratio is not None, ecc_ratio=ecc_ratio or (0, 0),
                      little_endian=little_endian, overlap_ratio=overlap_ratio)
        if isinstance(parts, _BlobParts):
            parts = parts.as_parts()
        return b"".join(
            _asfh_for(profile, bdi, channels, srate, flen, **header).write(
                p if ecc_ratio is None else ecc_mod.encode(p, *ecc_ratio))
            for p, bdi, flen in parts)
    if isinstance(parts, _BlobParts):
        payloads = (parts.blob, np.arange(parts.n + 1, dtype=np.int64) * parts.per)
        bdis = np.full(parts.n, parts.bdi, np.uint8)
        flens = np.full(parts.n, parts.flen, np.uint32)
    else:
        payloads = [p for p, _, _ in parts]
        bdis = np.array([b for _, b, _ in parts], dtype=np.uint8)
        flens = np.array([f for _, _, f in parts], dtype=np.uint32)
    if profile in COMPACT:
        fidx_of = {fl: compact.get_samples_index(fl) for fl in set(flens.tolist())}
        fidx = np.fromiter((fidx_of[f] for f in flens.tolist()), np.uint8, len(flens))
        sidx = compact.get_srate_index(srate)
    else:
        fidx, sidx = None, 0
    dsize, codesize = ecc_ratio or (0, 0)
    with _stage("enc:frame-native"):
        return native.frame_pack_batch(
            payloads, bdis, flens, fidx, profile=profile, is_compact=profile in COMPACT,
            channels=channels, srate=srate, srate_idx=sidx, overlap_ratio=overlap_ratio,
            little_endian=little_endian, ecc=ecc_ratio is not None, ecc_dsize=dsize,
            ecc_codesize=codesize, stats=STAGES is not None)


def batch_encode(pcm: np.ndarray, profile: int, srate: int, bit_depth: int,
                 frame_size: int, *, loss_level: float = 0.5,
                 enable_ecc: bool = False,
                 ecc_ratio: tuple[int, int] = DEFAULT_ECC_RATIO,
                 little_endian: bool = False, overlap_ratio: int = 16,
                 compute_dtype: str | None = None, i16_upload: bool = False,
                 i24_upload: bool = False, final: bool = True,
                 device: str | torch.device | None = None) -> bytes:
    """Encode a whole [T, C] float PCM array into a FrAD stream of profile
    0, 1, 2 or 4.

    `device` defaults to CUDA and raises when none is present.
    `compute_dtype` (None: `policy.compute_dtype()`) is the transform's
    dtype, float32 or float64 (the 48- and 64-bit lossless containers
    always take float64). `i16_upload` sends Profile 1's PCM to the device
    as int16 (x32768) at float32; `i24_upload` sends Profile 0's
    PCM as int24 (x2^23) at 24 bits and float32. `enable_ecc` armors every
    payload with Reed-Solomon parity at `ecc_ratio` = (data bytes, parity
    bytes) per block; a ratio GF(256) cannot honor (data + parity > 255)
    raises ValueError. The lossless profiles frame without overlap and
    without terminators, and escalate a frame's depth when a value leaves
    the container float's range.

    `final=False` encodes a span that the stream continues after (the
    streaming Encoder's micro-batches): the trailing partial frame and the
    force-flush terminators are left out, so the next span, which re-reads
    the overlap, follows on byte for byte.
    """
    dtype = policy.check_compute_dtype(compute_dtype)
    dev = policy.resolve_device(device)
    pcm = np.asarray(pcm, dtype=np.float64)
    total, channels = pcm.shape
    is_compact = profile in COMPACT
    if is_compact:
        srate = compact.get_valid_srate(srate)
        loss_level = max(abs(loss_level), 0.125)
        overlap_ratio = overlap_ratio if overlap_ratio == 0 else max(2, min(256, overlap_ratio))
    else:
        overlap_ratio = 0
    header = dict(ecc=enable_ecc, ecc_ratio=ecc_ratio, little_endian=little_endian,
                  overlap_ratio=overlap_ratio)

    frames, terms = plan_frames(total, frame_size, overlap_ratio, is_compact)
    if not final:
        n_full = frames[0][1] if frames else 0
        frames = [f for f in frames if f[1] == n_full]
        terms = 0
        if not frames:
            return b""
    if not frames:
        if not is_compact:
            return b""
        a = _asfh_for(profile, 0, max(channels, 1), srate,
                      compact.get_samples_min_ge(frame_size), **header)
        return a.force_flush() * max(terms, 1)

    n = frames[0][1]
    uniform = [f for f in frames if f[1] == n]
    tail = frames[len(uniform):]            # 0 or 1 non-uniform tail frame
    if is_compact:
        groups = [g for g in (
            _encode_frames(pcm, uniform, profile, srate, bit_depth, loss_level, dtype,
                           i16_upload, dev),
            _encode_frames(pcm, tail, profile, srate, bit_depth, loss_level, dtype,
                           i16_upload, dev)) if g]
    else:
        groups = [g for g in (
            _encode_lossless(pcm, uniform, profile, bit_depth, little_endian, dtype,
                             i24_upload, dev),
            _encode_lossless(pcm, tail, profile, bit_depth, little_endian, dtype,
                             i24_upload, dev)) if g]

    with _stage("enc:frame"):
        framed = [_frame_batch(g, profile=profile, channels=channels, srate=srate,
                               overlap_ratio=overlap_ratio, little_endian=little_endian,
                               ecc_ratio=ecc_ratio if enable_ecc else None) for g in groups]
    if terms:
        _, last_bdi, last_flen = groups[-1][-1]
        framed.append(_asfh_for(profile, last_bdi, channels, srate, last_flen,
                                **header).force_flush() * terms)
    return b"".join(framed)


def _scan_frames(stream: bytes) -> tuple[list[ASFH], list[bytes | None], int, list[int]]:
    """The whole-stream frame scan -> (headers, payloads, tail_pos, starts):
    each header carries its raw bytes in `.buffer`, a force-flush
    terminator's payload is None, starts[i] is the offset of frame i's
    FRM_SIGN, tail_pos the offset of the unparsable tail (-1 when there is
    none). A sign whose header is Invalid is skipped: the scan resyncs
    behind it. One C++ pass (`native.frame_parse_batch`), or its numpy twin,
    the `ASFH.read` loop."""
    if not native.enabled():
        headers, payloads, starts = [], [], []
        pos, n = 0, len(stream)
        while (idx := stream.find(FRM_SIGN, pos)) >= 0:
            a = ASFH()
            status, _ = a.read(stream[idx: idx + 48])
            if status == INVALID:
                pos = idx + len(FRM_SIGN)         # not a header: resync behind its sign
                continue
            end = idx + a.header_bytes + (a.frmbytes if status == COMPLETE else 0)
            if status not in (COMPLETE, FORCE_FLUSH) or end > n:
                return headers, payloads, idx, starts
            headers.append(a)
            payloads.append(stream[idx + a.header_bytes: end] if status == COMPLETE else None)
            starts.append(idx)
            pos = end
        return headers, payloads, -1, starts
    (cnt, pay_off, pay_len, is_ff, pfb, chans, srates, fsizes, olaps,
     eccds, ecccs, crcs, hdrlens, tail_pos) = native.frame_parse_batch(stream)
    pfb = pfb[:cnt]
    rows = zip(pay_len[:cnt].tolist(), (pfb >> 5).tolist(),
               ((pfb >> 4) & 1).astype(bool).tolist(),
               ((pfb >> 3) & 1).astype(bool).tolist(), (pfb & 7).tolist(),
               chans[:cnt].tolist(), srates[:cnt].tolist(), fsizes[:cnt].tolist(),
               olaps[:cnt].tolist(), eccds[:cnt].tolist(), ecccs[:cnt].tolist(),
               crcs[:cnt].tolist(), hdrlens[:cnt].tolist(), is_ff[:cnt].tolist(),
               pay_off[:cnt].tolist())
    headers: list[ASFH] = []
    payloads: list[bytes | None] = []
    for (fb, prof, ecc, endian, bdi, ch, sr, fs, ol, ed, ec, crc, hl, ff, off) in rows:
        a = ASFH()
        a.frmbytes, a.profile, a.ecc, a.endian, a.bit_depth_index = fb, prof, ecc, endian, bdi
        a.channels, a.srate, a.fsize, a.overlap_ratio = ch, sr, fs, ol
        a.ecc_dsize, a.ecc_codesize, a.crc, a.header_bytes = ed, ec, crc, hl
        a.all_set = True
        a.buffer = stream[off - hl: off]
        headers.append(a)
        payloads.append(None if ff else stream[off: off + fb])
    starts = (pay_off[:cnt] - hdrlens[:cnt]).tolist()
    return headers, payloads, tail_pos, starts


def _parse_frames(stream: bytes) -> tuple[list[ASFH], list[bytes | None], bytes]:
    """`_scan_frames` -> (headers, payloads, unparsed tail bytes)."""
    headers, payloads, tail_pos, _ = _scan_frames(stream)
    return headers, payloads, (b"" if tail_pos < 0 else stream[tail_pos:])


def _run_key(h: ASFH):
    # the ECC ratio splits runs too: a run is unarmored with its first
    # header's ratio, so a mid-stream re-armor at a new ratio starts a new run
    return (h.profile, h.bit_depth_index, h.channels, h.srate, h.fsize,
            h.ecc, h.endian, h.overlap_ratio, h.ecc_dsize, h.ecc_codesize)


def _unarmor(hs: list[ASFH], ps: list[bytes], fix_error: bool) -> list[bytes]:
    """Strip the ECC armor of a run of frames that share hs[0]'s ratio;
    with `fix_error`, RS-repair every frame whose CRC mismatches."""
    h0 = hs[0]
    if native.enabled() and 0 < h0.ecc_dsize and 0 < h0.ecc_codesize \
            and h0.ecc_dsize + h0.ecc_codesize <= 255:
        # one threaded C++ pass: CRC verify + parity strip or RS repair
        crcs = np.fromiter((h.crc for h in hs), np.uint32, len(hs))
        with _stage("dec:unarmor-native"):
            return native.unarmor_batch(ps, h0.ecc_dsize, h0.ecc_codesize, crcs,
                                        h0.profile in COMPACT, fix_error,
                                        stats=STAGES is not None)[0]
    # ratios GF(256) cannot honor come only from hand-made headers: the
    # per-frame path strips their parity best-effort (container/ecc.py)
    return [ecc_mod.decode(p, h.ecc_dsize, h.ecc_codesize,
                           fix_error and not h.payload_crc_matches(p))
            for h, p in zip(hs, ps)]


def _frag_head(out: np.ndarray, frag: np.ndarray) -> np.ndarray:
    """Crossfade an incoming overlap fragment into the head of a decoded
    run (the batched overlap-add leaves frame 0's head fade-free). Returns
    the blended head, which `decode_blended` emits before out[len(frag):]."""
    take = len(frag)
    w = hanning_in_overlap(take, str(out.dtype)) if out.dtype.kind == "f" \
        else hanning_in_overlap(take)
    return out[:take] * w[:, None] + frag * w[::-1, None]


def _unpack_run(ps: list[bytes], n: int, ch: int, profile: int, dtype: str
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """Profile 1 or 2 payloads -> (freq symbols [B, n*ch], threshold
    symbols [B, 27*ch], and for Profile 2 LPC symbols [B, 13*ch], else
    None) as rows of `dtype`; a corrupt payload gives zero rows. float32
    takes the C++ unpack, float64 (and the numpy host path) the Python
    one."""
    tq_len = psycho.SUBBANDS * ch
    lq_len = profile2.ORDER1 * ch if profile == 2 else 0
    if native.enabled() and dtype == "float32":
        # one threaded C++ pass: inflate + EGR decode + untrim
        with _stage("dec:unpack-native"):
            fq, tq, lq, _ok = native.p1_unpack_batch(ps, n * ch, tq_len, lq_len,
                                                     stats=STAGES is not None)
        return fq, tq, lq
    fq = np.zeros((len(ps), n * ch), dtype=dtype)
    tq = np.zeros((len(ps), tq_len), dtype=dtype)
    lq = np.zeros((len(ps), lq_len), dtype=dtype) if profile == 2 else None
    for i, p in enumerate(ps):
        if profile == 2:
            s = profile2.unpack_streams(p)
            if s is not None:
                fq[i], tq[i], lq[i] = profile2.untrim_streams(s, n, ch)
            continue
        s = profile1.unpack_streams(p)
        if s is None:
            continue
        fi, ti = s
        fq[i] = profile1._untrim(fi.astype(np.float64), n, ch)[: n * ch]
        tq[i] = profile1._untrim(ti.astype(np.float64), psycho.SUBBANDS, ch)[: tq_len]
    return fq, tq, lq


def _batch_splits(ps: list[bytes], bits: int, ch: int) -> bool:
    """True when the JAX package's batch unpack splits these lossless
    payloads into frames without an error: every 16/32/64-bit payload is a
    whole number of values, and a run of equal byte-aligned payloads
    joins into a non-empty whole number of rows per frame. Where it
    raises, its Decoder decodes the run frame by frame instead."""
    if not all(packing.whole_values(len(p), bits) for p in ps):
        return False
    sizes = {len(p) for p in ps}
    if bits == 12 or len(sizes) > 1:
        return True
    values = len(ps) * sizes.pop() // (bits // 8)
    return values > 0 and values % (len(ps) * ch) == 0


def _decode_lossless(hs: list[ASFH], ps: list[bytes], dtype: str, i24_transfer: bool,
                     device: torch.device) -> np.ndarray:
    """[B, n, C] PCM of one uniform, splittable profile 0 or 4 run."""
    h0 = hs[0]
    run, ch, n = len(hs), h0.channels, h0.fsize
    bits = packing.DEPTHS[h0.bit_depth_index]
    sizes = {len(p) for p in ps}
    if (h0.profile == 0 and dtype == "float32" and bits in bitpack.TRUNC_DEVICE_BITS
            and sizes == {n * ch * bits // 8} and (n * ch) % 4 == 0):
        # fast path: the payload bytes go up as words; the trunc_unpack
        # kernel and the IDCT GEMM run on the device
        with _stage("dec:unpack"):
            words = np.frombuffer(b"".join(ps), dtype="<i2" if bits == 16 else "<i4")
        with _stage("dec:h2d"):
            placed = batch.place_rows(words.reshape(run, -1), device, _up)
        i24 = i24_transfer and bits == 24
        with _stage("dec:core"):
            rows = batch.run_rows(
                batch.p0_unpack_decode_i24_core if i24 else batch.p0_unpack_decode_core,
                (placed,), device, bits, h0.endian, n, ch)
        with _stage("dec:d2h"):
            (out,) = rows.fetch(_down)
            return bitpack.i24_words_to_pcm(out).reshape(run, n, ch) if i24 else out
    with _stage("dec:unpack"):
        if bits != 12 and len(sizes) == 1:
            # equal byte-aligned payloads: one vectorised unpack
            flat = packing.unpack_floats(b"".join(ps), bits, h0.endian)
            coeffs = flat.reshape(run, -1, ch)[:, :n, :]
        else:
            coeffs = np.zeros((run, n, ch))
            for i, p in enumerate(ps):
                flat = packing.unpack_floats(p, bits, h0.endian)
                rows = flat[: (len(flat) // ch) * ch].reshape(-1, ch)[:n]
                coeffs[i, :len(rows)] = rows
    if h0.profile == 4:
        return coeffs
    dt = "float64" if bits >= policy.DEEP_BITS else dtype
    with _stage("dec:core"):
        (out,) = batch.run_rows(batch.p0_decode_core, (coeffs.astype(dt),), device,
                                upload=_up).fetch(_down)
    return out


def _decode_run(hs: list[ASFH], ps: list[bytes], *, i16_transfer: bool,
                device: torch.device, fix_error: bool = False,
                compute_dtype: str | None = None, i24_transfer: bool = False
                ) -> tuple[np.ndarray, np.ndarray] | None:
    """Decode one uniform run of profile 0, 1, 2 or 4 with one device call.

    Returns (pcm [S, C] — overlap-added within the run, frame 0's head
    left fade-free for the caller's fragment fixup —, trailing overlap
    fragment [olap, C] f64), or None for a lossless run the batch cannot
    split into frames (see `_batch_splits`) and for a run of any profile
    whose depth index lies past its table: the caller decodes it frame by
    frame, as the JAX package's Decoder does."""
    h0 = hs[0]
    run = len(hs)
    ch = h0.channels
    n = h0.fsize
    dtype = policy.check_compute_dtype(compute_dtype)
    if h0.ecc:
        with _stage("dec:ecc"):
            ps = _unarmor(hs, ps, fix_error)
    if h0.profile in (0, 4):
        if h0.bit_depth_index >= len(packing.DEPTHS) or not _batch_splits(
                ps, packing.DEPTHS[h0.bit_depth_index], ch):
            return None
        out = _decode_lossless(hs, ps, dtype, i24_transfer, device)
        return out.reshape(-1, ch), np.empty((0, 0), dtype=np.float64)

    depths = models.BIT_DEPTHS[h0.profile]
    if h0.bit_depth_index >= len(depths):
        return None             # frame by frame: each decodes to a zero frame
    cut = n * (h0.overlap_ratio - 1) // h0.overlap_ratio if h0.overlap_ratio > 1 else n
    olap = n - cut
    factor = profile1._scale_factor(depths[h0.bit_depth_index])

    with _stage("dec:unpack"):
        fq, tq, lq = _unpack_run(ps, n, ch, h0.profile, dtype)
        fq = fq.reshape(run, n, ch)
        tq = tq.reshape(run, psycho.SUBBANDS, ch)
        if dtype == "float32" and float(np.abs(fq).max(initial=0.0)) <= 32767.0:
            # EGR symbols are small exact integers: int16 halves the upload,
            # and the cast back on the device is exact
            fq = fq.astype(np.int16)
    # the int16 emit is Profile 1's at float32; the JAX package fetches
    # Profile 2's frames as floats
    i16 = i16_transfer and dtype == "float32" and h0.profile == 1

    core, arrays = ((batch.p2_decode_core, (fq, tq, lq.reshape(run, profile2.ORDER1, ch)))
                    if h0.profile == 2 else (batch.p1_decode_core, (fq, tq)))
    with _stage("dec:core"):
        with _stage("dec:h2d"):
            placed = [batch.place_rows(a, device, _up) for a in arrays]
        rows = batch.decode_oa_rows(core, placed, device, (h0.srate, factor), olap, cut, i16)
    with _stage("dec:d2h"):
        out_h, frag = rows.fetch(_down)
    with _stage("dec:host-conv"):
        if i16:
            out_h = (native.i16_to_f64(out_h) if native.enabled()
                     else out_h.astype(np.float64) / 32768.0)
    return out_h.reshape(-1, ch), frag.astype(np.float64)


# the run walk of `batch_decode` and of the `Decoder`'s drains
def run_length(headers: list[ASFH], payloads: list[bytes | None], idx: int) -> int:
    """How many frames from `idx` on form one run: payload frames that
    share headers[idx]'s configuration (`_run_key`)."""
    key0 = _run_key(headers[idx])
    end = idx + 1
    while end < len(headers) and payloads[end] is not None and _run_key(headers[end]) == key0:
        end += 1
    return end - idx


def batchable(h: ASFH, frag: np.ndarray) -> bool:
    """Whether a run headed by `h` decodes batched after the overlap
    fragment `frag` carried into it: its profile is one `_decode_run` takes
    (a reserved profile streams through the Decoder, which decodes it as
    profile 0), and the fragment has the run's channels and fits the
    samples its first frame emits before its overlap tail (a longer one
    needs the Decoder's crossfade over several frames). A lossless header
    carries no overlap byte, so its `overlap_ratio` may be a stale value."""
    if h.profile not in (0, 1, 2, 4):
        return False
    emit = (h.fsize * (h.overlap_ratio - 1) // h.overlap_ratio
            if h.profile in COMPACT and h.overlap_ratio > 1 else h.fsize)
    return not frag.size or (len(frag) <= emit and frag.shape[1] == h.channels)


def decode_blended(hs: list[ASFH], ps: list[bytes], frag: np.ndarray, **decode_kw
                   ) -> tuple[list[np.ndarray], np.ndarray] | None:
    """`_decode_run(hs, ps, **decode_kw)` of a run that `batchable` admits,
    then the crossfade of the carried fragment `frag` into its head (under
    `dec:emit`) -> (the run's PCM parts, its trailing overlap fragment), or
    None where `_decode_run` refuses the run."""
    res = _decode_run(hs, ps, **decode_kw)
    if res is None:
        return None
    out, new_frag = res
    with _stage("dec:emit"):
        parts = [_frag_head(out, frag), out[len(frag):]] if frag.size and len(out) else [out]
    return parts, new_frag


def _reframe(a: ASFH, payload: bytes | None) -> bytes:
    """Reserialise an already-parsed frame (header buffer is authoritative)."""
    return a.buffer + (payload or b"")


def batch_decode(stream: bytes, *, fix_error: bool = False,
                 compute_dtype: str | None = None, i16_transfer: bool = False,
                 i24_transfer: bool = False, return_remainder: bool = False,
                 device: str | torch.device | None = None):
    """Decode a FrAD byte stream of profiles 0, 1, 2 and 4 in batched mode.

    Every uniform run (same profile/depth/channels/srate/fsize/overlap/
    ECC ratio) is decoded as one device call; the overlap fragment
    carries across runs and is emitted at force-flush terminators and at
    the end. ECC armor is stripped; with `fix_error`, every armored frame
    whose CRC mismatches is Reed-Solomon repaired first. Returns
    (pcm [T, C], srate), or with `return_remainder` (pcm, srate,
    remainder) where `remainder` holds the frames after a mid-stream
    change of channel layout or sample rate, for another call.
    `compute_dtype` (None: `policy.compute_dtype()`) is the transform's
    dtype; `i16_transfer` brings Profile 1's PCM back from the
    device as int16 (x32768) at float32, `i24_transfer` Profile 0's at 24 bits and
    float32 as int24 (x2^23). `device` defaults to CUDA and raises when
    none is present. A stream with no payload frame, an unparsable tail, a
    fragment longer than the next run's emit window (which needs a
    crossfade over several frames), a frame of a reserved profile and a
    lossless run the batch cannot split are decoded by the streaming
    `Decoder` with the carried state, at `compute_dtype`; the transfer
    forms do not reach those frames (the Decoder's per-frame path has none),
    which come back unrounded.
    """
    from ..decoder import Decoder

    policy.check_compute_dtype(compute_dtype)
    dev = policy.resolve_device(device)
    with _stage("dec:parse"):
        headers, payloads, tail_bytes = _parse_frames(stream)
    if not any(p is not None for p in payloads):
        dec = Decoder(fix_error=fix_error, device=dev, compute_dtype=compute_dtype)
        parts = [p for p in (dec.process(stream).pcm, dec.flush().pcm) if p.size]
        pcm_out = np.concatenate(parts) if parts else np.empty((0,))
        if return_remainder:
            return pcm_out, dec.asfh.srate, b""
        return pcm_out, dec.asfh.srate

    out_parts: list[np.ndarray] = []
    first = next(h for h, p in zip(headers, payloads) if p is not None)
    srate = first.srate
    info = (first.channels, first.srate)
    frag = np.empty((0, 0), dtype=np.float64)
    idx = 0
    remainder = b""
    stream_rest = False

    while idx < len(headers):
        h0 = headers[idx]
        if payloads[idx] is None:
            # force-flush terminator: emit the overlap tail
            if frag.size:
                out_parts.append(frag)
            frag = np.empty((0, 0), dtype=np.float64)
            idx += 1
            continue
        if (h0.channels, h0.srate) != info:
            # mid-stream format change: emit the old format's overlap tail
            # and hand the rest back
            if frag.size:
                out_parts.append(frag)
            frag = np.empty((0, 0), dtype=np.float64)
            remainder = b"".join(
                _reframe(headers[i], payloads[i]) for i in range(idx, len(headers))
            ) + tail_bytes
            tail_bytes = b""
            break
        if not batchable(h0, frag):
            # a reserved profile, or a fragment that spans several frames of
            # the next run: the streaming Decoder takes the rest
            stream_rest = True
            break
        run = run_length(headers, payloads, idx)
        res = decode_blended(headers[idx: idx + run], payloads[idx: idx + run], frag,
                             i16_transfer=i16_transfer, device=dev, fix_error=fix_error,
                             compute_dtype=compute_dtype, i24_transfer=i24_transfer)
        if res is None:
            # a lossless payload the batch cannot split: frame by frame
            stream_rest = True
            break
        parts, frag = res
        out_parts += parts
        srate = h0.srate
        idx += run

    if not remainder:
        # what the runs could not take streams through a Decoder that
        # starts from the carried fragment and format
        rest_stream = (b"".join(_reframe(headers[i], payloads[i])
                                for i in range(idx, len(headers)))
                       if stream_rest else b"") + tail_bytes
        if rest_stream:
            dec = Decoder(fix_error=fix_error, device=dev, compute_dtype=compute_dtype)
            dec.overlap_fragment = np.asarray(frag, dtype=np.float64)
            dec.info = info
            r = dec.process(rest_stream)
            out_parts.append(r.pcm)
            srate = r.srate or srate
            if r.crit:
                # the next segment's header is already parsed inside `dec`:
                # reserialise it with the unread bytes for the caller
                remainder = dec.asfh.buffer + dec.buffer
            else:
                out_parts.append(dec.flush().pcm)
        elif frag.size:
            out_parts.append(frag)

    with _stage("dec:emit"):
        parts = [np.atleast_2d(p) for p in out_parts if p.size]
        if not parts:
            pcm_out = np.empty((0, first.channels))
        elif len(parts) == 1:
            pcm_out = parts[0]
        else:
            pcm_out = np.concatenate(parts, axis=0)
    if return_remainder:
        return pcm_out, srate, remainder
    return pcm_out, srate


def batch_repair(stream: bytes, ecc_ratio: tuple[int, int] = DEFAULT_ECC_RATIO,
                 *, fix_error: bool = True) -> bytes:
    """Re-armor a whole FrAD stream in batched mode, on the host.

    Every complete frame is CRC-verified, RS-repaired when damaged (and
    `fix_error`), and re-armored at `ecc_ratio` with a recomputed CRC;
    the payload bytes stay untouched, so the audio does too. Bytes
    outside frames (junk, a truncated trailing frame) and force-flush
    terminators pass through verbatim. Consecutive frames that share a
    header configuration are unarmored and re-framed in one batched call
    each. An ecc_ratio GF(256) cannot honor falls back to (96, 24). Works
    on streams of every profile: it touches no audio.
    """
    ecc_ratio, _warnings = sanitize_ecc_ratio(ecc_ratio)
    out: list[bytes] = []
    run_key = None                 # pending run of frames sharing a re-frame key
    run_hs: list[ASFH] = []
    run_ps: list[bytes] = []

    def flush_run() -> None:
        nonlocal run_key, run_hs, run_ps
        if not run_hs:
            return
        hs, ps = run_hs, run_ps
        run_key, run_hs, run_ps = None, [], []
        h0 = hs[0]
        if h0.ecc:
            ps = _unarmor(hs, ps, fix_error)
        out.append(_frame_batch(
            [(p, h.bit_depth_index, h.fsize) for h, p in zip(hs, ps)], profile=h0.profile,
            channels=h0.channels, srate=h0.srate, overlap_ratio=h0.overlap_ratio,
            little_endian=h0.endian, ecc_ratio=ecc_ratio))

    def add(a: ASFH, payload: bytes) -> None:
        nonlocal run_key
        key = (a.profile, a.channels, a.srate, a.endian, a.overlap_ratio,
               a.ecc, a.ecc_dsize, a.ecc_codesize)
        if key != run_key:
            flush_run()
            run_key = key
        run_hs.append(a)
        run_ps.append(payload)

    headers, payloads, _tail_pos, starts = _scan_frames(stream)
    prev = 0
    for a, p, st in zip(headers, payloads, starts):
        if st > prev:
            flush_run()
            out.append(stream[prev:st])           # passthrough bytes
        if p is None:                             # force-flush terminator
            flush_run()
            out.append(a.buffer)
            prev = st + a.header_bytes
            continue
        add(a, p)
        prev = st + a.header_bytes + a.frmbytes
    flush_run()
    out.append(stream[prev:])                     # trailing junk or truncated frame
    return b"".join(out)
