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
paths instead.

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
"""

from __future__ import annotations

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
    below the lossy profile's masking noise)."""
    if native.enabled():
        return native.f64_to_i16(a)
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


def _encode_frames(pcm: np.ndarray, frs: list[tuple[int, int]], profile: int, srate: int,
                   bit_depth: int, loss_level: float, dtype: str, i16_upload: bool,
                   device: torch.device) -> list[tuple[bytes, int, int]]:
    """Profile 1 or 2 payloads of equal-length frames: [(payload, bdi, flen)]."""
    if not frs:
        return []
    channels = pcm.shape[1]
    flen = frs[0][1]
    arr = _gather(pcm, frs, flen)
    arr_p, srate_v, ll = profile1.prepare_frame(arr[0], srate, loss_level)
    dlen = arr_p.shape[0]
    if dlen != flen:
        pad = np.zeros((len(frs), dlen, channels))
        pad[:, :flen] = arr
        arr = pad
    depths = models.BIT_DEPTHS[profile]
    bits = bit_depth if bit_depth in depths else 16
    factor = profile1._scale_factor(bits)
    bdi = depths.index(bits)
    b = len(frs)

    if profile == 2:
        # one core call, then the host EGR coder and DEFLATE per frame
        fq, tq, lq = batch.p2_encode_core(
            policy.to_device(arr.astype(dtype), device), srate_v, ll, factor)
        fqh, tqh, lqh = policy.to_host(fq, tq, lq)
        return [(profile2.pack_streams(fqh[i].ravel(), tqh[i].ravel(), lqh[i].ravel()),
                 bdi, frs[i][1]) for i in range(b)]

    if i16_upload and dtype == "float32":
        fq, tq = batch.p1_encode_core_i16(
            policy.to_device(_to_i16(arr), device), srate_v, ll, factor)
    else:
        fq, tq = batch.p1_encode_core(
            policy.to_device(arr.astype(dtype), device), srate_v, ll, factor)
    m = dlen * channels
    fq = fq.reshape(b, m)                   # [B, N, C] -> interleaved rows
    tq = tq.reshape(b, psycho.SUBBANDS * channels)

    # single frames, depths over 24 bits (symbols may pass 2^23) and the
    # int64 symbols of float64 take the host EGR coder; the rest bit-pack
    # on the device, so the fetch carries the stream's own bytes instead
    # of int32 symbols
    if bits > 24 or b == 1 or dtype != "float32":
        fqh, tqh = policy.to_host(fq, tq)
        return [(profile1.pack_streams(fqh[i], tqh[i]), bdi, frs[i][1])
                for i in range(b)]

    max_words = max(m * 12 // 32, 16)
    flat, used, nbits, ks, ovf = egr_pack(fq.contiguous(), max_words)
    flat_h, used_h, nbits_h, ks_h, ovf_h, tqh = policy.to_host(
        flat, used, nbits, ks, ovf, tq)
    flat_h = flat_h.view(np.uint32)         # int32 words hold the uint32 bit pattern
    offs = np.cumsum(used_h, dtype=np.int64) - used_h
    ovf_rows = np.flatnonzero(ovf_h)
    fq_ovf: dict[int, np.ndarray] = {}
    if ovf_rows.size:
        # (rare) frames whose stream overflowed max_words: host EGR
        (rows,) = policy.to_host(fq[torch.as_tensor(ovf_rows, device=fq.device)])
        fq_ovf = dict(zip(ovf_rows.tolist(), rows))

    if native.enabled():
        # one threaded C++ pass: threshold EGR, word serialisation and
        # DEFLATE of every frame, over the compacted words rebuilt into
        # rows padded to the widest frame
        w = max(int(used_h.max()), 1)
        flat_pad = np.concatenate([flat_h, np.zeros(w, dtype=np.uint32)])
        payloads = native.p1_pack_batch(flat_pad[offs[:, None] + np.arange(w)],
                                        nbits_h, ks_h, ovf_h, tqh)
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
    arr = _gather(pcm, frs, flen)
    base_bits = bit_depth if bit_depth in packing.DEPTHS else 16
    limit = packing.FLOAT_MAX[packing.DEPTHS.index(base_bits)]

    if profile == 0:
        if (dtype == "float32" and base_bits in bitpack.TRUNC_DEVICE_BITS
                and (flen * channels) % 4 == 0):
            # fast path: the DCT and the truncated-float pack on the
            # device, so both copies carry payload-sized bytes; a frame
            # that escalates sends the batch down the general path
            if i24_upload and base_bits == 24:
                words_d, maxabs_d = batch.p0_encode_pack_core_i24(
                    policy.to_device(bitpack.pcm_to_i24_words_host(arr).reshape(b, -1)
                                     .view(np.int32), device),
                    base_bits, little_endian, flen, channels)
            else:
                words_d, maxabs_d = batch.p0_encode_pack_core(
                    policy.to_device(arr.astype(np.float32), device), base_bits,
                    little_endian)
            (maxabs,) = policy.to_host(maxabs_d)
            if np.all(maxabs <= limit):
                (words,) = policy.to_host(words_d)
                return _BlobParts(words.tobytes(), words.shape[1] * words.itemsize,
                                  packing.DEPTHS.index(base_bits), flen, b)
        dt = "float64" if base_bits >= policy.DEEP_BITS else dtype
        (coeffs,) = policy.to_host(batch.p0_encode_core(policy.to_device(arr.astype(dt),
                                                                          device)))
    else:
        coeffs = arr
    flat = coeffs.reshape(b, -1)
    fused_blob = None
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
        (coeffs,) = policy.to_host(batch.p0_encode_core(policy.to_device(arr, device)))
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
        blob = packing.pack_floats(group.reshape(-1), d, little_endian)
        per = len(blob) // len(idxs)
        if len(idxs) == b:
            return _BlobParts(blob, per, bdi, flen, b)
        for j, i in enumerate(idxs):
            results[i] = (blob[j * per:(j + 1) * per], bdi, frs[i][1])
    return results


def _frame_batch(payloads: list[bytes] | tuple[bytes, np.ndarray], bdis: np.ndarray,
                 flens: np.ndarray, *,
                 profile: int, channels: int, srate: int, overlap_ratio: int,
                 little_endian: bool, ecc_ratio: tuple[int, int] | None) -> bytes:
    """Frames of one header configuration in one threaded C++ pass: RS
    armor at `ecc_ratio` (None: no ECC), ASFH header and CRC per frame."""
    if profile in COMPACT:
        fidx_of = {fl: compact.get_samples_index(fl) for fl in set(flens.tolist())}
        fidx = np.fromiter((fidx_of[f] for f in flens.tolist()), np.uint8, len(flens))
        sidx = compact.get_srate_index(srate)
    else:
        fidx, sidx = None, 0
    dsize, codesize = ecc_ratio or (0, 0)
    return native.frame_pack_batch(
        payloads, bdis, flens, fidx, profile=profile, is_compact=profile in COMPACT,
        channels=channels, srate=srate, srate_idx=sidx, overlap_ratio=overlap_ratio,
        little_endian=little_endian, ecc=ecc_ratio is not None, ecc_dsize=dsize,
        ecc_codesize=codesize)


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

    # a data size of 0 cannot be cut into blocks: the per-frame path
    # carries it as the JAX package does
    use_native = native.enabled() and not (enable_ecc and ecc_ratio[0] <= 0)
    framed: list[bytes] = []
    for g in groups:
        if isinstance(g, _BlobParts) and not use_native:
            g = g.as_parts()
        if isinstance(g, _BlobParts):
            framed.append(_frame_batch(
                (g.blob, np.arange(g.n + 1, dtype=np.int64) * g.per),
                np.full(g.n, g.bdi, np.uint8), np.full(g.n, g.flen, np.uint32),
                profile=profile, channels=channels, srate=srate,
                overlap_ratio=overlap_ratio, little_endian=little_endian,
                ecc_ratio=ecc_ratio if enable_ecc else None))
        elif use_native:
            framed.append(_frame_batch(
                [p for p, _, _ in g], np.array([b for _, b, _ in g], dtype=np.uint8),
                np.array([f for _, _, f in g], dtype=np.uint32), profile=profile,
                channels=channels, srate=srate, overlap_ratio=overlap_ratio,
                little_endian=little_endian, ecc_ratio=ecc_ratio if enable_ecc else None))
        else:
            for payload, bdi, flen in g:
                if enable_ecc:
                    payload = ecc_mod.encode(payload, *ecc_ratio)
                framed.append(_asfh_for(profile, bdi, channels, srate, flen,
                                        **header).write(payload))
    if terms:
        _, last_bdi, last_flen = groups[-1][-1]
        framed.append(_asfh_for(profile, last_bdi, channels, srate, last_flen,
                                **header).force_flush() * terms)
    return b"".join(framed)


def _scan_native(stream: bytes) -> tuple[list[ASFH], list[bytes | None], int, list[int]]:
    """Whole-stream ASFH scan in C++ -> (headers, payloads, tail_pos,
    starts): each header carries its raw bytes in `.buffer`, starts[i] is
    the offset of frame i's FRM_SIGN, tail_pos the offset of the
    unparsed tail (-1 when there is none)."""
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
    """O(n) frame scan. Force-flush terminators are recorded as
    (header, None) pairs. Returns (headers, payloads, unparsed tail)."""
    if native.enabled():
        headers, payloads, tail_pos, _ = _scan_native(stream)
        return headers, payloads, (b"" if tail_pos < 0 else stream[tail_pos:])
    headers = []
    payloads = []
    pos = 0
    n = len(stream)
    while True:
        idx = stream.find(FRM_SIGN, pos)
        if idx < 0:
            return headers, payloads, b""
        a = ASFH()
        status, _ = a.read(stream[idx: idx + 48])
        if status == INVALID:
            pos = idx + len(FRM_SIGN)             # not a header: resync behind its sign
            continue
        if status == FORCE_FLUSH:
            headers.append(a)
            payloads.append(None)
            pos = idx + a.header_bytes
            continue
        if status != COMPLETE or idx + a.header_bytes + a.frmbytes > n:
            return headers, payloads, stream[idx:]
        headers.append(a)
        payloads.append(stream[idx + a.header_bytes: idx + a.header_bytes + a.frmbytes])
        pos = idx + a.header_bytes + a.frmbytes


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
        return native.unarmor_batch(ps, h0.ecc_dsize, h0.ecc_codesize, crcs,
                                    h0.profile in COMPACT, fix_error)[0]
    # ratios GF(256) cannot honor come only from hand-made headers: the
    # per-frame path strips their parity best-effort (container/ecc.py)
    return [ecc_mod.decode(p, h.ecc_dsize, h.ecc_codesize,
                           fix_error and not h.payload_crc_matches(p))
            for h, p in zip(hs, ps)]


def _frag_head(out: np.ndarray, frag: np.ndarray) -> np.ndarray:
    """Crossfade an incoming overlap fragment into the head of a decoded
    run (the batched overlap-add leaves frame 0's head fade-free). Returns
    the blended head; the caller emits it followed by out[len(frag):]."""
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
        fq, tq, lq, _ok = native.p1_unpack_batch(ps, n * ch, tq_len, lq_len)
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
        words = np.frombuffer(b"".join(ps), dtype="<i2" if bits == 16 else "<i4")
        words_d = policy.to_device(words.reshape(run, -1), device)
        if i24_transfer and bits == 24:
            (w,) = policy.to_host(batch.p0_unpack_decode_i24_core(
                words_d, bits, h0.endian, n, ch))
            return bitpack.i24_words_to_pcm(w).reshape(run, n, ch)
        (out,) = policy.to_host(batch.p0_unpack_decode_core(words_d, bits, h0.endian, n, ch))
        return out
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
    (out,) = policy.to_host(batch.p0_decode_core(policy.to_device(coeffs.astype(dt), device)))
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

    fq_d, tq_d = policy.to_device(fq, device), policy.to_device(tq, device)
    if h0.profile == 2:
        out_d, frag_d = batch.p2_decode_oa_core(
            fq_d, tq_d, policy.to_device(lq.reshape(run, profile2.ORDER1, ch), device),
            h0.srate, factor, olap, cut, i16)
    else:
        out_d, frag_d = batch.p1_decode_oa_core(fq_d, tq_d, h0.srate, factor, olap, cut, i16)
    out_h, frag = policy.to_host(out_d, frag_d)
    if i16:
        out_h = (native.i16_to_f64(out_h) if native.enabled()
                 else out_h.astype(np.float64) / 32768.0)
    return out_h.reshape(-1, ch), frag.astype(np.float64)


def _emit_cut(h: ASFH) -> int:
    """Samples a frame of `h` emits before its overlap tail: the frame size
    less the overlap of a compact profile (a lossless header carries no
    overlap byte, so its `overlap_ratio` may be a stale value)."""
    if h.profile in COMPACT and h.overlap_ratio > 1:
        return h.fsize * (h.overlap_ratio - 1) // h.overlap_ratio
    return h.fsize


#: profiles `_decode_run` takes; a reserved profile streams through the
#: Decoder, which decodes it as profile 0
_BATCHABLE = (0, 1, 2, 4)


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
    `Decoder` with the carried state.
    """
    from ..decoder import Decoder

    policy.check_compute_dtype(compute_dtype)
    dev = policy.resolve_device(device)
    headers, payloads, tail_bytes = _parse_frames(stream)
    if not any(p is not None for p in payloads):
        dec = Decoder(fix_error=fix_error, device=dev)
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
        if h0.profile not in _BATCHABLE:
            # a reserved profile, which the Decoder decodes as profile 0
            stream_rest = True
            break
        key0 = _run_key(h0)
        run = 1
        while (idx + run < len(headers) and payloads[idx + run] is not None
               and _run_key(headers[idx + run]) == key0):
            run += 1

        if frag.size and (len(frag) > _emit_cut(h0) or frag.shape[1] != h0.channels):
            # the fragment spans several frames of the next run: the
            # streaming Decoder's progressive crossfade takes the rest
            stream_rest = True
            break

        res = _decode_run(headers[idx: idx + run], payloads[idx: idx + run],
                          i16_transfer=i16_transfer, device=dev, fix_error=fix_error,
                          compute_dtype=compute_dtype, i24_transfer=i24_transfer)
        if res is None:
            # a lossless payload the batch cannot split: frame by frame
            stream_rest = True
            break
        out, new_frag = res
        if frag.size and len(out):
            out_parts.append(_frag_head(out, frag))
            out_parts.append(out[len(frag):])
        else:
            out_parts.append(out)
        frag = new_frag
        srate = h0.srate
        idx += run

    if not remainder:
        # what the runs could not take streams through a Decoder that
        # starts from the carried fragment and format
        rest_stream = (b"".join(_reframe(headers[i], payloads[i])
                                for i in range(idx, len(headers)))
                       if stream_rest else b"") + tail_bytes
        if rest_stream:
            dec = Decoder(fix_error=fix_error, device=dev)
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
        if native.enabled():
            out.append(_frame_batch(
                ps, np.fromiter((h.bit_depth_index for h in hs), np.uint8, len(hs)),
                np.fromiter((h.fsize for h in hs), np.uint32, len(hs)),
                profile=h0.profile, channels=h0.channels, srate=h0.srate,
                overlap_ratio=h0.overlap_ratio, little_endian=h0.endian,
                ecc_ratio=ecc_ratio))
            return
        for h, p in zip(hs, ps):
            h.ecc = True
            h.ecc_dsize, h.ecc_codesize = ecc_ratio
            out.append(h.write(ecc_mod.encode(p, *ecc_ratio)))

    def add(a: ASFH, payload: bytes) -> None:
        nonlocal run_key
        key = (a.profile, a.channels, a.srate, a.endian, a.overlap_ratio,
               a.ecc, a.ecc_dsize, a.ecc_codesize)
        if key != run_key:
            flush_run()
            run_key = key
        run_hs.append(a)
        run_ps.append(payload)

    if native.enabled():
        headers, payloads, _tail_pos, starts = _scan_native(stream)
        prev = 0
        for a, p, st in zip(headers, payloads, starts):
            if st > prev:
                flush_run()
                out.append(stream[prev:st])       # passthrough bytes
            if p is None:                         # force-flush terminator
                flush_run()
                out.append(a.buffer)
                prev = st + a.header_bytes
                continue
            add(a, p)
            prev = st + a.header_bytes + a.frmbytes
        flush_run()
        out.append(stream[prev:])                 # trailing junk or truncated frame
        return b"".join(out)

    pos = 0
    n = len(stream)
    while True:
        idx = stream.find(FRM_SIGN, pos)
        if idx < 0:
            flush_run()
            out.append(stream[pos:])
            break
        if idx > pos:
            flush_run()
            out.append(stream[pos:idx])           # passthrough bytes
        a = ASFH()
        status, _ = a.read(stream[idx: idx + 48])
        if status == INVALID:
            # not a header: its sign passes through, the scan goes on behind it
            flush_run()
            out.append(stream[idx: idx + len(FRM_SIGN)])
            pos = idx + len(FRM_SIGN)
            continue
        if status == FORCE_FLUSH:
            flush_run()
            out.append(stream[idx: idx + a.header_bytes])
            pos = idx + a.header_bytes
            continue
        if status != COMPLETE or idx + a.header_bytes + a.frmbytes > n:
            flush_run()
            out.append(stream[idx:])              # truncated trailing frame
            break
        add(a, stream[idx + a.header_bytes: idx + a.header_bytes + a.frmbytes])
        pos = idx + a.header_bytes + a.frmbytes
        if pos >= n:
            flush_run()
            break
    return b"".join(out)
