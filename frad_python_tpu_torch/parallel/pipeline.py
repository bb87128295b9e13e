"""Whole-file batch codec pipeline, Profile 1, with ECC armor and repair.

`batch_encode` plans every frame of a stream up front, runs the tensor
domain on one device as one call over the uniform frames (PCM upload ->
DCT/mask/quant core -> EGR bit-pack -> compaction of each frame's used
words), and finishes the byte domain on the host (EGR thresholds,
DEFLATE, Reed-Solomon armor, ASFH framing). `batch_decode` parses the
frames on the host, strips (and with `fix_error` repairs) the armor,
decodes each uniform run with one device call (dequant -> IDCT ->
overlap-add), and carries the overlap fragment across runs and
terminators. `batch_repair` re-armors a stream on the host alone.

The host byte domain runs in the C++ host module (`native`), threaded,
in a few batched calls per run; FRAD_TORCH_NO_NATIVE=1 selects the numpy
paths instead.

Streams are format-identical to the JAX package's `parallel.pipeline`:
fed the same quantised symbols, the packer and framer give the same
bytes, and `batch_repair` gives the JAX function's bytes. What a batch
cannot decode (a stream with no payload frame, an unparsable tail, a
fragment longer than the next run's emit window) goes to the streaming
`Decoder` with the carried overlap state, as in the JAX package.

Not ported yet, and raising NotImplementedError: profiles 0, 2 and 4,
and float64 compute.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from .. import models, native
from ..common import FRM_SIGN
from ..container import ecc as ecc_mod
from ..container.asfh import ASFH, COMPLETE, FORCE_FLUSH
from ..models import batch, profile1
from ..models.profiles import COMPACT, compact
from ..ops import bitpack, golomb, policy, psycho
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


def _asfh_for(bit_depth_index: int, channels: int, srate: int, fsize: int, *,
              ecc: bool, ecc_ratio: tuple[int, int], little_endian: bool,
              overlap_ratio: int) -> ASFH:
    """A Profile 1 frame header."""
    a = ASFH()
    a.profile = 1
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
    """[len(frs), length, C] frames (zero past the end of the PCM)."""
    out = np.zeros((len(frs), length, pcm.shape[1]), dtype=np.float64)
    for i, (s, ln) in enumerate(frs):
        sa = max(s, 0)
        out[i, sa - s: ln] = pcm[sa: s + ln]
    return out


def _encode_frames(pcm: np.ndarray, frs: list[tuple[int, int]], srate: int,
                   bit_depth: int, loss_level: float, i16_upload: bool,
                   device: torch.device) -> list[tuple[bytes, int, int]]:
    """Profile 1 payloads of equal-length frames: [(payload, bdi, flen)]."""
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
    bits = bit_depth if bit_depth in profile1.DEPTHS else 16
    factor = profile1._scale_factor(bits)
    bdi = profile1.DEPTHS.index(bits)

    if i16_upload:
        fq, tq = batch.p1_encode_core_i16(
            policy.to_device(_to_i16(arr), device), srate_v, ll, factor)
    else:
        fq, tq = batch.p1_encode_core(
            policy.to_device(arr.astype(np.float32), device), srate_v, ll, factor)
    b = len(frs)
    m = dlen * channels
    fq = fq.reshape(b, m)                   # [B, N, C] -> interleaved rows
    tq = tq.reshape(b, psycho.SUBBANDS * channels)

    # single frames and depths over 24 bits (symbols may pass 2^23) take
    # the host EGR coder; the rest bit-pack on the device, so the fetch
    # carries the stream's own bytes instead of int32 symbols
    if bits > 24 or b == 1:
        fqh, tqh = policy.to_host(fq, tq)
        return [(profile1.pack_streams(fqh[i], tqh[i]), bdi, frs[i][1])
                for i in range(b)]

    max_words = max(m * 12 // 32, 16)
    words, nbits, ks, ovf = bitpack.egr_pack_frames(fq, max_words)
    flat, used = bitpack.compact_words(words, nbits, ovf)
    flat_h, used_h, nbits_h, ks_h, ovf_h, tqh = policy.to_host(
        flat, used, nbits, ks, ovf, tq)
    flat_h = flat_h.astype(np.uint32)
    offs = np.cumsum(used_h) - used_h
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


def _frame_batch(payloads: list[bytes], bdis: np.ndarray, flens: np.ndarray, *,
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
                 final: bool = True, device: str | torch.device | None = None) -> bytes:
    """Encode a whole [T, C] float PCM array into a Profile 1 FrAD stream.

    `device` defaults to CUDA and raises when none is present. The tensor
    domain computes in float32; `i16_upload` sends the PCM to the device
    as int16 (x32768). `enable_ecc` armors every payload with
    Reed-Solomon parity at `ecc_ratio` = (data bytes, parity bytes) per
    block; a ratio GF(256) cannot honor (data + parity > 255) raises
    ValueError. Only Profile 1 is ported.

    `final=False` encodes a span that the stream continues after (the
    streaming Encoder's micro-batches): the trailing partial frame and the
    force-flush terminators are left out, so the next span, which re-reads
    the overlap, follows on byte for byte.
    """
    models.check_ported(profile)
    policy.check_compute_dtype(compute_dtype)
    dev = policy.resolve_device(device)
    pcm = np.asarray(pcm, dtype=np.float64)
    total, channels = pcm.shape
    srate = compact.get_valid_srate(srate)
    loss_level = max(abs(loss_level), 0.125)
    overlap_ratio = overlap_ratio if overlap_ratio == 0 else max(2, min(256, overlap_ratio))
    header = dict(ecc=enable_ecc, ecc_ratio=ecc_ratio, little_endian=little_endian,
                  overlap_ratio=overlap_ratio)

    frames, terms = plan_frames(total, frame_size, overlap_ratio, True)
    if not final:
        n_full = frames[0][1] if frames else 0
        frames = [f for f in frames if f[1] == n_full]
        terms = 0
        if not frames:
            return b""
    if not frames:
        a = _asfh_for(0, max(channels, 1), srate, compact.get_samples_min_ge(frame_size),
                      **header)
        return a.force_flush() * max(terms, 1)

    n = frames[0][1]
    uniform = [f for f in frames if f[1] == n]
    tail = frames[len(uniform):]            # 0 or 1 non-uniform tail frame
    groups = [g for g in (
        _encode_frames(pcm, uniform, srate, bit_depth, loss_level, i16_upload, dev),
        _encode_frames(pcm, tail, srate, bit_depth, loss_level, i16_upload, dev)) if g]

    # a data size of 0 cannot be cut into blocks: the per-frame path
    # carries it as the JAX package does
    use_native = native.enabled() and not (enable_ecc and ecc_ratio[0] <= 0)
    framed: list[bytes] = []
    for g in groups:
        if use_native:
            framed.append(_frame_batch(
                [p for p, _, _ in g], np.array([b for _, b, _ in g], dtype=np.uint8),
                np.array([f for _, _, f in g], dtype=np.uint32), profile=1,
                channels=channels, srate=srate, overlap_ratio=overlap_ratio,
                little_endian=little_endian, ecc_ratio=ecc_ratio if enable_ecc else None))
            continue
        for payload, bdi, flen in g:
            if enable_ecc:
                payload = ecc_mod.encode(payload, *ecc_ratio)
            framed.append(_asfh_for(bdi, channels, srate, flen, **header).write(payload))
    if terms:
        _, last_bdi, last_flen = groups[-1][-1]
        framed.append(_asfh_for(last_bdi, channels, srate, last_flen, **header).force_flush()
                      * terms)
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


def _unpack_run(ps: list[bytes], n: int, ch: int) -> tuple[np.ndarray, np.ndarray]:
    """Profile 1 payloads -> (freq symbols [B, n*ch], threshold symbols
    [B, 27*ch]) as float32 rows; a corrupt payload gives zero rows."""
    if native.enabled():
        # one threaded C++ pass: inflate + EGR decode + untrim
        fq, tq, _ok = native.p1_unpack_batch(ps, n * ch, psycho.SUBBANDS * ch)
        return fq, tq
    fq = np.zeros((len(ps), n * ch), dtype=np.float32)
    tq = np.zeros((len(ps), psycho.SUBBANDS * ch), dtype=np.float32)
    for i, p in enumerate(ps):
        s = profile1.unpack_streams(p)
        if s is None:
            continue
        fi, ti = s
        fq[i] = profile1._untrim(fi.astype(np.float64), n, ch)[: n * ch]
        tq[i] = profile1._untrim(ti.astype(np.float64), psycho.SUBBANDS,
                                 ch)[: psycho.SUBBANDS * ch]
    return fq, tq


def _decode_run(hs: list[ASFH], ps: list[bytes], *, i16_transfer: bool,
                device: torch.device, fix_error: bool = False
                ) -> tuple[np.ndarray, np.ndarray]:
    """Decode one uniform Profile 1 run with one device call.

    Returns (pcm [S, C] — overlap-added within the run, frame 0's head
    left fade-free for the caller's fragment fixup —, trailing overlap
    fragment [olap, C] f64)."""
    h0 = hs[0]
    run = len(hs)
    ch = h0.channels
    n = h0.fsize
    if h0.ecc:
        ps = _unarmor(hs, ps, fix_error)
    cut = n * (h0.overlap_ratio - 1) // h0.overlap_ratio if h0.overlap_ratio > 1 else n
    olap = n - cut
    factor = profile1._scale_factor(profile1.DEPTHS[h0.bit_depth_index])

    fq, tq = _unpack_run(ps, n, ch)
    fq = fq.reshape(run, n, ch)
    tq = tq.reshape(run, psycho.SUBBANDS, ch)
    if float(np.abs(fq).max(initial=0.0)) <= 32767.0:
        # EGR symbols are small exact integers: int16 halves the upload,
        # and the cast back on the device is exact
        fq = fq.astype(np.int16)

    out_d, frag_d = batch.p1_decode_oa_core(
        policy.to_device(fq, device), policy.to_device(tq, device),
        h0.srate, factor, olap, cut, i16_transfer)
    out_h, frag = policy.to_host(out_d, frag_d)
    if i16_transfer:
        out_h = (native.i16_to_f64(out_h) if native.enabled()
                 else out_h.astype(np.float64) / 32768.0)
    return out_h.reshape(-1, ch), frag.astype(np.float64)


def _reframe(a: ASFH, payload: bytes | None) -> bytes:
    """Reserialise an already-parsed frame (header buffer is authoritative)."""
    return a.buffer + (payload or b"")


def batch_decode(stream: bytes, *, fix_error: bool = False,
                 compute_dtype: str | None = None, i16_transfer: bool = False,
                 return_remainder: bool = False,
                 device: str | torch.device | None = None):
    """Decode a Profile 1 FrAD byte stream in batched mode.

    Every uniform run (same profile/depth/channels/srate/fsize/overlap/
    ECC ratio) is decoded as one device call; the overlap fragment
    carries across runs and is emitted at force-flush terminators and at
    the end. ECC armor is stripped; with `fix_error`, every armored frame
    whose CRC mismatches is Reed-Solomon repaired first. Returns
    (pcm [T, C], srate), or with `return_remainder` (pcm, srate,
    remainder) where `remainder` holds the frames after a mid-stream
    change of channel layout or sample rate, for another call.
    `i16_transfer` brings the PCM back from the device as int16 (x32768).
    `device` defaults to CUDA and raises when none is present. A stream
    with no payload frame, an unparsable tail, and a fragment longer than
    the next run's emit window (which needs a crossfade over several
    frames) are decoded by the streaming `Decoder` with the carried state.
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
        models.check_ported(h0.profile)
        key0 = _run_key(h0)
        run = 1
        while (idx + run < len(headers) and payloads[idx + run] is not None
               and _run_key(headers[idx + run]) == key0):
            run += 1

        n = h0.fsize
        cut = n * (h0.overlap_ratio - 1) // h0.overlap_ratio if h0.overlap_ratio > 1 else n
        if frag.size and (len(frag) > cut or frag.shape[1] != h0.channels):
            # the fragment spans several frames of the next run: the
            # streaming Decoder's progressive crossfade takes the rest
            stream_rest = True
            break

        out, new_frag = _decode_run(headers[idx: idx + run], payloads[idx: idx + run],
                                    i16_transfer=i16_transfer, device=dev,
                                    fix_error=fix_error)
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
