"""Batched Profile 0, 1 and 2 cores over a frame batch [B, N, C], as torch
ops, with the automatic frame-batch data parallelism of the JAX package's
`models/batch.py` over a process's own cards.

Profile 0: the DCT-II / IDCT of `ops/dct.py` (the float32 GEMM, or the
FFT form at float64 and above N = 8192), and the fast path's fused
pairs: DCT GEMM -> `trunc_pack` kernel (payload words and each frame's
max|x|), and `trunc_unpack` kernel -> IDCT GEMM; with the int24 transfer
forms the `i24_unpack` kernel comes before the first and the `i24_pack`
kernel after the second.

Encode: PCM -> DCT-II GEMM -> `mask_thres` kernel (band sums of
(|X| * factor)^2, RMS^0.8, AHT floor, x loss, the log-companded threshold
symbols and the per-bin divisor) -> `power_quant` kernel. Decode:
`dequant` kernel (the symbols' powers times the per-bin divisor that it
expands from the threshold symbols in the same launch) -> IDCT GEMM
(`p1_decode_core`) -> `overlap_add` kernel (`p1_decode_oa_core`). The GEMMs are `torch.matmul` at full float32; the
stages between them are the hand-written CUDA kernels of `kernels/`.

Profile 2 is Profile 1's chain with Temporal Noise Shaping (`ops/tns.py`)
between the masking divide and the quantiser: the encoder runs the TNS
analysis (`tns_autocorr`, which divides, and `tns_fir_gate`, which runs the
Levinson recursion, kernels) and quantises the residual with
the `power_quant` kernel's no-divisor form; the decoder dequantises
(`dequant` without thresholds), runs the TNS synthesis (`tns_iir`
kernel), multiplies by the divisors of the `thres_expand` kernel and
ends like Profile 1.

The lossy cores compute in the dtype of their input: float32 (int32
symbols), or float64 (int64 symbols, the FFT form of the DCT).

The cores take tensors and run on their device as one call: they are the
per-block programs, as the JAX package's jitted functions are, and the
streaming engines' per-frame path and `parallel/sharded.py` (whose ranks
each own a card) call them so. The batch pipeline hands host arrays and a
device to `run_rows(core, ...)` (and the decode's overlap-add to
`decode_oa_rows`), the counterpart of the JAX package's `place_rows` +
core + `_unpad`: with more than one card in `_data_devices(device)` and
at least `_MIN_ROWS_PER_DEVICE` rows a card, `place_rows` cuts the batch
into contiguous row blocks, one a card (zero rows appended so that B
divides the card count), the core runs on every block before anything
waits, and the `Rows` result's `fetch` brings it to the host without the
padding. Rows never interact, so a block's rows are those of one call
over the whole batch, but for the overlap-add, which takes the tail of
the frame before a block from the previous block's card. With one card,
or sharding off, it is one upload and one call, as before the split.
"""

from __future__ import annotations

import contextlib
import os
from typing import NamedTuple

import numpy as np
import torch

from ..kernels.dequant import dequant
from ..kernels.i24_pack import i24_pack
from ..kernels.i24_unpack import i24_unpack
from ..kernels.mask_thres import mask_thres
from ..kernels.overlap_add import crossfade_window, overlap_add
from ..kernels.power_quant import power_quant
from ..kernels.thres_expand import thres_expand
from ..kernels.trunc_pack import trunc_pack
from ..kernels.trunc_unpack import trunc_unpack
from ..ops import policy, tns
from ..ops.dct import dct2, idct2

#: no split under 2 rows a card: the streaming engines' small calls stay
#: on one card
_MIN_ROWS_PER_DEVICE = 2

#: master switch of the split (FRAD_TORCH_NO_SHARD=1 turns it off for a
#: process, `sharding_disabled` for a scope), the counterpart of the JAX
#: package's FRAD_TPU_NO_SHARD
SHARDING = not os.environ.get("FRAD_TORCH_NO_SHARD")


@contextlib.contextmanager
def sharding_disabled():
    """Force the single-device path within the scope (for comparisons)."""
    global SHARDING
    old, SHARDING = SHARDING, False
    try:
        yield
    finally:
        SHARDING = old


def _data_devices(device: torch.device) -> list[torch.device]:
    """The cards a batch for `device` may be split over: every visible
    CUDA device for a `cuda` without an index (what `device=None`
    resolves to), else `device` alone (an explicit `cuda:k`, or `cpu`).
    While a `torch.distributed` group of more than one rank is up, each
    rank keeps to its own current card, as the JAX package keeps to a
    process's local devices: the ranks split the work between them."""
    if device.type != "cuda" or device.index is not None:
        return [device]
    if torch.distributed.is_available() and torch.distributed.is_initialized() \
            and torch.distributed.get_world_size() > 1:
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def data_sharding(nbatch: int, device: str | torch.device) -> list[torch.device] | None:
    """The cards a [nbatch, ...] batch is split over, or None for one call
    on `device`: sharding off, one card, or under 2 rows a card."""
    if not SHARDING:
        return None
    devs = _data_devices(torch.device(device))
    if len(devs) < 2 or nbatch < _MIN_ROWS_PER_DEVICE * len(devs):
        return None
    return devs


class Placed(NamedTuple):
    """A [B, ...] host array laid out by `place_rows`: equal contiguous row
    blocks in row order, block i on its card, the batch's last `pad` rows
    zeros."""
    blocks: list[torch.Tensor]
    pad: int


def padded_rows(nbatch: int, device: str | torch.device | None = None) -> int:
    """Rows `place_rows` uploads for a [nbatch, ...] batch: nbatch and the
    split's zero rows."""
    devs = data_sharding(nbatch, policy.resolve_device(device))
    return nbatch if devs is None else nbatch + (-nbatch) % len(devs)


def place_rows(arr: np.ndarray | torch.Tensor, device: str | torch.device | None = None,
               upload=None, nreal: int | None = None) -> Placed:
    """Upload a [B, ...] host array row-split over `data_sharding`'s cards,
    each block through `upload` (default `policy.to_device`: a pinned,
    non-blocking copy), with zero rows appended so that B divides the card
    count; with no split, one upload to `device` and pad 0. float64 splits
    too: the JAX package keeps float64 off an accelerator mesh only because
    it routes float64 to the host CPU, and the H100 runs float64 itself.
    With `nreal`, `arr` is a staging buffer (a numpy array or a pinned
    tensor) of `padded_rows(nreal)` rows whose rows past `nreal` are
    zero: each block is a slice of it."""
    dev = policy.resolve_device(device)
    upload = upload or policy.to_device
    nb = arr.shape[0] if nreal is None else nreal
    devs = data_sharding(nb, dev)
    if devs is None:
        return Placed([upload(arr[:nb], dev)], 0)
    pad = (-nb) % len(devs)
    rows = (nb + pad) // len(devs)
    blocks = []
    for i, d in enumerate(devs):
        blk = arr[i * rows:(i + 1) * rows]
        if len(blk) < rows:
            blk = np.concatenate([blk, np.zeros((rows - len(blk),) + arr.shape[1:], arr.dtype)])
        blocks.append(upload(blk, d))
    return Placed(blocks, pad)


class Rows:
    """A core's outputs over a `Placed` batch: `blocks[i]` is the tuple of
    block i's outputs, each [rows, ...] on block i's card; the batch's last
    `pad` rows are padding. `extra` holds outputs that are not rows (the
    decode's fragment)."""

    def __init__(self, blocks: list[tuple[torch.Tensor, ...]], pad: int,
                 extra: tuple[torch.Tensor, ...] = ()):
        self.blocks, self.pad, self.extra = blocks, pad, extra

    @property
    def nreal(self) -> int:
        """Rows of the batch without the padding."""
        return sum(b[0].shape[0] for b in self.blocks) - self.pad

    def real(self) -> list[int]:
        """Each block's rows that are not padding (the padding trails)."""
        left, out = self.nreal, []
        for b in self.blocks:
            out.append(min(b[0].shape[0], left))
            left -= out[-1]
        return out

    def fetch(self, to_host=None, which: tuple[int, ...] | None = None) -> list[np.ndarray]:
        """Outputs `which` (all, then the extras, when None) on the host,
        each joined in row order without the padding: one `to_host` call
        (default `policy.to_host`: a pinned copy a block, one synchronise a
        card)."""
        picks = range(len(self.blocks[0])) if which is None else which
        parts = [[b[j] if k == b[j].shape[0] else b[j][:k]
                  for b, k in zip(self.blocks, self.real()) if k] for j in picks]
        extra = self.extra if which is None else ()
        hs = (to_host or policy.to_host)(*(t for p in parts for t in p), *extra)
        out, at = [], 0
        for p in parts:
            out.append(hs[at] if len(p) == 1 else np.concatenate(hs[at:at + len(p)]))
            at += len(p)
        return out + list(hs[at:])


def _placed(x, device, upload) -> Placed:
    return x if isinstance(x, Placed) else place_rows(x, device, upload)


def run_rows(core, arrays, device, *args, upload=None) -> Rows:
    """`core(*block_tensors, *args)`, a core below, on every block of
    `arrays` (host arrays or `Placed`, all of the same B) on its card, each
    launched before any is waited for: nothing in a core synchronises.
    With one block it is one call of `core`, as without the split."""
    placed = [_placed(a, device, upload) for a in arrays]
    outs = []
    for parts in zip(*(p.blocks for p in placed)):
        out = core(*parts, *args)
        outs.append(out if isinstance(out, tuple) else (out,))
    return Rows(outs, placed[0].pad)


def p0_encode_core(frames: torch.Tensor) -> torch.Tensor:
    """[B, N, C] PCM -> [B, N, C] DCT-II 'forward' coefficients, in the
    dtype of `frames` (float32 or float64)."""
    return dct2(frames.transpose(1, 2)).transpose(1, 2)


def p0_decode_core(freqs: torch.Tensor) -> torch.Tensor:
    """[B, N, C] coefficients -> [B, N, C] PCM."""
    return idct2(freqs.transpose(1, 2)).transpose(1, 2)


def p0_encode_pack_core(frames: torch.Tensor, bits: int, little: bool):
    """[B, N, C] float32 PCM -> (payload words, maxabs [B] float32): the
    DCT GEMM, then the `trunc_pack` kernel on its [B, C, N] output, so
    the copy to the host carries the payload bytes. A frame whose maxabs
    exceeds the container float (or is NaN) must leave this path."""
    return trunc_pack(dct2(frames.transpose(1, 2)), bits, little)


def p0_encode_pack_core_i24(words: torch.Tensor, bits: int, little: bool, n: int, ch: int):
    """`p0_encode_pack_core` of int24 PCM words [B, n*ch*3//4] (the
    `i24_unpack` kernel first): the upload carries 3 bytes a sample."""
    frames = i24_unpack(words).reshape(words.shape[0], n, ch)
    return p0_encode_pack_core(frames, bits, little)


def p0_unpack_decode_core(words: torch.Tensor, bits: int, little: bool, n: int,
                          ch: int) -> torch.Tensor:
    """Payload words [B, W] -> [B, n, ch] float32 PCM: the `trunc_unpack`
    kernel, then the IDCT GEMM; the upload carries the payload bytes."""
    return idct2(trunc_unpack(words, bits, little, n, ch)).transpose(1, 2)


def p0_unpack_decode_i24_core(words: torch.Tensor, bits: int, little: bool, n: int,
                              ch: int) -> torch.Tensor:
    """`p0_unpack_decode_core` returning int24 PCM words [B, n*ch*3//4]
    (the `i24_pack` kernel on the IDCT's transposed output): the copy to
    the host carries 3 bytes a sample."""
    return i24_pack(p0_unpack_decode_core(words, bits, little, n, ch))


def p1_encode_core(frames: torch.Tensor, srate: int, loss_level: float, factor: float):
    """[B, N, C] PCM -> (freqs_q [B, N, C], thres_q [B, 27, C]): int32 for
    float32 frames, int64 for float64."""
    b, n, c = frames.shape
    freqs = dct2(frames.transpose(1, 2)).reshape(b * c, n).contiguous()
    div, thres_q = mask_thres(freqs, factor, loss_level, srate, c)
    freqs_q = power_quant(freqs, div, factor).reshape(b, c, n)
    return freqs_q.transpose(1, 2), thres_q


def p1_encode_core_i16(frames_i16: torch.Tensor, srate: int, loss_level: float, factor: float):
    """`p1_encode_core` on [B, N, C] int16 PCM (x * 32768): the upload
    carries 2 bytes per sample; the cast back is exact."""
    frames = frames_i16.to(torch.float32) * (1.0 / 32768.0)
    return p1_encode_core(frames, srate, loss_level, factor)


def p1_decode_core(freqs_flat: torch.Tensor, thres_flat: torch.Tensor,
                   srate: int, factor: float) -> torch.Tensor:
    """Profile 1 decode without overlap-add.

    freqs_flat [B, N, C] symbols (int16, or float32 / float64),
    thres_flat [B, 27, C] in the compute dtype -> [B, N, C] PCM in that
    dtype (a transposed view of the IDCT's [B, C, N] output)."""
    masked = dequant(freqs_flat.contiguous(), thres_flat.contiguous(), factor, srate)
    return idct2(masked).transpose(1, 2)


def _overlap_add_emit(pcm: torch.Tensor, olap: int, cut: int, i16: bool,
                      halo: torch.Tensor | None = None):
    """[B, N, C] decoded frames (a view of [B, C, N]) -> the `overlap_add`
    kernel's (out, frag)."""
    pcm = pcm.transpose(1, 2).contiguous()                           # [B, C, N]
    return overlap_add(pcm, crossfade_window(olap, pcm.device, pcm.dtype), cut, i16, halo)


def decode_oa_rows(decode, arrays, device, args, olap: int, cut: int, i16: bool,
                   upload=None) -> Rows:
    """The split decode + overlap-add of one uniform run, the counterpart of
    the JAX package's collective-permute: `decode(*block_tensors, *args)`
    (`p1_decode_core` or `p2_decode_core`) on every block of `arrays` on
    its card; then block i >= 1 gets the raw [C, olap] tail of block i-1's
    last frame as its halo (a copy between the two cards), and one
    `overlap_add` launch a block blends its first frame with it. Rows of
    [B, cut, C] out; `extra` holds the fragment [olap, C] for the next run:
    the tail of the last real frame, never of a padding row. With one block
    this is `p1_decode_oa_core` / `p2_decode_oa_core`, launch for launch."""
    placed = [_placed(a, device, upload) for a in arrays]
    pcms = [decode(*parts, *args) for parts in zip(*(p.blocks for p in placed))]
    blocks, frags = [], []
    for i, pcm in enumerate(pcms):
        halo = None
        if i and olap:
            tail = pcms[i - 1][-1, cut:cut + olap, :].T.contiguous()     # [C, olap]
            halo = tail.to(pcm.device, non_blocking=True)
        out, frag = _overlap_add_emit(pcm, olap, cut, i16, halo)
        blocks.append((out,))
        frags.append(frag)
    rows = Rows(blocks, placed[0].pad)
    at, last = divmod(rows.nreal - 1, pcms[0].shape[0])
    rows.extra = (frags[at] if last == pcms[at].shape[0] - 1
                  else pcms[at][last, cut:cut + olap, :],)
    return rows


def p1_decode_oa_core(freqs_flat: torch.Tensor, thres_flat: torch.Tensor,
                      srate: int, factor: float, olap: int, cut: int, i16: bool):
    """`p1_decode_core` + overlap-add of one uniform run -> (pcm_out
    [B, cut, C], int16 x32768 when `i16` else the compute dtype; fragment
    [olap, C], the raw tail of the last frame that the next run crossfades
    in)."""
    return _overlap_add_emit(p1_decode_core(freqs_flat, thres_flat, srate, factor),
                             olap, cut, i16)


def p2_encode_core(frames: torch.Tensor, srate: int, loss_level: float, factor: float):
    """[B, N, C] PCM -> (freqs_q [B, N, C], thres_q [B, 27, C], lpc_q
    [B, 13, C]): Profile 1's chain with the TNS analysis between the
    masking divide and the quantiser. int32 for float32 frames, int64 for
    float64."""
    b, n, c = frames.shape
    freqs = dct2(frames.transpose(1, 2)).reshape(b * c, n).contiguous()
    div, thres_q = mask_thres(freqs, factor, loss_level, srate, c)
    masked, lpc_q = tns.tns_analysis(freqs, div)
    freqs_q = power_quant(masked, None, factor).reshape(b, c, n)
    return (freqs_q.transpose(1, 2), thres_q,
            lpc_q.reshape(b, c, -1).to(freqs_q.dtype).transpose(1, 2))


def p2_decode_core(freqs_flat: torch.Tensor, thres_flat: torch.Tensor,
                   lpc_flat: torch.Tensor, srate: int, factor: float) -> torch.Tensor:
    """Inverse of `p2_encode_core` without overlap-add: freqs_flat
    [B, N, C] symbols (int16, or the compute dtype), thres_flat [B, 27, C]
    and lpc_flat [B, 13, C] in the compute dtype -> [B, N, C] PCM."""
    masked = dequant(freqs_flat.contiguous(), None, factor)          # [B, C, N]
    freqs = tns.tns_synthesis(masked, lpc_flat.transpose(1, 2)) \
        * thres_expand(thres_flat.contiguous(), freqs_flat.shape[1], srate)
    return idct2(freqs).transpose(1, 2)


def p2_decode_oa_core(freqs_flat: torch.Tensor, thres_flat: torch.Tensor,
                      lpc_flat: torch.Tensor, srate: int, factor: float,
                      olap: int, cut: int, i16: bool):
    """`p2_decode_core` + overlap-add of one uniform run; returns as
    `p1_decode_oa_core` does."""
    return _overlap_add_emit(p2_decode_core(freqs_flat, thres_flat, lpc_flat, srate, factor),
                             olap, cut, i16)


def overlap_add_core(frames: torch.Tensor, olap: int, cut: int) -> torch.Tensor:
    """[B, N, C] decoded frames -> [B, cut, C] overlap-added PCM
    (frame 0's head fade-free; the stream tail is frames[-1, cut:])."""
    return _overlap_add_emit(frames, olap, cut, False)[0]


def overlap_frame_starts(total: int, fsize: int, overlap_ratio: int) -> tuple[np.ndarray, int]:
    """Frame start offsets and overlap length for a uniformly-framed
    stream: each frame after the first re-reads the trailing
    `fsize - fsize*(r-1)//r` samples of its predecessor."""
    if overlap_ratio > 1:
        olap = fsize - fsize * (overlap_ratio - 1) // overlap_ratio
    else:
        olap = 0
    hop = fsize - olap
    if total <= fsize:
        return np.array([0], dtype=np.int64), olap
    n_extra = -(-(total - fsize) // hop)
    starts = np.concatenate([[0], fsize - olap + hop * np.arange(n_extra)])
    return starts.astype(np.int64), olap
