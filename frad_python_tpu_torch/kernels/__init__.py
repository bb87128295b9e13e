"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: the counterparts of the JAX package's Pallas kernels
(frad_python_tpu/research/pallas_kernels.py) and of the XLA device
programs of the Profile 0 fast path (frad_python_tpu/ops/bitpack.py), of
Profile 2's TNS (frad_python_tpu/ops/tns_jax.py), of Profile 1's
Exp-Golomb-Rice packer (frad_python_tpu/ops/bitpack.py, parallel/
pipeline.py), of the lossy decoders' dequantiser and of the masking
threshold chains of the lossy encoders and decoders
(frad_python_tpu/models/batch.py, ops/psycho.py), and of the lossless
profiles' int24 transfer forms (frad_python_tpu/ops/bitpack.py). Thirteen
kernels for fourteen device programs:

* `power_quant.power_quant` — the lossy encoders' quantisation epilogue
  (Pallas `power_quant`), float32 -> int32 or float64 -> int64, with or
  without a divisor, source csrc/power_quant.cu.
* `overlap_add.overlap_add` — the lossy decoders' overlap-add and PCM
  emit (Pallas `crossfade_frames`), float32 or float64, with an optional
  halo for the first frame (the sharded overlap-add's), source
  csrc/overlap_add.cu with csrc/vec_io.cuh.
* `trunc_pack.trunc_pack` — the Profile 0 encoder's truncated-float pack
  of the DCT output with each frame's max|x| (XLA `trunc_pack`), source
  csrc/trunc_pack.cu.
* `trunc_unpack.trunc_unpack` — the Profile 0 decoder's unpack into the
  IDCT's layout (XLA `trunc_unpack`), source csrc/trunc_unpack.cu.
* `tns_iir.tns_iir` — Profile 2's TNS synthesis recurrence (XLA `_iir`, a
  scan over time), source csrc/tns_iir.cu.
* `egr_pack.egr_pack` — Profile 1's Exp-Golomb-Rice bit-packer with the
  compaction of the used words (XLA `egr_pack_frames` and
  `_egr_compact_packer`), source csrc/egr_pack.cu.
* `dequant.dequant` — the lossy decoders' dequantiser in the IDCT's
  layout, with Profile 1's threshold expansion folded in (the pre-IDCT
  chain of XLA `_p1_decode_jit` / `_p2_decode_jit`), source
  csrc/dequant.cu with csrc/thres_interp.cuh and csrc/vec_io.cuh.
* `tns_autocorr.tns_autocorr` — the front of Profile 2's TNS analysis: the
  masking divide, the windowed autocorrelation and the flatness and energy
  gates (XLA `_autocorr`, `_flatness_gate`), source csrc/tns_autocorr.cu.
* `tns_fir_gate.tns_fir_gate` — its back: the order-12 Levinson-Durbin
  recursion, coefficient quantisation, the analysis FIR, the remaining
  gates and the selects (XLA `_levinson`, `_quantise`, `_fir`,
  `_predgain`, the tail of `tns_analysis`), source csrc/tns_fir_gate.cu
  with the recursion in csrc/tns_levinson.cuh (`tns_levinson_plain` is
  its plain version).
* `mask_thres.mask_thres` — the lossy encoders' masking chain from the
  spectra to the per-bin divisor, with the threshold symbols (XLA
  `mask_thres_mos_jnp` of |X| * factor with its band-sum product,
  `mapping_from_opus_jnp` and the symbols of `_p1_encode_jit` /
  `_p2_encode_jit`), source csrc/mask_thres.cu with csrc/thres_interp.cuh.
* `thres_expand.thres_expand` — the Profile 2 decoder's threshold chain
  from the symbols to the per-bin divisor (the head of XLA
  `_p2_decode_jit` with `mapping_from_opus_jnp`; Profile 1's runs inside
  `dequant`), source csrc/thres_expand.cu with csrc/thres_interp.cuh.
* `i24_pack.i24_pack` — the Profile 0 decoder's PCM as int24 fixed-point
  words for the copy back (XLA `pcm_to_i24_words`), source
  csrc/i24_pack.cu.
* `i24_unpack.i24_unpack` — the Profile 0 encoder's uploaded int24 words
  as float32 PCM (XLA `i24_words_to_pcm_device`), source
  csrc/i24_unpack.cu.

A wrapper runs the plain version for CPU tensors and launches its kernel
for CUDA tensors, counting launches in its `launches` attribute. The
kernels are compiled at first launch (`build.py`).
"""

from .dequant import dequant, dequant_plain
from .egr_pack import egr_pack, egr_pack_plain
from .i24_pack import i24_pack, i24_pack_plain
from .i24_unpack import i24_unpack, i24_unpack_plain
from .mask_thres import mask_thres, mask_thres_plain
from .overlap_add import overlap_add, overlap_add_plain
from .power_quant import power_quant, power_quant_plain
from .thres_expand import thres_expand, thres_expand_plain
from .tns_autocorr import tns_autocorr, tns_autocorr_plain
from .tns_fir_gate import tns_fir_gate, tns_fir_gate_plain
from .tns_iir import tns_iir, tns_iir_plain
from .tns_levinson import tns_levinson_plain
from .trunc_pack import trunc_pack, trunc_pack_plain
from .trunc_unpack import trunc_unpack, trunc_unpack_plain

KERNELS = (power_quant, overlap_add, trunc_pack, trunc_unpack, tns_iir, egr_pack, dequant,
           tns_autocorr, tns_fir_gate, mask_thres, thres_expand, i24_pack, i24_unpack)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for k in KERNELS:
        k.launches = 0


__all__ = ["KERNELS", "dequant", "dequant_plain", "egr_pack", "egr_pack_plain", "i24_pack",
           "i24_pack_plain", "i24_unpack", "i24_unpack_plain", "mask_thres",
           "mask_thres_plain", "overlap_add", "overlap_add_plain", "power_quant",
           "power_quant_plain", "reset_launches", "thres_expand", "thres_expand_plain",
           "tns_autocorr", "tns_autocorr_plain", "tns_fir_gate", "tns_fir_gate_plain", "tns_iir",
           "tns_iir_plain", "tns_levinson_plain", "trunc_pack",
           "trunc_pack_plain", "trunc_unpack", "trunc_unpack_plain"]
