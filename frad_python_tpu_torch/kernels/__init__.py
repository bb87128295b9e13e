"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: the counterparts of the JAX package's Pallas kernels
(frad_python_tpu/research/pallas_kernels.py) and of the XLA device
programs of the Profile 0 fast path (frad_python_tpu/ops/bitpack.py) and
of Profile 2's TNS (frad_python_tpu/ops/tns_jax.py).

* `power_quant.power_quant` — the lossy encoders' quantisation epilogue
  (Pallas `power_quant`), float32 -> int32 or float64 -> int64, with or
  without a divisor, source csrc/power_quant.cu.
* `overlap_add.overlap_add` — the lossy decoders' overlap-add and PCM
  emit (Pallas `crossfade_frames`), float32 or float64, source
  csrc/overlap_add.cu.
* `trunc_pack.trunc_pack` — the Profile 0 encoder's truncated-float pack
  of the DCT output with each frame's max|x| (XLA `trunc_pack`), source
  csrc/trunc_pack.cu.
* `trunc_unpack.trunc_unpack` — the Profile 0 decoder's unpack into the
  IDCT's layout (XLA `trunc_unpack`), source csrc/trunc_unpack.cu.
* `tns_iir.tns_iir` — Profile 2's TNS synthesis recurrence (XLA `_iir`, a
  scan over time), source csrc/tns_iir.cu.
* `tns_levinson.tns_levinson` — Profile 2's order-12 Levinson-Durbin
  recursion (XLA `_levinson`), source csrc/tns_levinson.cu.

A wrapper runs the plain version for CPU tensors and launches its kernel
for CUDA tensors, counting launches in its `launches` attribute. The
kernels are compiled at first launch (`build.py`).
"""

from .overlap_add import overlap_add, overlap_add_plain
from .power_quant import power_quant, power_quant_plain
from .tns_iir import tns_iir, tns_iir_plain
from .tns_levinson import tns_levinson, tns_levinson_plain
from .trunc_pack import trunc_pack, trunc_pack_plain
from .trunc_unpack import trunc_unpack, trunc_unpack_plain

KERNELS = (power_quant, overlap_add, trunc_pack, trunc_unpack, tns_iir, tns_levinson)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for k in KERNELS:
        k.launches = 0


__all__ = ["KERNELS", "overlap_add", "overlap_add_plain", "power_quant",
           "power_quant_plain", "reset_launches", "tns_iir", "tns_iir_plain",
           "tns_levinson", "tns_levinson_plain", "trunc_pack", "trunc_pack_plain",
           "trunc_unpack", "trunc_unpack_plain"]
