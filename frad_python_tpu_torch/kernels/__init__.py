"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: the counterparts of the JAX package's Pallas kernels
(frad_python_tpu/research/pallas_kernels.py) and of the XLA device
programs of the Profile 0 fast path (frad_python_tpu/ops/bitpack.py).

* `power_quant.power_quant` — the encoder's quantisation epilogue
  (Pallas `power_quant`), source csrc/power_quant.cu.
* `overlap_add.overlap_add` — the decoder's overlap-add and PCM emit
  (Pallas `crossfade_frames`), source csrc/overlap_add.cu.
* `trunc_pack.trunc_pack` — the Profile 0 encoder's truncated-float pack
  of the DCT output with each frame's max|x| (XLA `trunc_pack`), source
  csrc/trunc_pack.cu.
* `trunc_unpack.trunc_unpack` — the Profile 0 decoder's unpack into the
  IDCT's layout (XLA `trunc_unpack`), source csrc/trunc_unpack.cu.

A wrapper runs the plain version for CPU tensors and launches its kernel
for CUDA tensors, counting launches in its `launches` attribute. The
kernels are compiled at first launch (`build.py`).
"""

from .overlap_add import overlap_add, overlap_add_plain
from .power_quant import power_quant, power_quant_plain
from .trunc_pack import trunc_pack, trunc_pack_plain
from .trunc_unpack import trunc_unpack, trunc_unpack_plain

KERNELS = (power_quant, overlap_add, trunc_pack, trunc_unpack)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for k in KERNELS:
        k.launches = 0


__all__ = ["KERNELS", "overlap_add", "overlap_add_plain", "power_quant",
           "power_quant_plain", "reset_launches", "trunc_pack", "trunc_pack_plain",
           "trunc_unpack", "trunc_unpack_plain"]
