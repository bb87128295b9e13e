"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: the counterparts of the JAX package's Pallas kernels
(frad_python_tpu/research/pallas_kernels.py).

* `power_quant.power_quant` — the encoder's quantisation epilogue
  (Pallas `power_quant`), source csrc/power_quant.cu.
* `overlap_add.overlap_add` — the decoder's overlap-add and PCM emit
  (Pallas `crossfade_frames`), source csrc/overlap_add.cu.

A wrapper runs the plain version for CPU tensors and launches its kernel
for CUDA tensors, counting launches in its `launches` attribute. The
kernels are compiled at first launch (`build.py`).
"""

from .overlap_add import overlap_add, overlap_add_plain
from .power_quant import power_quant, power_quant_plain

KERNELS = (power_quant, overlap_add)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for k in KERNELS:
        k.launches = 0


__all__ = ["KERNELS", "overlap_add", "overlap_add_plain", "power_quant",
           "power_quant_plain", "reset_launches"]
