"""frad_python_tpu_torch — the FrAD codec engine on PyTorch and CUDA.

A port of `frad_python_tpu` (JAX on a TPU) to PyTorch on an NVIDIA
Hopper GPU. The port carries Profile 1: the streaming engines `Encoder`,
`Decoder` and `Repairer` (push bytes in, get bytes or PCM out), and the
batch path, `batch_encode` and `batch_decode` of whole PCM arrays and
streams, with ECC armor and error repair, and `batch_repair` of streams.
The JAX package's Pallas kernels become hand-written CUDA kernels
(`kernels/`), built with nvcc at first use; the host byte work runs in
the C++ host module (`native/`), built with g++ at first use. Importing
the package has no side effects and never imports jax.
"""

from .decoder import DecodeResult, Decoder
from .encoder import EncodeResult, Encoder
from .parallel.pipeline import batch_decode, batch_encode, batch_repair
from .repairer import Repairer

__version__ = "0.1.0"

__all__ = ["DecodeResult", "Decoder", "EncodeResult", "Encoder", "Repairer",
           "batch_decode", "batch_encode", "batch_repair"]
