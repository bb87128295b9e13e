"""frad_python_tpu_torch — the FrAD codec engine on PyTorch and CUDA.

A port of `frad_python_tpu` (JAX on a TPU) to PyTorch on an NVIDIA
Hopper GPU. The port carries the whole codec, profiles 0, 1, 2 and 4 at
float32 and float64: the streaming engines `Encoder`, `Decoder` and
`Repairer` (push bytes in, get bytes or PCM out), the batch path,
`batch_encode` and `batch_decode` of whole PCM arrays and streams, with
ECC armor and error repair, `batch_repair` of streams, and the command
line with the FrAD file header (`python -m frad_python_tpu_torch`,
`app/`, `container/head.py`), and the sharded cores over a device mesh
with the overlap-add's halo exchange and the multi-process span encode and
stream gather over `torch.distributed` (`parallel/sharded.py`,
`parallel/multihost.py`; NCCL on CUDA, gloo on the CPU). The JAX
package's Pallas kernels and the device programs around them are thirteen
hand-written CUDA kernels (`kernels/`, `csrc/`), built with nvcc at first
use; the host byte work runs in the C++ host module (`native/`), built
with g++ at first use.
Every entry point runs on CUDA unless the caller asks for the CPU
(`device="cpu"`, `--device cpu`). Importing the package has no side
effects and never imports jax.
"""

from .decoder import DecodeResult, Decoder
from .encoder import EncodeResult, Encoder
from .parallel.pipeline import batch_decode, batch_encode, batch_repair
from .repairer import Repairer

__version__ = "0.1.0"

__all__ = ["DecodeResult", "Decoder", "EncodeResult", "Encoder", "Repairer",
           "batch_decode", "batch_encode", "batch_repair"]
