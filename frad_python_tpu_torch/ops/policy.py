"""Device and numerics policy of the port.

* Device: every public entry takes `device`. `None` means CUDA; when no
  CUDA device exists that raises instead of running on the CPU. The CPU
  is used only when a caller asks for it (the tests do, with the kernels'
  plain versions).
* Compute dtype: FRAD_TORCH_COMPUTE_DTYPE (the counterpart of the JAX
  package's FRAD_TPU_COMPUTE_DTYPE), float32 by default, the JAX
  package's accelerator default. float32 is full IEEE float32: on a CUDA
  device `resolve_device` pins `torch.backends.cuda.matmul.allow_tf32 =
  False` and `torch.backends.cudnn.allow_tf32 = False`, so the DCT/IDCT
  and the masking GEMMs never drop to TF32, the counterpart of the JAX
  package's `Precision.HIGHEST`. The JAX package's reduced-precision
  lossy GEMMs were a TPU trade-off and are not carried over. float64 (the
  JAX package's default off the TPU) runs on the device for every
  profile (the H100 has native FP64), and always for the 48- and 64-bit
  lossless containers; the lossy profiles at float64 give int64 symbols
  and take the host EGR coder and the Python payload unpack, as in the
  JAX package.
"""

from __future__ import annotations

import os

import numpy as np
import torch

#: container depths from this one up exceed float32 transform precision
#: (a truncated f64 keeps 36 or 52 mantissa bits): their transform is
#: always float64
DEEP_BITS = 48

_DTYPES = ("float32", "float64")


def compute_dtype() -> str:
    """FRAD_TORCH_COMPUTE_DTYPE (float32 or float64), float32 when unset."""
    env = os.environ.get("FRAD_TORCH_COMPUTE_DTYPE") or "float32"
    if env not in _DTYPES:
        raise ValueError(f"FRAD_TORCH_COMPUTE_DTYPE={env!r}: expected one of {_DTYPES}")
    return env


def transform_dtype(bits: int, dtype: str | None = None) -> str:
    """Dtype of a lossless transform into a `bits`-deep container: float64
    for the 48- and 64-bit containers, `check_compute_dtype(dtype)` below
    them."""
    return "float64" if bits >= DEEP_BITS else check_compute_dtype(dtype)


def resolve_device(device: str | torch.device | None) -> torch.device:
    """`device`, or CUDA when None; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' explicitly "
                "to run the plain PyTorch versions on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def check_compute_dtype(dtype: str | None) -> str:
    """The compute dtype of a run: `dtype`, or `compute_dtype()` when None. Raises ValueError for a dtype other than float32 and
    float64."""
    dt = dtype or compute_dtype()
    if dt not in _DTYPES:
        raise ValueError(f"compute_dtype={dt!r}: expected one of {_DTYPES}")
    return dt


def to_device(arr: np.ndarray | torch.Tensor, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on `device`. CUDA uploads go through a pinned
    staging buffer with a non-blocking copy; a read-only array (a payload
    viewed with np.frombuffer) is copied, never aliased. A host tensor (a
    pinned staging buffer the caller filled) is uploaded as it is."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device, non_blocking=True)
    arr = np.ascontiguousarray(arr)
    if device.type != "cuda":
        return torch.from_numpy(arr if arr.flags.writeable else arr.copy())
    staged = torch.empty(arr.shape, dtype=torch.from_numpy(arr[:0].copy()).dtype,
                         pin_memory=True)
    staged.numpy()[...] = arr
    return staged.to(device, non_blocking=True)


def device_key(device: str | torch.device) -> torch.device:
    """`device` as a cache key: a `torch.device` with its index, so that
    'cuda', 'cuda:k' of the current card and a string name one entry."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def synchronize(tensors) -> None:
    """Wait once for the current stream of each distinct CUDA device among
    `tensors`: a copy from a card is queued on that card's stream, which
    need not be the current device's."""
    for dev in dict.fromkeys(t.device for t in tensors if t.device.type == "cuda"):
        torch.cuda.current_stream(dev).synchronize()


def to_host(*tensors: torch.Tensor) -> list[np.ndarray]:
    """Tensors -> numpy arrays. CUDA tensors are copied into pinned
    buffers with non-blocking copies, then each card they lie on is
    synchronised once."""
    outs = []
    for t in tensors:
        if t.device.type == "cuda":
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            outs.append(h)
        else:
            outs.append(t)
    synchronize(tensors)
    return [o.numpy() for o in outs]
