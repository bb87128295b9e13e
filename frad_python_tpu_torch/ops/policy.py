"""Device and numerics policy of the port.

* Device: every public entry takes `device`. `None` means CUDA; when no
  CUDA device exists that raises instead of running on the CPU. The CPU
  is used only when a caller asks for it (the tests do, with the kernels'
  plain versions).
* Compute dtype: float32 throughout, full IEEE float32. On a CUDA device
  `resolve_device` pins `torch.backends.cuda.matmul.allow_tf32 = False`
  and `torch.backends.cudnn.allow_tf32 = False`, so the DCT/IDCT and the
  masking GEMMs never drop to TF32: the counterpart of the JAX package's
  `Precision.HIGHEST`. The JAX package's reduced-precision lossy GEMMs
  were a TPU trade-off and are not carried over. float64 compute is not
  part of this port yet and raises.
"""

from __future__ import annotations

import numpy as np
import torch


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


def check_compute_dtype(compute_dtype: str | None) -> None:
    """The port computes in float32 only."""
    if compute_dtype not in (None, "float32"):
        raise NotImplementedError(
            f"compute_dtype={compute_dtype!r}: the port computes in float32 "
            "only; float64 compute is not ported yet")


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on `device`. CUDA uploads go through a pinned
    staging buffer with a non-blocking copy."""
    src = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return src
    staged = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    staged.copy_(src)
    return staged.to(device, non_blocking=True)


def to_host(*tensors: torch.Tensor) -> list[np.ndarray]:
    """Tensors -> numpy arrays. CUDA tensors are copied into pinned
    buffers with non-blocking copies and one stream synchronise."""
    outs = []
    for t in tensors:
        if t.device.type == "cuda":
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            outs.append(h)
        else:
            outs.append(t)
    if any(t.device.type == "cuda" for t in tensors):
        torch.cuda.current_stream().synchronize()
    return [o.numpy() for o in outs]
