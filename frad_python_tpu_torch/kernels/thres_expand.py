"""`thres_expand`: the lossy decoders' threshold expansion, before the
interpolation GEMM.

The port of the head of the JAX package's XLA device programs
frad_python_tpu/models/batch.py:_p1_decode_jit and :_p2_decode_jit
(`(e/2) ** quant_jnp(thres)`): threshold symbols [B, 27, C] ->
thresholds [B, C, 27] = (e/2)^(sign(t) * sqrt(|t| * sqrt(|t|))), the
transpose included. `thres_expand` launches the CUDA kernel
(csrc/thres_expand.cu) for CUDA tensors and runs `thres_expand_plain` for
CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import psycho
from . import build
from .mask_thres import E_HALF


def thres_expand_plain(thres_flat: torch.Tensor) -> torch.Tensor:
    """[B, 27, C] threshold symbols (float32 or float64) -> [B, C, 27]
    thresholds: the 3/4-power compand in its square-root form, then the
    power of e/2. The result keeps the strides torch gives a transposed
    view's result (the kernel's is contiguous): the values are the same."""
    e_half = torch.tensor(E_HALF, dtype=thres_flat.dtype, device=thres_flat.device)
    return torch.pow(e_half, psycho.quant(thres_flat.transpose(1, 2)))


def thres_expand(thres_flat: torch.Tensor) -> torch.Tensor:
    """See `thres_expand_plain`; one kernel launch for a CUDA tensor."""
    if thres_flat.device.type == "cpu":
        return thres_expand_plain(thres_flat)
    if thres_flat.device.type != "cuda":
        raise ValueError(f"thres_expand: tensor on {thres_flat.device}")
    if thres_flat.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"thres_expand: float32 or float64 required, got {thres_flat.dtype}")
    if thres_flat.dim() != 3 or thres_flat.shape[1] != psycho.SUBBANDS \
            or not thres_flat.is_contiguous():
        raise ValueError(f"thres_expand: contiguous [B, {psycho.SUBBANDS}, C] required, got "
                         f"{tuple(thres_flat.shape)}")
    b, _, c = thres_flat.shape
    out = torch.empty((b, c, psycho.SUBBANDS), dtype=thres_flat.dtype,
                      device=thres_flat.device)
    lib = build.library()
    err = lib.frad_thres_expand(
        ctypes.c_void_p(thres_flat.data_ptr()), ctypes.c_void_p(out.data_ptr()), b, c, E_HALF,
        int(thres_flat.dtype == torch.float64),
        ctypes.c_void_p(torch.cuda.current_stream(thres_flat.device).cuda_stream))
    build.check("frad_thres_expand", err)
    thres_expand.launches += 1
    return out


#: kernel launches since the last reset (CPU calls do not count)
thres_expand.launches = 0
