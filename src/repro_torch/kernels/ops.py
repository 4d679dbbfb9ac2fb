"""Dispatch wrapper over the port's matmul kernels.

``quantized_matmul`` is the single entry point the model layers call.
There is no ``impl`` switch: the tensor's device decides. A CPU tensor
takes the plain version (``ref.matmul_ref``) for every format; a CUDA
tensor takes the hand-written kernel of its format, and a format whose
kernel is not ported yet raises instead of dropping to the plain
version.

x may carry arbitrary leading batch dims; they are flattened to M.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.quant.pack import Planes
from repro_torch.kernels import ref as ref_ops
from repro_torch.kernels.q8_0_matmul import matmul_q8_0

# Formats whose CUDA kernel is still to be ported -> its ROADMAP item.
_PENDING_KERNELS = {"fp16": "B4", "q6_k": "B5", "q3_k": "B6"}


def quantized_matmul(x: torch.Tensor, planes: Planes, fmt: str, *,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """y[..., N] = x[..., K] @ dequant(planes)[N, K]^T (f32, or out_dtype)."""
    lead = x.shape[:-1]
    k = x.shape[-1]
    x2 = x.reshape(-1, k)
    # Zero-pad K up to the format's packed width (quantizers pad rows the
    # same way, so the dot is exact).
    if fmt == "fp16":
        kp = planes["w"].shape[1]
    elif fmt == "q8_0":
        kp = planes["qs"].shape[1]
    else:
        kp = planes["ql"].shape[1] * (8 if fmt == "q6_k" else 16)
    if kp != k:
        x2 = F.pad(x2, (0, kp - k))

    if fmt == "q8_0":
        # The kernel rounds its f32 result to out_dtype itself.
        y = matmul_q8_0(x2.contiguous(), planes["qs"], planes["d"],
                        out_dtype=out_dtype or torch.float32)
    elif fmt not in _PENDING_KERNELS:
        raise ValueError(f"unknown format {fmt!r}")
    elif x2.device.type == "cpu":
        y = ref_ops.matmul_ref(x2, planes, fmt)
    else:
        raise NotImplementedError(
            f"no CUDA kernel for {fmt!r} yet (ROADMAP "
            f"{_PENDING_KERNELS[fmt]}); the plain version runs only on CPU "
            "tensors")
    y = y.reshape(*lead, y.shape[-1])
    return y.to(out_dtype) if out_dtype is not None else y
