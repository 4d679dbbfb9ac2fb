"""Dispatch wrapper over the port's matmul kernels.

``quantized_matmul`` is the single entry point the model layers call.
There is no ``impl`` switch: the tensor's device decides. Every format
goes to its kernel's wrapper, which takes the plain version
(``ref.matmul_ref``) for a CPU tensor and launches the hand-written
kernel for a CUDA tensor, or raises; nothing drops to the plain
version on the card.

x may carry arbitrary leading batch dims; they are flattened to M.
``plan_rows`` scopes a packed serving step: every launch inside plans
its split of K from the step's unpacked rows, and a CPU product inside
is computed at those rows (``planned_rows``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.quant.pack import Planes
from repro_torch.kernels import fp16_matmul, q3_k_matmul, q6_k_matmul
from repro_torch.kernels import q8_0_matmul
from repro_torch.kernels._dequant_matmul import plan_rows  # noqa: F401
from repro_torch.kernels._dequant_matmul import planned_rows

# format -> (wrapper, its planes' layout in argument order:
#            {plane: (K elements per plane column, dtype)})
MATMUL_KERNELS = {
    "fp16": (fp16_matmul.matmul_fp16, fp16_matmul.LAYOUT),
    "q8_0": (q8_0_matmul.matmul_q8_0, q8_0_matmul.LAYOUT),
    "q6_k": (q6_k_matmul.matmul_q6_k, q6_k_matmul.LAYOUT),
    "q3_k": (q3_k_matmul.matmul_q3_k, q3_k_matmul.LAYOUT),
}


def quantized_matmul(x: torch.Tensor, planes: Planes, fmt: str, *,
                     out_dtype: Optional[torch.dtype] = None,
                     approx_cvt53: bool = False,
                     plan_parts=(1, 1)) -> torch.Tensor:
    """y[..., N] = x[..., K] @ dequant(planes)[N, K]^T (f32, or out_dtype).
    ``approx_cvt53`` (q3_k only): the paper's CVT53 scales, ``sc & ~1``.
    ``plan_parts``: (row, column) blocks of the unsharded call this one
    is a shard of (``parallel.sharding.plan_parts``)."""
    if fmt not in MATMUL_KERNELS:
        raise ValueError(f"unknown format {fmt!r}")
    if approx_cvt53 and fmt != "q3_k":
        raise ValueError(f"approx_cvt53 is a q3_k option; got {fmt!r}")
    kw = {"approx_cvt53": True} if approx_cvt53 else {}
    wrapper, layout = MATMUL_KERNELS[fmt]
    lead = x.shape[:-1]
    k = x.shape[-1]
    x2 = x.reshape(-1, k)
    # Zero-pad K up to the format's packed width (quantizers pad rows the
    # same way, so the dot is exact).
    first = next(iter(layout))
    kp = planes[first].shape[1] * layout[first][0]
    if kp != k:
        x2 = F.pad(x2, (0, kp - k))
    # The wrapper rounds its f32 result to out_dtype itself.
    y = planned_rows(x2, lambda a: wrapper(
        a.contiguous(), *(planes[n] for n in layout),
        out_dtype=out_dtype or torch.float32, plan_parts=plan_parts, **kw))
    return y.reshape(*lead, y.shape[-1])
