"""FP16 fused upconvert-matmul: wrapper of ``csrc/fp16_matmul.cu``.

The port of ``repro.kernels.fp16_matmul.matmul_fp16`` (paper Fig. 6:
fp16 weights upconverted in the front-end, one shared f32 MAC
back-end). On a CPU tensor the wrapper computes the plain version
(``ref.matmul_ref``); on a CUDA tensor it launches the hand-written
kernel or raises.

Planes: {"w": float16 (N, K)}; any K (the kernel masks its K tail, so
nothing is padded).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _dequant_matmul as _dm
from repro_torch.kernels.ref import matmul_ref

LAYOUT = {"w": (1, torch.float16)}


def matmul_fp16(x: torch.Tensor, w: torch.Tensor, *,
                out_dtype=torch.float32,
                plan_parts=(1, 1)) -> torch.Tensor:
    """x: (M, K) f32|bf16; w: (N, K) f16. Returns (M, N) in
    ``out_dtype`` (f32, or bf16 rounded from the f32 result)."""
    planes = {"w": w}
    _dm.check("matmul_fp16", x, planes, LAYOUT, 1, out_dtype)
    if x.device.type == "cpu":
        return matmul_ref(x, planes, "fp16").to(out_dtype)
    return _dm.launch(matmul_fp16, "fp16_matmul", x, (w,), w.shape[0],
                      out_dtype,
                      plan_parts=plan_parts)


matmul_fp16.launches = 0
