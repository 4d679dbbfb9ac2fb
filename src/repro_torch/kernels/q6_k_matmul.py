"""Q6_K fused dequant-matmul: wrapper of ``csrc/q6_k_matmul.cu``.

The port of ``repro.kernels.q6_k_matmul.matmul_q6_k`` (paper Fig. 8:
4+2-bit quants, int8 sub-scales per 16, an fp16 super-scale per 256,
decoded in the front-end; one shared f32 MAC back-end). On a CPU tensor
the wrapper computes the plain version (``ref.matmul_ref``); on a CUDA
tensor it launches the hand-written kernel or raises.

Planes: {"ql": int32 (N, K/8), "qh": int32 (N, K/16),
         "sc": int8 (N, K/16), "d": float16 (N, K/256)}; K % 256 == 0.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _dequant_matmul as _dm
from repro_torch.kernels.ref import matmul_ref

LAYOUT = {"ql": (8, torch.int32), "qh": (16, torch.int32),
          "sc": (16, torch.int8), "d": (256, torch.float16)}


def matmul_q6_k(x: torch.Tensor, ql: torch.Tensor, qh: torch.Tensor,
                sc: torch.Tensor, d: torch.Tensor, *,
                out_dtype=torch.float32,
                plan_parts=(1, 1)) -> torch.Tensor:
    """x: (M, K) f32|bf16 and the q6_k planes of an (N, K) weight.
    Returns (M, N) in ``out_dtype`` (f32, or bf16 rounded from the f32
    result)."""
    planes = {"ql": ql, "qh": qh, "sc": sc, "d": d}
    _dm.check("matmul_q6_k", x, planes, LAYOUT, 256, out_dtype)
    if x.device.type == "cpu":
        return matmul_ref(x, planes, "q6_k").to(out_dtype)
    return _dm.launch(matmul_q6_k, "q6_k_matmul", x, (ql, qh, sc, d),
                      ql.shape[0], out_dtype,
                      plan_parts=plan_parts)


matmul_q6_k.launches = 0
