"""Q8_0 fused dequant-matmul: wrapper of ``csrc/q8_0_matmul.cu``.

The port of ``repro.kernels.q8_0_matmul.matmul_q8_0`` (paper Fig. 5/7:
int8 quants scaled per 32-element block by an fp16 scale, one shared
f32 MAC back-end). On a CPU tensor the wrapper computes the plain
version (``ref.matmul_ref``); on a CUDA tensor it launches the
hand-written kernel or raises.

Planes: {"qs": int8 (N, K), "d": float16 (N, K/32)}; K % 32 == 0.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _dequant_matmul as _dm
from repro_torch.kernels.ref import matmul_ref

LAYOUT = {"qs": (1, torch.int8), "d": (32, torch.float16)}


def matmul_q8_0(x: torch.Tensor, qs: torch.Tensor, d: torch.Tensor, *,
                out_dtype=torch.float32,
                plan_parts=(1, 1)) -> torch.Tensor:
    """x: (M, K) f32|bf16; qs: (N, K) int8; d: (N, K//32) f16.
    Returns (M, N) in ``out_dtype`` (f32, or bf16 rounded from the f32
    result). ``plan_parts``: (row, column) blocks of the unsharded call
    this one is a shard of; the launch is planned for that call."""
    planes = {"qs": qs, "d": d}
    _dm.check("matmul_q8_0", x, planes, LAYOUT, 32, out_dtype)
    if x.device.type == "cpu":
        return matmul_ref(x, planes, "q8_0").to(out_dtype)
    return _dm.launch(matmul_q8_0, "q8_0_matmul", x, (qs, d), qs.shape[0],
                      out_dtype, vector_planes=(0,),
                      plan_parts=plan_parts)


matmul_q8_0.launches = 0
