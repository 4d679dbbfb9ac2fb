"""Q3_K fused dequant-matmul: wrapper of ``csrc/q3_k_matmul.cu``.

The port of ``repro.kernels.q3_k_matmul.matmul_q3_k`` in both its forms
(paper Fig. 9: 2+1-bit quants, 6-bit scales stored as ``us`` in [32, 63]
and applied as ``us - 32``, an fp16 super-scale per 256; one shared f32
MAC back-end): exact (``approx_cvt53=False``, what every serving path
uses), and the paper's CVT53 approximation (``approx_cvt53=True``: each
scale's low bit dropped, ``sc & ~1``, before ``- 32``; the C entry point
``q3_k_matmul_approx``).
On a CPU tensor the wrapper computes the plain version
(``ref.matmul_ref``); on a CUDA tensor it launches the hand-written
kernel or raises.

Planes: {"ql": int32 (N, K/16), "qh": int32 (N, K/32),
         "sc": int8 (N, K/16), "d": float16 (N, K/256)}; K % 256 == 0.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _dequant_matmul as _dm
from repro_torch.kernels.ref import matmul_ref

LAYOUT = {"ql": (16, torch.int32), "qh": (32, torch.int32),
          "sc": (16, torch.int8), "d": (256, torch.float16)}


def matmul_q3_k(x: torch.Tensor, ql: torch.Tensor, qh: torch.Tensor,
                sc: torch.Tensor, d: torch.Tensor, *,
                out_dtype=torch.float32,
                approx_cvt53: bool = False) -> torch.Tensor:
    """x: (M, K) f32|bf16 and the q3_k planes of an (N, K) weight.
    Returns (M, N) in ``out_dtype`` (f32, or bf16 rounded from the f32
    result)."""
    planes = {"ql": ql, "qh": qh, "sc": sc, "d": d}
    _dm.check("matmul_q3_k", x, planes, LAYOUT, 256, out_dtype)
    if x.device.type == "cpu":
        return matmul_ref(x, planes, "q3_k",
                          approx_cvt53=approx_cvt53).to(out_dtype)
    return _dm.launch(matmul_q3_k, "q3_k_matmul", x, (ql, qh, sc, d),
                      ql.shape[0], out_dtype,
                      entry="q3_k_matmul_approx" if approx_cvt53 else None)


matmul_q3_k.launches = 0
