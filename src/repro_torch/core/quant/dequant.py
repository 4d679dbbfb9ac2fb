"""Reference dequantization (plain torch) — the oracle the kernels test against.

The port of ``repro.core.quant.dequant``: each function is the semantic
definition of its format, and a kernel's matmul must match
``x @ dequantize(planes).T``.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant.pack import Planes, cvt53_approx_scales, unpack_bits


def dequantize_fp16(planes: Planes) -> torch.Tensor:
    return planes["w"].to(torch.float32)


def dequantize_q8_0(planes: Planes, dtype=torch.float32) -> torch.Tensor:
    """float(code) * float(scale) in f32, stored as ``dtype`` (one pass:
    the products are rounded once on the way out, with no f32 copy)."""
    qs, d = planes["qs"], planes["d"]
    n, k = qs.shape
    out = torch.empty((n, k // 32, 32), dtype=dtype, device=qs.device)
    torch.mul(qs.reshape(n, k // 32, 32), d.to(torch.float32)[..., None],
              out=out)
    return out.reshape(n, k)


def dequantize_q6_k(planes: Planes) -> torch.Tensor:
    ql = unpack_bits(planes["ql"], 4)             # (N, K) in [0, 15]
    qh = unpack_bits(planes["qh"], 2)             # (N, K) in [0, 3]
    q = (ql | (qh << 4)) - 32                     # [-32, 31]
    n, k = q.shape
    sc = planes["sc"].to(torch.float32)           # (N, K/16)
    d = planes["d"].to(torch.float32)             # (N, K/256)
    eff = sc.reshape(n, k // 256, 16) * d[..., None]
    w = q.to(torch.float32).reshape(n, k // 16, 16) * \
        eff.reshape(n, k // 16, 1)
    return w.reshape(n, k)


def dequantize_q3_k(planes: Planes, approx_cvt53: bool = False) -> torch.Tensor:
    ql = unpack_bits(planes["ql"], 2)             # (N, K) in [0, 3]
    qh = unpack_bits(planes["qh"], 1)             # (N, K) in {0, 1}
    q = ql + 4 * qh - 4                           # [-4, 3]
    n, k = q.shape
    sc = planes["sc"]
    if approx_cvt53:
        sc = cvt53_approx_scales(sc)
    us = sc.to(torch.float32) - 32.0              # effective 6-bit scale
    d = planes["d"].to(torch.float32)
    eff = us.reshape(n, k // 256, 16) * d[..., None]
    w = q.to(torch.float32).reshape(n, k // 16, 16) * \
        eff.reshape(n, k // 16, 1)
    return w.reshape(n, k)


DEQUANTIZERS = {
    "fp16": dequantize_fp16,
    "q8_0": dequantize_q8_0,
    "q6_k": dequantize_q6_k,
    "q3_k": dequantize_q3_k,
}


def dequantize_as(planes: Planes, fmt: str, dtype) -> torch.Tensor:
    """``DEQUANTIZERS[fmt](planes)`` rounded once to ``dtype``; q8_0 does
    it in one pass."""
    if fmt == "q8_0":
        return dequantize_q8_0(planes, dtype=dtype)
    return DEQUANTIZERS[fmt](planes).to(dtype)


def dequantize(planes: Planes, fmt: str, **kw) -> torch.Tensor:
    return DEQUANTIZERS[fmt](planes, **kw) if fmt == "q3_k" and kw \
        else DEQUANTIZERS[fmt](planes)
