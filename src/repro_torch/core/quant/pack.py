"""Quantize + bit-pack weights into struct-of-planes layouts (plain torch).

The port of ``repro.core.quant.pack``: the same four plane formats, bit
for bit, so the kernels of both packages consume identical bytes.

Layouts (weights are (N, K): each output row quantized along K, exactly like
GGML rows; K is zero-padded to the super-block multiple first):

  fp16:  {"w":  f16 (N, K)}
  q8_0:  {"qs": i8  (N, K),        "d": f16 (N, K/32)}
  q6_k:  {"ql": i32 (N, K/8),      # 8 x 4-bit low nibbles / word
          "qh": i32 (N, K/16),     # 16 x 2-bit highs / word
          "sc": i8  (N, K/16),     # per-16 sub-scales
          "d":  f16 (N, K/256)}
  q3_k:  {"ql": i32 (N, K/16),     # 16 x 2-bit low / word
          "qh": i32 (N, K/32),     # 32 x 1-bit high / word
          "sc": i8  (N, K/16),     # 6-bit scales in [0, 63] (int8 lanes)
          "d":  f16 (N, K/256)}

Bit-exactness with the JAX quantizers rests on doing the same f32
operations in the same order: the fp16 scale is rounded first, its f32
reciprocal taken, and ``torch.round`` rounds half to even like
``jnp.round``.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.core.quant.formats import FORMATS, kquant_pad

Planes = Dict[str, torch.Tensor]


# ----------------------------------------------------------------------
# Bit packing helpers
# ----------------------------------------------------------------------
def pack_bits(vals: torch.Tensor, nbits: int) -> torch.Tensor:
    """Pack unsigned ``nbits``-wide fields (last axis) into int32 words.

    vals: (..., n) integer tensor with entries in [0, 2**nbits);
    returns (..., n * nbits // 32) int32. The words are assembled in
    int64 (the top field of a word reaches bit 31, which int32 would
    overflow into) and folded into the int32 two's-complement range.
    """
    per = 32 // nbits
    if vals.shape[-1] % per:
        raise ValueError(f"last axis {vals.shape[-1]} is not a multiple of "
                         f"{per} {nbits}-bit fields")
    v = vals.to(torch.int64).reshape(*vals.shape[:-1], -1, per)
    shifts = torch.arange(per, dtype=torch.int64, device=vals.device) * nbits
    words = ((v & ((1 << nbits) - 1)) << shifts).sum(dim=-1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


def unpack_bits(words: torch.Tensor, nbits: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: (..., W) int32 -> (..., W * 32//nbits).

    Torch's ``>>`` on int32 is arithmetic (it copies the sign bit), so the
    mask after the shift is what makes it a field extract."""
    per = 32 // nbits
    shifts = torch.arange(per, dtype=torch.int32, device=words.device) * nbits
    fields = (words[..., None] >> shifts) & ((1 << nbits) - 1)
    return fields.reshape(*words.shape[:-1], -1)


def _pad_k(w: torch.Tensor, mult: int) -> torch.Tensor:
    k = w.shape[-1]
    kp = (k + mult - 1) // mult * mult
    if kp == k:
        return w
    return F.pad(w, (0, kp - k))


def _safe_inv(x: torch.Tensor) -> torch.Tensor:
    """1/x where x != 0, else 0 (in x's dtype)."""
    nz = x != 0
    return torch.where(nz, 1.0 / torch.where(nz, x, torch.ones_like(x)),
                       torch.zeros_like(x))


# ----------------------------------------------------------------------
# Per-format quantizers
# ----------------------------------------------------------------------
def quantize_fp16(w: torch.Tensor) -> Planes:
    return {"w": w.to(torch.float16)}


def quantize_q8_0(w: torch.Tensor) -> Planes:
    """Blocks of 32, d = amax/127, q = round(x/d) in [-127, 127]."""
    w = _pad_k(w.to(torch.float32), 32)
    n, k = w.shape
    blocks = w.reshape(n, k // 32, 32)
    amax = blocks.abs().amax(dim=-1)
    d = amax / 127.0
    d16 = d.to(torch.float16)
    dd = d16.to(torch.float32)                   # quantize scale to fp16 first
    inv = _safe_inv(dd)                          # dd >= 0
    q = torch.clamp(torch.round(blocks * inv[..., None]), -127, 127)
    return {"qs": q.reshape(n, k).to(torch.int8), "d": d16}


def quantize_q6_k(w: torch.Tensor) -> Planes:
    """Super-block 256 / sub-block 16; 6-bit quants with int8 sub-scales."""
    w = _pad_k(w.to(torch.float32), 256)
    n, k = w.shape
    sb = w.reshape(n, k // 256, 16, 16)           # (N, S, sub, elem)
    amax = sb.abs().amax(dim=-1)                   # (N, S, 16)
    s_i = amax / 32.0                              # per-sub-scale target
    smax = s_i.amax(dim=-1)                        # (N, S)
    d = smax / 127.0
    d16 = d.to(torch.float16)
    dd = d16.to(torch.float32)
    inv_d = _safe_inv(dd)
    sc = torch.clamp(torch.round(s_i * inv_d[..., None]), -128, 127)
    eff = dd[..., None] * sc                       # effective sub scale
    inv_eff = _safe_inv(eff)
    q = torch.clamp(torch.round(sb * inv_eff[..., None]), -32, 31)
    qu = (q + 32).to(torch.int32).reshape(n, k)    # [0, 63]
    return {
        "ql": pack_bits(qu & 0xF, 4),              # (N, K/8)
        "qh": pack_bits(qu >> 4, 2),               # (N, K/16)
        "sc": sc.reshape(n, k // 16).to(torch.int8),
        "d": d16,
    }


def quantize_q3_k(w: torch.Tensor) -> Planes:
    """Super-block 256 / sub-block 16; 3-bit quants (2-bit QL + 1-bit QH),
    6-bit scales stored as (us - 32) relative to the fp16 super-scale."""
    w = _pad_k(w.to(torch.float32), 256)
    n, k = w.shape
    sb = w.reshape(n, k // 256, 16, 16)
    amax = sb.abs().amax(dim=-1)                   # (N, S, 16)
    s_i = amax / 4.0                               # q in [-4, 3]
    smax = s_i.amax(dim=-1)
    d = smax / 31.0                                # (us - 32) in [0, 31]
    d16 = d.to(torch.float16)
    dd = d16.to(torch.float32)
    inv_d = _safe_inv(dd)
    us = torch.clamp(torch.round(s_i * inv_d[..., None]), 0, 31) + 32
    eff = dd[..., None] * (us - 32.0)
    inv_eff = _safe_inv(eff)
    q = torch.clamp(torch.round(sb * inv_eff[..., None]), -4, 3)
    qu = (q + 4).to(torch.int32).reshape(n, k)     # [0, 7]
    return {
        "ql": pack_bits(qu & 0x3, 2),              # (N, K/16) 2-bit low
        "qh": pack_bits(qu >> 2, 1),               # (N, K/32) 1-bit high
        "sc": us.reshape(n, k // 16).to(torch.int8),
        "d": d16,
    }


QUANTIZERS = {
    "fp16": quantize_fp16,
    "q8_0": quantize_q8_0,
    "q6_k": quantize_q6_k,
    "q3_k": quantize_q3_k,
}


def quantize(w: torch.Tensor, fmt: str) -> Planes:
    """Quantize a 2D weight (N, K) into the given format's planes."""
    if w.ndim != 2:
        raise ValueError(f"quantize expects a 2-D (N, K) weight, got "
                         f"{tuple(w.shape)}")
    return QUANTIZERS[fmt](w)


def cvt53_approx_scales(sc: torch.Tensor) -> torch.Tensor:
    """OP_CVT53 (paper §III.C): approximate the 6-bit Q3_K scales to 5 bits
    by dropping the LSB. Error <= 1 code out of 63 on the scale only."""
    return (sc.to(torch.int32) & ~1).to(torch.int8)


def planes_nbytes(planes: Planes) -> int:
    """Physical bytes of a plane dict."""
    return int(sum(p.numel() * p.element_size() for p in planes.values()))


def logical_nbytes(n: int, k: int, fmt: str) -> float:
    """GGML-faithful logical bytes for an (N, K) weight in ``fmt``."""
    kp = kquant_pad(k, fmt)
    return n * kp * FORMATS[fmt].logical_bpw / 8.0
