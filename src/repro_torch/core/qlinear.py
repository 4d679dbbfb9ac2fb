"""QuantizedLinear — the composable offloadable unit (paper Fig. 4, pink),
ported from ``repro.core.qlinear``.

A linear layer whose weights live in one of the paper's four formats. The
parameter tree holds the *packed planes*, so the quantized representation
is carried end to end (what makes the decode memory-roofline term drop
by the format's compression ratio — the paper's central efficiency
mechanism).

There is no ``impl`` switch: a quantized format goes through
``kernels.ops.quantized_matmul``, which on a CUDA tensor launches the
format's hand-written kernel (B2/B4/B5/B6) and on a CPU tensor computes
its plain version; ``fmt="none"`` (bf16 weights) is a dense product of
x-dtype operands accumulated in f32, as the JAX package's ``jnp.dot``
with ``preferred_element_type=float32``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.quant import pack
from repro_torch.core.quant.formats import FORMATS, kquant_pad
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class QLinearSpec:
    """Static description of one quantized linear layer."""

    name: str
    in_features: int
    out_features: int
    fmt: str                   # fp16 | q8_0 | q6_k | q3_k | none(bf16)

    @property
    def weight_bytes(self) -> float:
        if self.fmt == "none":
            return self.in_features * self.out_features * 2
        return self.out_features * kquant_pad(
            self.in_features, self.fmt) * FORMATS[self.fmt].physical_bpw / 8


def init_qlinear(gen: torch.Generator, spec: QLinearSpec,
                 scale: float = 0.02):
    """Initialize (quantized) parameters for the layer."""
    w = torch.randn((spec.out_features, spec.in_features), generator=gen,
                    device=gen.device, dtype=torch.float32) * scale
    return quantize_weight(w, spec.fmt)


def quantize_weight(w: torch.Tensor, fmt: str):
    """(out, in) float weight -> plane dict (or bf16 passthrough)."""
    if fmt == "none":
        return {"w": w.to(torch.bfloat16)}
    return dict(pack.quantize(w, fmt))


def apply_qlinear(params, x: torch.Tensor, fmt: str, *,
                  bias: Optional[torch.Tensor] = None,
                  out_dtype=None) -> torch.Tensor:
    """y = x @ W^T (+ bias), in f32, then ``out_dtype`` (x's by default).
    x: (..., in_features)."""
    out_dtype = out_dtype or x.dtype
    if fmt == "none":
        w = params["w"].to(x.dtype).to(torch.float32)
        y = x.to(torch.float32) @ w.T
    else:
        y = ops.quantized_matmul(x, params, fmt, out_dtype=torch.float32)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y.to(out_dtype)
