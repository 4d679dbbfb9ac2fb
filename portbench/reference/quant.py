"""Block quantization as llama.cpp defines it, in plain PyTorch.

The reference quantizes the benchmark's seed-made bf16 weights itself and
works on the dequantized values in float32; it never reads the program's
planes.

* q8_0 (the configurations' format): blocks of 32 along the input axis,
  d = amax / 127 rounded to fp16, q = round(x / d) in [-127, 127]
  (round half to even), value = q * d.
* q4_0 (the control, the step below q8_0): blocks of 32,
  d = max / -8 where max is the element of largest magnitude with its
  sign, rounded to fp16, q = round(x / d) clamped to [-8, 7], value = q * d.
"""
from __future__ import annotations

import torch

BLOCK = 32


def _blocks(w: torch.Tensor) -> torch.Tensor:
    w = w.to(torch.float32)
    k = w.shape[-1]
    if k % BLOCK:
        raise ValueError(f"input width {k} is not a multiple of {BLOCK}")
    return w.reshape(*w.shape[:-1], k // BLOCK, BLOCK)


def _inverse(d16: torch.Tensor) -> torch.Tensor:
    d = d16.to(torch.float32)
    return torch.where(d != 0, 1.0 / torch.where(d != 0, d, 1.0),
                       torch.zeros_like(d))


def q8_0(w: torch.Tensor) -> torch.Tensor:
    """The float32 values that q8_0 stores for ``w`` (..., K)."""
    b = _blocks(w)
    d16 = (b.abs().amax(dim=-1) / 127.0).to(torch.float16)
    q = torch.clamp(torch.round(b * _inverse(d16)[..., None]), -127, 127)
    return (q * d16.to(torch.float32)[..., None]).reshape(w.shape)


def q4_0(w: torch.Tensor) -> torch.Tensor:
    """The float32 values that q4_0 stores for ``w`` (..., K)."""
    b = _blocks(w)
    idx = b.abs().argmax(dim=-1, keepdim=True)
    signed_max = torch.gather(b, -1, idx)[..., 0]
    d16 = (signed_max / -8.0).to(torch.float16)
    q = torch.clamp(torch.round(b * _inverse(d16)[..., None]), -8, 7)
    return (q * d16.to(torch.float32)[..., None]).reshape(w.shape)


QUANTIZERS = {"q8_0": q8_0, "q4_0": q4_0}


def dequantized(w: torch.Tensor, fmt: str, rows: int = 1 << 14
                ) -> torch.Tensor:
    """``w`` (..., K) stored as ``fmt`` and read back in float32, a block
    of ``rows`` rows at a time (no float32 copy of a whole bank at once
    beyond the result)."""
    fn = QUANTIZERS[fmt]
    flat = w.reshape(-1, w.shape[-1])
    out = torch.empty(flat.shape, dtype=torch.float32, device=w.device)
    for r0 in range(0, flat.shape[0], rows):
        out[r0:r0 + rows] = fn(flat[r0:r0 + rows])
    return out.reshape(w.shape)
