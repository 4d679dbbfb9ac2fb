"""Quantization format descriptors (paper §III.B/§III.C).

The four formats the paper maps onto IMAX, with both the GGML-faithful
*logical* bits-per-weight and the *physical* bpw of our TPU struct-of-planes
layout (bit-identical information content; only the container differs —
TPU lanes want int32 words and separate scale planes, the CGLA wanted
interleaved per-block structs).

``kernel_units`` and ``power_w_28nm`` come straight from the paper
(§III.C kernel descriptions and §IV.A synthesis results) and drive the
IMAX analytical model used by the benchmark suite.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class QuantFormat:
    name: str
    sub_block: int          # elements sharing one (sub-)scale
    super_block: int        # elements sharing one fp16 super-scale
    logical_bpw: float      # GGML on-disk bits per weight
    physical_bpw: float     # our TPU plane layout bits per weight
    kernel_units: int       # IMAX arithmetic units used (paper §III.C)
    power_w_28nm: float     # 28nm ASIC power for this kernel (paper Table 1)
    elems_per_burst: int    # elements processed per operational burst (paper)

    @property
    def bytes_per_weight(self) -> float:
        return self.physical_bpw / 8.0


FORMATS: Dict[str, QuantFormat] = {
    # FP16: LUT-upconvert front-end, 22 units, 16 elems/burst (Fig. 6).
    "fp16": QuantFormat("fp16", 1, 1, 16.0, 16.0, 22, 2.16, 16),
    # Q8_0: blocks of 32, fp16 scale; SML8+AD24 pipeline, 46 units,
    # 2x4-parallel dataflows x 32-elem segment (Fig. 5/7).
    "q8_0": QuantFormat("q8_0", 32, 32, 8.5, 8.5, 46, 4.41, 32),
    # Q6_K: super-block 256 = 16 sub-blocks of 16; 4+2-bit quants, int8
    # sub-scales, fp16 super-scale; CVT86+SML16, 64 units (Fig. 8).
    "q6_k": QuantFormat("q6_k", 16, 256, 6.5625, 6.5625, 64, 6.10, 256),
    # Q3_K: super-block 256; 2+1-bit quants, 6-bit scales (CVT53 approximates
    # to 5-bit), fp16 super-scale; 51 units, 256 elems/burst (Fig. 9).
    # Physical layout stores the 6-bit scales in int8 lanes -> 3.5625 bpw.
    "q3_k": QuantFormat("q3_k", 16, 256, 3.4375, 3.5625, 51, 4.88, 256),
}

# Model-level quantization recipes, mirroring llama.cpp model files the paper
# evaluates (§III.B): large linear layers low-bit, norms always FP16,
# Q3_K_S additionally keeps embedding/output in Q6_K.
RECIPES: Dict[str, Dict[str, str]] = {
    "fp16":   {"linear": "fp16", "embed": "fp16", "norm": "fp16"},
    "q8_0":   {"linear": "q8_0", "embed": "q8_0", "norm": "fp16"},
    "q3_k_s": {"linear": "q3_k", "embed": "q6_k", "norm": "fp16"},
    "q6_k":   {"linear": "q6_k", "embed": "q6_k", "norm": "fp16"},
}


def kquant_pad(k: int, fmt: str) -> int:
    """Round K up to the format's super-block multiple (GGML requires
    K % 256 == 0 for K-quants; we zero-pad instead of falling back)."""
    sb = FORMATS[fmt].super_block
    return (k + sb - 1) // sb * sb
