"""The yardstick's arithmetic: the card's peaks and the work of each
kernel class and of the whole step, counted from shapes.

Each input byte is counted read once and each output byte written once,
whatever the kernel reads again; flops are those of the rows given, or,
where the work depends on the data (attention over each slot's
context), those these inputs need. A roofline share
is the least time the card could take for that work, the larger of
flops / peak and bytes / bandwidth, over the measured device time.

Peaks: one NVIDIA H100 SXM (80 GB HBM3) at its 700 W limit, NVIDIA's
data sheet, dense: 989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s HBM.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
Q8_0_BYTES = 34.0 / 32.0        # int8 code + one fp16 scale per 32
BF16, F32 = 2, 4


@dataclasses.dataclass
class Work:
    flops: float = 0.0
    nbytes: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.flops + other.flops, self.nbytes + other.nbytes)

    def scaled(self, k: float) -> "Work":
        return Work(self.flops * k, self.nbytes * k)

    @property
    def bound_s(self) -> float:
        """The least time the card could take for this work."""
        return max(self.flops / PEAK_BF16_FLOPS,
                   self.nbytes / PEAK_HBM_BYTES)


def q8_0_matmul(m: int, n: int, k: int) -> Work:
    """y (m, n) bf16 = x (m, k) bf16 . W (n, k) q8_0."""
    return Work(2.0 * m * n * k,
                n * k * Q8_0_BYTES + m * k * BF16 + m * n * BF16)


def gqa_attention(feeds: List[Tuple[int, int]], heads: int, kv_heads: int,
                  head_dim: int) -> Work:
    """Paged GQA over bf16 pages for one layer; ``feeds`` (pos0, n) of
    each slot that fed n rows from position pos0: the slot's K and V up
    to pos0 + n read once, q read and the output written (bf16); two
    products of head_dim per query head and attended position."""
    w = Work()
    for pos0, n in feeds:
        ctx = pos0 + n
        attended = n * pos0 + n * (n + 1) / 2
        w = w + Work(4.0 * heads * head_dim * attended,
                     2 * ctx * kv_heads * head_dim * BF16
                     + 2 * n * heads * head_dim * BF16)
    return w
