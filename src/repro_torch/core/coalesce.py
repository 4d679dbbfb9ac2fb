"""Transfer coalescing (paper §III.D), ported from ``repro.core.coalesce``.

The paper's optimization: instead of one DMA transaction per input tensor
(activations, packed weights, sub-scales, super-scales — 4 planes for the
quantized kernels), aggregate them into a single contiguous block and
issue ONE burst transfer; same on the result drain.

* ``coalesce_planes`` / ``split_planes`` — the layout transform itself
  (byte-exact aggregation into one contiguous uint8 buffer and its
  recovery), on tensors of any device, with the JAX package's manifest
  (name, offset, nbytes, numpy dtype name, shape);
* ``TransferModel`` — the transaction-cost model that the transfer
  ledger's ``summary_lines`` reads modeled LOAD/DRAIN seconds from.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

# torch dtype <-> the numpy dtype name the JAX package's manifest records.
_NAMES = {torch.int8: "int8", torch.uint8: "uint8", torch.int16: "int16",
          torch.int32: "int32", torch.int64: "int64",
          torch.float16: "float16", torch.float32: "float32",
          torch.float64: "float64", torch.bfloat16: "bfloat16",
          torch.bool: "bool"}
_DTYPES = {v: k for k, v in _NAMES.items()}


# ----------------------------------------------------------------------
# Byte-exact plane aggregation (the layout transform)
# ----------------------------------------------------------------------
def coalesce_planes(planes: Dict[str, torch.Tensor],
                    align: int = 64) -> Tuple[torch.Tensor, List[Dict]]:
    """Aggregate a plane dict into one contiguous uint8 buffer (+manifest).

    Each plane is aligned to ``align`` bytes (DMA burst alignment), the
    paper's single-burst-transfer requirement on the shared address
    space; the gaps are zero."""
    manifest: List[Dict] = []
    chunks: List[torch.Tensor] = []
    offset = 0
    device = None
    for name in sorted(planes):
        t = planes[name].contiguous()
        device = t.device
        raw = t.reshape(-1).view(torch.uint8)
        pad = (-offset) % align
        if pad:
            chunks.append(torch.zeros(pad, dtype=torch.uint8, device=device))
            offset += pad
        manifest.append({
            "name": name,
            "offset": offset,
            "nbytes": raw.numel(),
            "dtype": _NAMES[t.dtype],
            "shape": tuple(t.shape),
        })
        chunks.append(raw)
        offset += raw.numel()
    buf = torch.cat(chunks) if chunks else torch.zeros(0, dtype=torch.uint8)
    return buf, manifest


def split_planes(buf: torch.Tensor,
                 manifest: List[Dict]) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`coalesce_planes` (byte-exact): each plane a
    copy of its bytes, viewed as its dtype and shape."""
    out: Dict[str, torch.Tensor] = {}
    for ent in manifest:
        sub = buf[ent["offset"]:ent["offset"] + ent["nbytes"]].clone()
        out[ent["name"]] = sub.view(_DTYPES[ent["dtype"]]).reshape(
            ent["shape"])
    return out


# ----------------------------------------------------------------------
# Transaction-cost model
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TransferModel:
    """DMA cost = setup overhead per transaction + bytes / bandwidth.

    Defaults calibrated so the naive->coalesced speedups reproduce the
    paper's preliminary evaluation (LOAD 1.2x, DRAIN 4.8x): LOAD moves large
    payloads (setup amortized -> 1.2x), DRAIN moves a small result (setup
    dominates -> 4.8x).
    """

    bandwidth_Bps: float = 3.2e9        # Versal NoC DMA effective bandwidth
    setup_s: float = 6.0e-6             # per-transaction setup (descriptor+IRQ)

    def time(self, nbytes: float, transactions: int) -> float:
        return transactions * self.setup_s + nbytes / self.bandwidth_Bps

    def load_time(self, plane_bytes: List[float], coalesced: bool) -> float:
        total = float(sum(plane_bytes))
        tx = 1 if coalesced else len(plane_bytes)
        return self.time(total, tx)

    def drain_time(self, result_bytes: float, coalesced: bool,
                   result_pieces: int = 8) -> float:
        """Results are written back per lane-segment when not coalesced."""
        tx = 1 if coalesced else result_pieces
        return self.time(result_bytes, tx)
