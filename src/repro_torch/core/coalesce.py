"""DMA transaction-cost model (paper §III.D), copied from ``repro``.

Only the ``TransferModel`` dataclass is carried over: the transfer
ledger's ``summary_lines`` reads modeled LOAD/DRAIN seconds from it. The
plane-coalescing layout transform waits for ROADMAP A18.
"""
from __future__ import annotations

import dataclasses
from typing import List


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
