"""The device trace of a sub-window of the measured window.

``torch.profiler`` (CUPTI on the card) records the steps of the last
seconds of the window, started and stopped at step boundaries by the
harness. ``Trace`` reads from it: the device operations (kernels,
copies, fills) and their intervals, the host's launch calls, and the
host's ops and spans (the harness's ``step.model`` around each model
call among them). Busy time is the union of the device operations'
intervals, never a sum, so kernels that overlap count once.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
            "cudaGraphLaunch", "cuGraphLaunch")
# The harness's spans; the profiler also lists each on the device's
# track, where it is no device operation.
SPANS = ("step.model",)
# Gaps shorter than this are summed as one entry of the breakdown.
SHORT_GAP_NS = 20_000


@dataclasses.dataclass
class Op:
    name: str
    start: int
    end: int


def _kind(e) -> Optional[str]:
    """"device" (a kernel, copy or fill on the card), "runtime" (a CUDA
    runtime or driver call on the host), "host" (an op or a span), or
    None (the device-side copies of the harness's spans), told apart by
    the event's device type and its name."""
    if str(e.device_type()).endswith("CUDA"):
        return None if e.name() in SPANS else "device"
    name = e.name()
    if name.startswith(("cuda", "cu")) and not name.startswith("cuda::"):
        return "runtime"
    return "host"


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class Trace:
    """What one profiled sub-window holds (times in ns, the profiler's
    clock)."""

    def __init__(self, events):
        self.ops: List[Op] = []
        self.launches = 0
        self.host: List[Tuple[int, int, str]] = []
        lo, hi = None, None
        for e in events:
            kind = _kind(e)
            if kind is None:
                continue
            name = e.name()
            start = int(e.start_ns())
            end = start + int(e.duration_ns())
            if kind == "device":
                self.ops.append(Op(name, start, end))
            else:
                if kind == "runtime" and name in LAUNCHES:
                    self.launches += 1
                self.host.append((start, end, name))
            lo = start if lo is None else min(lo, start)
            hi = end if hi is None else max(hi, end)
        self.t0, self.t1 = lo or 0, hi or 0
        self.host.sort()
        self._busy = _union([(o.start, o.end) for o in self.ops])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._busy) / 1e9

    def device_s(self, match) -> float:
        """Seconds of the device operations whose name ``match`` accepts
        (summed: the kernels of one class run one after another)."""
        return sum(o.end - o.start for o in self.ops if match(o.name)) / 1e9

    def top_ops(self, n: int = 10) -> List[List]:
        """The n device operations (by name) that took most time."""
        by: Dict[str, int] = {}
        for o in self.ops:
            by[o.name] = by.get(o.name, 0) + o.end - o.start
        top = sorted(by.items(), key=lambda kv: kv[1], reverse=True)[:n]
        return [[name[:200], ns / 1e9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """Idle device time by what the host was doing when it began: the
        innermost host event (op, span or runtime call) around the middle
        of each gap of at least 20 us; shorter gaps as one entry. The n
        largest totals."""
        by: Dict[str, int] = {}
        starts = [h[0] for h in self.host]
        edges = [self.t0] + [x for iv in self._busy for x in iv] + [self.t1]
        for i in range(0, len(edges) - 1, 2):
            g0, g1 = edges[i], edges[i + 1]
            if g1 <= g0:
                continue
            if g1 - g0 < SHORT_GAP_NS:
                label = "gaps under 20 us"
            else:
                label = self._host_at((g0 + g1) // 2, starts)
            by[label] = by.get(label, 0) + g1 - g0
        top = sorted(by.items(), key=lambda kv: kv[1], reverse=True)[:n]
        return [[name[:200], ns / 1e9] for name, ns in top]

    def _host_at(self, t: int, starts: List[int]) -> str:
        best = None
        j = bisect.bisect_right(starts, t)
        for k in range(j - 1, max(-1, j - 4000), -1):
            s, e, name = self.host[k]
            if e >= t and (best is None or e - s < best[0]):
                best = (e - s, name)
        return f"host in {best[1]}" if best else "host between model calls"
