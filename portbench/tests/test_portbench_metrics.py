"""Percentiles, rates and tails over a synthetic list of step events,
read by the benchmark's own metric readers."""
import sys
import types
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT)]

from portbench.core import bench  # noqa: E402
from portbench.core.schedule import Schedule, percentile  # noqa: E402


def ev(step, t0, t1, occ, slots, **counters):
    return types.SimpleNamespace(step=step, t_start=t0, t_end=t1,
                                 occupancy=occ, counters=counters,
                                 slots=slots)


def events():
    """Two requests on 2 slots, chunk 4: rid 0 (prompt 6) prefills in two
    steps and decodes 3 tokens; rid 1 (prompt 8, 4 of them from the
    prefix cache) prefills once and decodes 2."""
    return [
        ev(0, 0.00, 0.10, 2, [(0, 0, "prefill", 4, 0),
                              (1, 1, "prefill", 4, 1)]),
        ev(1, 0.10, 0.20, 2, [(0, 0, "prefill", 2, 1),
                              (1, 1, "decode", 1, 1)]),
        ev(2, 0.20, 0.35, 2, [(0, 0, "decode", 1, 1),
                              (1, 1, "decode", 1, 1)]),
        ev(3, 0.35, 0.50, 1, [(0, 0, "decode", 1, 1)]),
        ev(4, 0.50, 0.50, 0, []),
    ]


def seq(rid, plen, arrival, admitted, first):
    req = types.SimpleNamespace(arrival_s=arrival, prompt_len=plen)
    return types.SimpleNamespace(rid=rid, req=req, t_admitted=admitted,
                                 t_first_token=first)


def ctx(window=(0.0, 1.0)):
    sched = Schedule(events(), {0: 6, 1: 8})
    seqs = [seq(0, 6, 0.0, 0.01, 0.20), seq(1, 8, 0.05, 0.05, 0.10)]
    return bench.Ctx({}, None, 2, 4, window, sched, seqs, 12.5)


def read(name, c):
    return bench.metric_reader(name)(c)


def test_schedule_positions_rows_and_hits():
    s = Schedule(events(), {0: 6, 1: 8})
    assert s.hit == {0: 0, 1: 4}
    assert [f.pos0 for f in s.steps[2].feeds] == [6, 9]
    assert s.token_times[0] == [0.20, 0.35, 0.50]
    assert s.token_times[1] == [0.10, 0.20, 0.35]


def test_rates_and_tails_over_a_window():
    c = ctx((0.0, 1.0))
    assert read("output_tok_s", c) == pytest.approx(6 / 1.0)
    gaps = np.array([0.15, 0.15, 0.10, 0.15]) * 1e3
    assert read("itl_p95_ms", c) == pytest.approx(np.percentile(gaps, 95))
    assert read("ttft_p95_ms", c) == pytest.approx(
        np.percentile([200.0, 50.0], 95))
    assert read("step_ms.overload", c) == pytest.approx(1e3 / 4)
    assert read("occupancy_mean", c) == pytest.approx(7 / 4)
    assert read("queue_wait_p50_ms", c) == pytest.approx(5.0)
    assert read("prefix_hit_pct", c) == pytest.approx(100 * 4 / 14)
    assert read("setup_s", c) == 12.5
    # A window that leaves out the first two steps.
    c = ctx((0.2, 0.5))
    assert read("output_tok_s", c) == pytest.approx(3 / 0.3)
    assert read("itl_p95_ms", c) == pytest.approx(150.0)
    # No trace: the device readers have nothing to read.
    for name in ("device_idle_pct", "step_mfu", "launches_per_step",
                 "matmul_q8_0_roofline", "paged_attn_roofline"):
        assert read(name, c) is None


def test_percentile_is_numpy_linear():
    v = [5.0, 1.0, 4.0, 2.0, 3.0]
    assert percentile(v, 50) == 3.0
    assert percentile(v, 95) == pytest.approx(4.8)


class _Event:
    """A profiler event as ``Trace`` reads it (times in us here)."""

    def __init__(self, name, start_us, end_us, cuda=False):
        self._name, self._cuda = name, cuda
        self._start, self._dur = start_us * 1000, (end_us - start_us) * 1000

    def name(self):
        return self._name

    def device_type(self):
        return "DeviceType.CUDA" if self._cuda else "DeviceType.CPU"

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur


def test_trace_over_synthetic_events():
    """Overlapping kernels count once; launches are the host's launch
    calls; the device copy of the harness's span is no device operation;
    idle gaps are named by the innermost host event around them."""
    from portbench.core.trace import Trace
    t = Trace([
        _Event("step.model", 0, 500),
        _Event("step.model", 0, 500, cuda=True),
        _Event("cudaLaunchKernel", 1, 2),
        _Event("cudaLaunchKernel", 3, 4),
        _Event("cudaLaunchKernel", 250, 251),
        _Event("cudaStreamSynchronize", 160, 290),
        _Event("aten::mm", 1, 5),
        _Event("dequant_matmul_kernel", 0, 100, cuda=True),
        _Event("paged_attn_kernel", 50, 150, cuda=True),
        _Event("Memcpy DtoH", 300, 380, cuda=True),
    ])
    assert t.window_s == pytest.approx(500e-6)
    assert t.busy_s == pytest.approx(230e-6)            # 0-150 and 300-380
    assert t.launches == 3
    assert t.device_s(lambda n: "dequant_matmul" in n) \
        == pytest.approx(100e-6)
    assert t.device_s(lambda n: "paged_" in n) == pytest.approx(100e-6)
    assert [n for n, _ in t.top_ops()] == [
        "dequant_matmul_kernel", "paged_attn_kernel", "Memcpy DtoH"]
    gaps = dict(t.idle_gaps())
    assert gaps == pytest.approx({"host in cudaStreamSynchronize": 150e-6,
                                  "host in step.model": 120e-6})
