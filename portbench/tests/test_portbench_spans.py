"""The readers of the engine's own spans and phase counters
(``core/spans.py``): the idle split over hand-made trace events, the
counter means over a hand-made schedule, and the tiny CPU cell."""
import sys
import time
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench.core import bench, spans  # noqa: E402
from portbench.core.schedule import Schedule  # noqa: E402
from portbench.core.trace import Trace  # noqa: E402
from portbench.tests.test_portbench_metrics import _Event  # noqa: E402

SEED = 2 ** 31 + 91
IDLE = ("idle_outside_model_pct", "idle_in_model_pct")
COUNTED = ("host_between_steps_ms", "model_call_ms")


def read(name, c):
    return bench.metric_reader(name)(c)


def step_trace(engine=True):
    """One step over 1,200 us: idle 0-100 (upload), 300-350 (model),
    500-700 (100 in the model call, 100 in the commit) and 1,050-1,150
    (under no engine span)."""
    host = [_Event("engine.step", 0, 1000), _Event("engine.upload", 0, 200),
            _Event("engine.model", 200, 600),
            _Event("engine.commit", 600, 1000)] if engine else []
    return Trace(host + [
        _Event("aten::mm", 1000, 1100),
        _Event("cudaLaunchKernel", 90, 95),
        _Event("dequant_matmul_kernel", 100, 300, cuda=True),
        _Event("paged_attn_kernel", 350, 500, cuda=True),
        _Event("Memcpy DtoH", 700, 1050, cuda=True),
        _Event("elementwise_kernel", 1150, 1200, cuda=True),
    ])


def trace_ctx(trace):
    return bench.Ctx({}, None, 2, 4, (0.0, 1.0), Schedule([], {}), [], 1.0,
                     trace=trace, trace_steps=(0, 1))


def test_idle_split_by_interval_intersection():
    t = step_trace()
    assert spans.idle(t) == [(0, 100_000), (300_000, 350_000),
                             (500_000, 700_000), (1_050_000, 1_150_000)]
    assert spans.idle_split(t) == (200_000, 150_000)
    c = trace_ctx(t)
    assert read("idle_outside_model_pct", c) == pytest.approx(100 * 200 / 1200)
    assert read("idle_in_model_pct", c) == pytest.approx(100 * 150 / 1200)
    # The gap under no span is the rest of the device's idle time.
    assert read("device_idle_pct", c) == pytest.approx(100 * 450 / 1200)
    assert read("device_idle_pct", c) - sum(read(n, c) for n in IDLE) \
        == pytest.approx(100 * 100 / 1200)


def test_idle_split_reads_nothing_without_engine_spans():
    c = trace_ctx(step_trace(engine=False))
    assert read("device_idle_pct", c) is not None
    for name in IDLE:
        assert read(name, c) is None
    for name in IDLE:
        assert read(name, trace_ctx(None)) is None


def test_overlap_of_disjoint_interval_lists():
    a = [(0, 10), (20, 30), (40, 50)]
    assert spans.overlap_ns(a, [(5, 25), (28, 45)]) == 5 + 5 + 2 + 5
    assert spans.overlap_ns(a, []) == 0
    assert spans.overlap_ns(a, [(0, 100)]) == 30


def ev(step, t1, **counters):
    return types.SimpleNamespace(step=step, t_start=t1 - 0.1, t_end=t1,
                                 occupancy=1, counters=counters,
                                 slots=[(0, 0, "decode", 1, 1)])


def phases(model, between):
    """Phase counters of one step: ``between`` spread over the five
    between-step phases."""
    return dict(dict.fromkeys(spans.BETWEEN_STEPS, between / 5),
                model_call_s=model, sample_s=0.001, readback_s=0.02)


def test_counter_means_leave_out_the_traced_steps():
    """Steps 1 and 2 are traced; step 4 ends after the window."""
    events = [ev(0, 0.1, **phases(0.010, 0.004)),
              ev(1, 0.2, **phases(0.090, 0.040)),
              ev(2, 0.3, **phases(0.090, 0.040)),
              ev(3, 0.4, **phases(0.012, 0.006)),
              ev(4, 1.5, **phases(0.500, 0.500))]
    c = bench.Ctx({}, None, 1, 1, (0.0, 1.0), Schedule(events, {0: 4}), [],
                  1.0, trace=object(), trace_steps=(1, 3))
    assert [s.index for s in spans.untraced_window_steps(c)] == [0, 3]
    assert read("model_call_ms", c) == pytest.approx(11.0)
    assert read("host_between_steps_ms", c) == pytest.approx(5.0)
    # Without a trace every step of the window counts.
    c.trace, c.trace_steps = None, ()
    assert read("model_call_ms", c) == pytest.approx(1e3 * 0.202 / 4)
    # A program without the counters: nothing to read.
    c.schedule = Schedule([ev(0, 0.1, steps=1.0)], {0: 4})
    for name in COUNTED:
        assert read(name, c) is None


def test_tiny_cell_reports_the_phase_counters():
    """The tiny CPU cell, traced: the counters read, the idle split does
    not (no profiler on the CPU, so no device trace)."""
    pytest.importorskip("torch")
    from portbench.tests import tiny
    out = bench.run_cell("tiny", SEED, 1.0, True, time.time(),
                         device="cpu", bench=tiny.bench(),
                         resolved=tiny.cell("short"))
    assert out["correct"] is True
    for name in COUNTED:
        assert out["metrics"][name]["value"] > 0, name
        assert out["metrics"][name]["unit"] == "ms"
    for name in IDLE + ("device_idle_pct",):
        assert name not in out["metrics"]
