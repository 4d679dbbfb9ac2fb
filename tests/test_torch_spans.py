"""The port's engine spans and phase counters (``runtime/engine.py``
``_Spans``, ``runtime/telemetry.py`` ``Span``/``TIMING_COUNTERS``).

On the reduced CPU serve of tests/test_torch_serving.py with telemetry
on: every step event carries the eight phase counters, none negative,
summing to no more than the step's ``engine.step`` span; the phases lie
inside their step in the serve loop's order, and a step's commit ends
before the next step's reservation starts. Under a CPU
``torch.profiler``, every span is a plain host op (not a user
annotation, which the profiler would copy onto the device's track), on
the profiler's clock: its start, converted through the meta's
``t0_unix_ns``, lands where the timeline's copy says. The tokens are the
same with the profiler on and off.
"""
import collections
import statistics

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.convert import quantize_params  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.runtime.engine import ServingEngine  # noqa: E402
from repro_torch.runtime.telemetry import TIMING_COUNTERS  # noqa: E402
from test_torch_serving import ARGS, ENGINE  # noqa: E402

ORDER = ("engine.reserve", "engine.admit", "engine.plan", "engine.upload",
         "engine.model", "engine.sample", "engine.readback",
         "engine.commit")


def serve(profile: bool):
    """The reduced serve (q8_0, fp32 pages, preempting) with telemetry
    on; with ``profile``, under a CPU profiler. Returns (report, the
    profiler's events or None)."""
    cfg = get_config("qwen3-0.6b").reduced()
    model = build_model(cfg)
    params = quantize_params(model.init(torch.Generator().manual_seed(0)),
                             "q8_0")
    eng = ServingEngine(model, params, quant="q8_0", telemetry=True,
                        cache_dtype=torch.float32, device="cpu", **ENGINE)
    reqs = tserve.build_stream(cfg, ARGS, np.random.RandomState(0))
    if not profile:
        return eng.serve(reqs, seed=0, realtime=False), None
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        rep = eng.serve(reqs, seed=0, realtime=False)
    finally:
        prof.stop()
    return rep, prof.profiler.kineto_results.events()


@pytest.fixture(scope="module")
def plain():
    return serve(False)[0]


@pytest.fixture(scope="module")
def profiled():
    return serve(True)


def step_spans(tl):
    return {sp.step: sp for sp in tl.spans if sp.name == "engine.step"}


def test_every_step_carries_its_phase_seconds(plain):
    tl = plain.timeline
    steps = step_spans(tl)
    assert plain.sched.preemptions > 0
    assert len(steps) == plain.stats.steps == len(tl.events) > 0
    for ev in tl.events:
        phases = [ev.counters[k] for k in TIMING_COUNTERS]
        assert min(phases) >= 0, ev.step
        assert ev.counters["model_call_s"] > 0, ev.step
        sp = steps[ev.step]
        # 1 ns: the counters are float sums of the spans' ns.
        assert sum(phases) <= (sp.t_end_ns - sp.t_start_ns + 1) / 1e9
    # The timeline's diffs add back to the engine's totals.
    totals = {k: sum(ev.counters[k] for ev in tl.events)
              for k in TIMING_COUNTERS}
    inside = collections.Counter()
    for sp in tl.spans:
        if sp.parent == "engine.step":
            inside[sp.name] += (sp.t_end_ns - sp.t_start_ns) / 1e9
    for name, key in zip(ORDER, TIMING_COUNTERS):
        assert totals[key] == pytest.approx(inside[name], rel=1e-9,
                                            abs=1e-12)


def test_phases_lie_inside_their_step_in_order(plain):
    tl = plain.timeline
    steps = step_spans(tl)
    kids = collections.defaultdict(list)
    for sp in tl.spans:
        if sp.parent == "engine.step":
            kids[sp.step].append(sp)
    for k, st in steps.items():
        names = [sp.name for sp in kids[k]]
        assert names == [n for n in ORDER if n in names], k
        assert names[-6:] == list(ORDER[2:]), k
        last = st.t_start_ns
        for sp in kids[k]:
            assert last <= sp.t_start_ns <= sp.t_end_ns <= st.t_end_ns, k
            last = sp.t_end_ns
    commits = {sp.step: sp for sp in tl.spans if sp.name == "engine.commit"}
    reserves = collections.defaultdict(list)
    for sp in tl.spans:
        if sp.name == "engine.reserve":
            reserves[sp.step].append(sp)
    for k in range(1, len(steps)):
        assert commits[k - 1].t_end_ns <= steps[k - 1].t_end_ns \
            <= reserves[k][0].t_start_ns, k
    # Every request's admission, with its rid, in an engine.admit span.
    rids = [r for sp in tl.spans if sp.name == "engine.admit"
            for r in sp.rids]
    assert len(rids) == plain.sched.admitted
    assert sorted(set(rids)) == list(range(ARGS.requests))
    assert "t0_unix_ns" in tl.meta


def test_spans_are_host_ops_on_the_profilers_clock(profiled):
    rep, events = profiled
    tl = rep.timeline
    ours = [e for e in events if e.name().startswith("engine.")]
    assert ours and not any(e.is_user_annotation() for e in ours)
    assert collections.Counter(e.name() for e in ours) \
        == collections.Counter(sp.name for sp in tl.spans)
    t0 = tl.meta["t0_unix_ns"]
    gaps = []
    for name in set(sp.name for sp in tl.spans):
        prof = sorted(e.start_ns() for e in ours if e.name() == name)
        mine = sorted(t0 + sp.t_start_ns for sp in tl.spans
                      if sp.name == name)
        gaps += [abs(a - b) for a, b in zip(prof, mine)]
    assert statistics.median(gaps) <= 50_000
    assert max(gaps) <= 1_000_000


def test_tokens_equal_with_the_profiler_on_and_off(plain, profiled):
    assert [s.generated for s in profiled[0].sequences] == \
        [s.generated for s in plain.sequences]
    assert profiled[0].ledger.breakdown() == plain.ledger.breakdown()
