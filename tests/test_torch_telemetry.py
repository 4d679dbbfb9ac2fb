"""Port vs JAX package: per-step serving telemetry (``runtime/telemetry.py``).

* ``LogHistogram``: bins, percentiles, mean, merge and the dict round trip
  equal the JAX class's on the same seeded samples, values below ``lo``
  and at or above ``hi = 1e5`` (the overflow bin) included.
* The ledger tap closes exactly on a synthetic ledger, and is exclusive
  and detachable. Fed the same charges and steps, the port's timeline
  writes the JAX timeline's JSONL and Chrome trace byte for byte, and its
  ``BottleneckReport`` is the JAX one.
* The reduced serve of tests/test_torch_serving.py (fp32 pages, small
  enough to preempt) with telemetry on: the port's and the JAX engine's
  step events agree exactly on count, occupancy, counters, per-slot mix
  and ledger delta, and so do the admitted and preempted request ids; the
  timeline closes against ``ledger.breakdown()``; tokens and the
  allocator trace are the same with telemetry on and off; the exports
  pass the port's validators and the JAX package's.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs.registry import ASSIGNED  # noqa: E402
from repro.runtime import telemetry as jtel  # noqa: E402
from repro.runtime.transfers import TransferLedger as JaxLedger  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.runtime import telemetry as ttel  # noqa: E402
from repro_torch.runtime.engine import ServingEngine  # noqa: E402
from repro_torch.runtime.transfers import TransferLedger  # noqa: E402
from test_torch_serving import (ARGS, ENGINE, _trace,  # noqa: E402
                                serve_both)


def _samples(seed):
    """Seeded samples over 1e-9 .. 1e7: underflow (and exact 0),
    interior bins, and the overflow bin above ``hi = 1e5``."""
    rng = np.random.RandomState(seed)
    vals = 10.0 ** rng.uniform(-9, 7, 300)
    return [0.0, 1e5, 1e6] + [float(v) for v in vals]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_equals_jax(seed):
    vals = _samples(seed)
    th, jh = ttel.LogHistogram(), jtel.LogHistogram()
    for v in vals:
        th.record(v)
        jh.record(v)
    assert th.to_dict() == jh.to_dict()
    assert th.mean == jh.mean
    for q in (1, 10, 50, 90, 99, 100):
        assert th.percentile(q) == jh.percentile(q)
    assert th.percentiles((50, 90, 99)) == jh.percentiles((50, 90, 99))
    assert th.to_dict()["bins"][str(th._nbins - 1)] > 0   # overflow bin
    back = ttel.LogHistogram.from_dict(json.loads(json.dumps(th.to_dict())))
    assert back.to_dict() == jtel.LogHistogram.from_dict(
        json.loads(json.dumps(jh.to_dict()))).to_dict()
    # merge: the same two halves folded in both packages
    ta, tb, ja, jb = (ttel.LogHistogram(), ttel.LogHistogram(),
                      jtel.LogHistogram(), jtel.LogHistogram())
    for i, v in enumerate(vals):
        (ta if i % 2 else tb).record(v)
        (ja if i % 2 else jb).record(v)
    ta.merge(tb)
    ja.merge(jb)
    assert ta.to_dict() == ja.to_dict()
    with pytest.raises(ValueError):
        ta.merge(ttel.LogHistogram(bins_per_decade=8))


def _synthetic(tel, ledger_cls, cfg):
    """One timeline of seeded charges and steps, with a trailing charge
    that lands in ``finalize``'s flush event."""
    led = ledger_cls(cfg, "q8_0")
    tl = tel.StepTimeline(led, meta={"arch": cfg.name, "quant": "q8_0"})
    rng = np.random.RandomState(7)
    t = 0.0
    tl.on_admit(0, 0.0, 0.0)
    tl.on_admit(1, 0.001, 0.001)
    for step in range(6):
        led.charge_step_weights(prefill_frac=0.5)
        led.charge_chunk("prefill", 4, int(rng.randint(4, 40)))
        led.charge_chunk("decode", 1, int(rng.randint(4, 40)))
        led.charge_sampled(2)
        led.charge_cache_growth("decode", float(rng.randint(1, 9999)))
        if step == 3:
            tl.on_preempt(1)
        tl.on_token(0, t + 0.01, ttft_s=0.01 if step == 0 else None)
        tl.record_step(t_start=t, t_end=t + 0.01, occupancy=2, compiles=0,
                       counters={"steps": step + 1,
                                 "decode_tokens": step + 1},
                       gauges={"resident_bytes": 1024.0 * step},
                       slots=[(0, 0, "decode", 1, 1),
                              (1, 1, "prefill", 4, 0)])
        t += 0.01
    tl.on_done(0, t)
    led.charge_sampled(1)
    tl.finalize(t)
    return led, tl


def test_tap_closes_and_is_exclusive():
    cfg = get_config("qwen3-0.6b").reduced()
    led, tl = _synthetic(ttel, TransferLedger, cfg)
    assert tl.ledger_delta_totals() == led.breakdown()     # exact
    assert tl.events[-1].wall_s == 0.0                     # flush event
    led2 = TransferLedger(cfg, "none")
    ttel.StepTimeline(led2)
    with pytest.raises(RuntimeError):
        led2.attach_tap(lambda *a: None)
    led2.detach_tap()
    led2.attach_tap(lambda *a: None)


def test_exports_and_bottleneck_equal_jax(tmp_path):
    """The same charges and steps through both packages' timelines: the
    JSONL and the trace are the same bytes, and the bottleneck reports
    are equal dicts."""
    tled, ttl = _synthetic(ttel, TransferLedger,
                           get_config("qwen3-0.6b").reduced())
    jled, jtl = _synthetic(jtel, JaxLedger, ASSIGNED["qwen3-0.6b"].reduced())
    assert ttl.bottleneck_report().to_dict() == \
        jtl.bottleneck_report().to_dict()
    assert ttl.bottleneck_report().lines() == jtl.bottleneck_report().lines()
    for name in ("m.jsonl", "t.json"):
        for tl, side in ((ttl, "torch"), (jtl, "jax")):
            path = str(tmp_path / f"{side}-{name}")
            (tl.write_metrics_jsonl if name.endswith("l") else
             tl.write_chrome_trace)(path)
        assert (tmp_path / f"torch-{name}").read_bytes() == \
            (tmp_path / f"jax-{name}").read_bytes()
    assert ttel.METRICS_SCHEMA == jtel.METRICS_SCHEMA


@pytest.fixture(scope="module")
def runs():
    """The reduced serve (q8_0, fp32 pages, preempting) through both
    engines with telemetry on."""
    return serve_both("q8_0", telemetry=True)


def test_step_events_equal_jax(runs):
    jtl, ttl = runs["jrep"].timeline, runs["trep"].timeline
    assert runs["trep"].sched.preemptions > 0
    assert len(ttl.events) == len(jtl.events) == runs["trep"].stats.steps
    for t, j in zip(ttl.events, jtl.events):
        assert t.step == j.step
        assert t.occupancy == j.occupancy
        # Every counter the JAX engine keeps, exactly; the port's phase
        # seconds are its own (wall clock, not compared).
        assert set(ttel.TIMING_COUNTERS) <= set(t.counters)
        assert {k: v for k, v in t.counters.items()
                if k not in ttel.TIMING_COUNTERS} == j.counters, t.step
        assert t.slots == j.slots, t.step
        assert t.ledger_delta == j.ledger_delta, t.step
        assert t.gauges == j.gauges, t.step
        assert t.compiles == 0                # no kernel build on the CPU
    assert [a[0] for a in ttl.admissions] == [a[0] for a in jtl.admissions]
    assert [p[0] for p in ttl.preemptions] == [p[0] for p in jtl.preemptions]
    for name in ttl.HIST_NAMES:
        assert ttl.hists[name].count == jtl.hists[name].count, name


def test_timeline_closes_against_ledger(runs):
    rep = runs["trep"]
    tl = rep.timeline
    assert tl.ledger_delta_totals() == rep.ledger.breakdown()
    tot = lambda k: sum(ev.counters.get(k, 0) for ev in tl.events)  # noqa
    assert tot("decode_tokens") == rep.stats.decode_tokens
    assert tot("preemptions") == rep.sched.preemptions
    assert sum(ev.compiles for ev in tl.events) == rep.step_compiles == 0


def test_telemetry_changes_no_token_and_no_trace(runs):
    """The same stream through the port with telemetry off: the tokens
    and the allocator/table trace are those of the run with it on."""
    tcfg = get_config("qwen3-0.6b").reduced()
    eng = ServingEngine(build_model(tcfg), runs["teng"].params,
                        quant="q8_0", cache_dtype=torch.float32,
                        device="cpu", **ENGINE)
    trace = []
    _trace(eng, trace)
    off = eng.serve(tserve.build_stream(tcfg, ARGS, np.random.RandomState(0)),
                    seed=0, realtime=False)
    assert off.timeline is None
    assert [s.generated for s in off.sequences] == \
        [s.generated for s in runs["trep"].sequences]
    assert len(trace) == len(runs["ttrace"])
    for (a, *ra), (b, *rb) in zip(trace, runs["ttrace"]):
        np.testing.assert_array_equal(a, b)
        assert ra == rb
    assert off.ledger.breakdown() == runs["trep"].ledger.breakdown()


def test_exports_pass_both_validators(runs, tmp_path):
    tl = runs["trep"].timeline
    mpath, tpath = str(tmp_path / "m.jsonl"), str(tmp_path / "t.json")
    tl.write_metrics_jsonl(mpath)
    tl.write_chrome_trace(tpath)
    assert ttel.validate_metrics_jsonl(mpath) == len(tl.events)
    assert jtel.validate_metrics_jsonl(mpath) == len(tl.events)
    assert ttel.validate_chrome_trace(tpath) == \
        jtel.validate_chrome_trace(tpath) > 0
    assert ttel._main(["validate", mpath, tpath]) == 0


def test_serve_report_lines(runs):
    text = "\n".join(ttel.serve_report_lines(
        runs["teng"], runs["trep"], total_requests=ARGS.requests,
        launches=tserve.launch_counts()))
    for needle in ("step compiles 0", "mean queue wait", "bottleneck",
                   "p50", "transfer-bound", "paged arena", "kernels:",
                   "host phases a step: between steps"):
        assert needle in text, f"report lines missing {needle!r}"
