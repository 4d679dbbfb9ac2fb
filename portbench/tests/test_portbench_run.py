"""A run end to end on the CPU at a tiny size: the result line's schema,
and the check coming out false under each fault a serving cell can have,
planted underneath the timed path, and under the control."""
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

torch = pytest.importorskip("torch")

from portbench.core import bench  # noqa: E402
from portbench.tests import tiny  # noqa: E402

SEED = 2 ** 31 + 77


def run(mix="short", seconds=1.0, rate=8.0, **kw):
    return bench.run_cell("tiny", SEED, seconds, False, time.time(),
                          device="cpu", bench=tiny.bench(),
                          resolved=tiny.cell(mix, rate=rate), **kw)


def test_result_schema_and_a_sound_run():
    out = run(mix="doc")
    assert list(out)[-1] == "compared"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0 and out["served_checked"] > 0
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    names = {m["name"] for m in tiny.bench()["end_to_end"]}
    assert names <= set(out["metrics"])
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert out["compared"]["logit_gap"]["value"] \
        <= out["compared"]["logit_gap"]["limit"]
    json.dumps(out)


def test_altered_token_is_caught(monkeypatch):
    from repro_torch.runtime import sampling
    sample = sampling.sample_slots
    calls = []

    def altered(*a, **kw):
        nxt = sample(*a, **kw)
        calls.append(1)
        return (nxt + 1) % tiny.QWEN2["vocab_size"] if len(calls) % 3 == 0 \
            else nxt
    monkeypatch.setattr(sampling, "sample_slots", altered)
    assert run()["correct"] is False


def test_state_left_unchanged_is_caught(monkeypatch):
    from repro_torch.models import attention
    monkeypatch.setattr(attention, "_write", lambda *a, **kw: None)
    assert run()["correct"] is False


def test_half_the_batch_left_out_is_caught(monkeypatch):
    """Each step computes half of its slots and hands the other half its
    neighbours' rows: which half alternates by step, so every slot is
    left out in turn."""
    from repro_torch.models import lm
    step = lm.lm_decode_step
    calls = []

    def half(*a, **kw):
        logits, cache = step(*a, **kw)
        calls.append(1)
        kept = torch.arange(logits.shape[0]) // 2 * 2 + len(calls) % 2
        return logits[kept], cache
    monkeypatch.setattr(lm, "lm_decode_step", half)
    assert run()["correct"] is False


def test_control_fails_the_limit():
    """The reference in q4_0 in the program's place, through the same
    comparison: the run comes out not correct, while the program's own
    gap on the same sequences keeps under the limit."""
    out = run(control="q4_0")
    assert out["control"] == "q4_0" and list(out)[-1] == "compared"
    assert out["correct"] is False
    c = out["compared"]["logit_gap"]
    assert c["value"] > c["limit"]
    assert out["readings"]["program_logit_gap"] <= c["limit"]


def test_int8_pages_control_serves_int8_pages(monkeypatch):
    """The program's own int8 page path in place of the configuration's
    bf16 pages: the engine is built with it, and the run is judged by the
    same comparison."""
    from repro_torch.runtime import engine
    built = []
    init = engine.ServingEngine.__init__

    def spy(self, *a, **kw):
        built.append(kw.get("kv_quant"))
        init(self, *a, **kw)
    monkeypatch.setattr(engine.ServingEngine, "__init__", spy)
    out = run(control="int8_pages")
    assert built == ["int8"] and out["control"] == "int8_pages"
    assert out["compared"]["logit_gap"]["value"] > 0


def test_without_a_card_no_result():
    p = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"),
                        "--workload", "qwen2-72b.decode", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=120)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert p.returncode != 0 and p.stdout.strip() == ""
