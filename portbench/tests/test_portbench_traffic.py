"""The traffic generator: one seed, one stream; every seed the same set
of lengths and gaps; the stated medians and clips."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT)]

from portbench.core import traffic  # noqa: E402

MIXES = {p.stem: json.loads(p.read_text())
         for p in (ROOT / "portbench" / "traffic").glob("*.json")}
CELL = {"rate_rps": 4.0, "ramp_s": 10.0}
BIG_SEED = 2 ** 31 + 12345


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_same_seed_same_stream(mix):
    a = traffic.stream(MIXES[mix], CELL, BIG_SEED, 30, 1000)
    b = traffic.stream(MIXES[mix], CELL, BIG_SEED, 30, 1000)
    assert [(s.rid, s.max_new_tokens, s.arrival_s) for s in a] == \
        [(s.rid, s.max_new_tokens, s.arrival_s) for s in b]
    assert all(np.array_equal(x.tokens, y.tokens) for x, y in zip(a, b))
    c = traffic.stream(MIXES[mix], CELL, BIG_SEED + 1, 30, 1000)
    assert any(not np.array_equal(x.tokens[-4:], y.tokens[-4:])
               for x, y in zip(a, c))


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_seeds_share_the_work(mix):
    a = traffic.stream(MIXES[mix], CELL, 1, 30, 1000)
    b = traffic.stream(MIXES[mix], CELL, 2, 30, 1000)
    assert len(a) == len(b) == 160
    assert sorted(len(s.tokens) for s in a) == sorted(len(s.tokens)
                                                      for s in b)
    assert sorted(s.max_new_tokens for s in a) == \
        sorted(s.max_new_tokens for s in b)
    assert a[-1].arrival_s == pytest.approx(b[-1].arrival_s)


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_medians_and_clips(mix):
    m = MIXES[mix]
    specs = traffic.stream(m, {"rate_rps": 1000.0, "ramp_s": 0.0}, 7, 1.0,
                           1000)
    doc = m.get("doc_tokens", 0)
    for dist, vals in ((m["prompt"], [len(s.tokens) - doc for s in specs]),
                       (m["output"], [s.max_new_tokens for s in specs])):
        assert min(vals) >= dist["min"] and max(vals) <= dist["max"]
        assert abs(np.median(vals) - dist["median"]) <= 1
    assert len(specs) == 1000
    assert len(specs) / specs[-1].arrival_s == pytest.approx(1000, rel=0.05)
    if doc:
        d = specs[0].tokens[:doc]
        assert all(np.array_equal(s.tokens[:doc], d) for s in specs)
        assert np.array_equal(traffic.document(m, 7, 1000), d)


def test_warmup_publishes_the_document():
    m = MIXES["doc"]
    w = traffic.warmup(m, 3, 1000, slots=4, chunk=8)
    assert len(w) == 5 and all(s.arrival_s == 0 for s in w)
    assert np.array_equal(w[-1].tokens[:m["doc_tokens"]],
                          traffic.document(m, 3, 1000))
    assert {len(s.tokens) for s in w[:4]} == {20}
