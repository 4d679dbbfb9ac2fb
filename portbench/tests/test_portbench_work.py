"""Work counts against hand sums: one B2 call, attention over a slot's
context, the step's model flops and the roofline share."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT)]

from portbench.core import work  # noqa: E402
from portbench.models import qwen2  # noqa: E402

CONFIGS = ROOT / "portbench" / "configs"
QWEN = json.loads((CONFIGS / "qwen2-72b-8L-q8_0.json").read_text())


def test_q8_0_matmul_by_hand():
    w = work.q8_0_matmul(256, 29568, 8192)
    assert w.flops == 2 * 256 * 29568 * 8192
    planes = 29568 * 8192 + 29568 * 8192 // 32 * 2      # int8 + fp16 / 32
    assert w.nbytes == planes + 256 * 8192 * 2 + 256 * 29568 * 2
    assert w.bound_s == max(w.flops / 989e12, w.nbytes / 3.35e12)


def test_attention_by_hand():
    # One slot decoding at position 99 (100 keys), one prefilling 2 rows
    # from position 10 (11 and 12 keys).
    g = work.gqa_attention([(99, 1), (10, 2)], heads=64, kv_heads=8,
                           head_dim=128)
    assert g.flops == 4 * 64 * 128 * (100 + 11 + 12)
    assert g.nbytes == 2 * (100 + 12) * 8 * 128 * 2 + 2 * 3 * 64 * 128 * 2


def test_step_shapes_match_the_ports_launch_counts():
    # 57 q8_0 matmuls a qwen2-72b (8 layers) step, as the port's own
    # launch counters read.
    assert len(qwen2.matmul_shapes(QWEN)) == 57


def test_useful_flops_by_hand():
    feeds = [(99, 1)]
    d, f, v = 8192, 29568, 152064
    per_token = 8 * 2 * (d * (8192 + 2 * 1024) + 8192 * d + 3 * d * f)
    attn = 8 * 4 * 64 * 128 * 100
    assert qwen2.useful_flops(QWEN, feeds, 1) == pytest.approx(
        per_token + attn + 2 * d * v)
