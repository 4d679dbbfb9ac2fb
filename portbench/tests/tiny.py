"""A tiny cell of the qwen2 model type for the harness's CPU tests: the
benchmark's own metrics, mixes and check at widths a CPU runs in
seconds."""
from __future__ import annotations

import copy
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

SERVE = {"quant": "q8_0", "kv_pages": "bfloat16", "slots": 4,
         "chunk_size": 4, "block_size": 4, "prefix_cache": True}

QWEN2 = {"name": "tiny-qwen2", "model_type": "qwen2", "hidden_size": 64,
         "intermediate_size": 128, "max_position_embeddings": 4096,
         "num_attention_heads": 4, "num_hidden_layers": 2,
         "num_key_value_heads": 2, "rms_norm_eps": 1e-6,
         "rope_theta": 1000000.0, "tie_word_embeddings": False,
         "vocab_size": 256, "serve": SERVE}

MIXES = {"short": {"prompt": {"median": 10, "sigma": 0.8, "min": 3,
                              "max": 24},
                   "output": {"median": 6, "sigma": 0.8, "min": 2,
                              "max": 12}},
         "doc": {"doc_tokens": 16,
                 "prompt": {"median": 5, "sigma": 0.8, "min": 2, "max": 8},
                 "output": {"median": 4, "sigma": 0.8, "min": 2, "max": 8}}}


def bench():
    """The checkout's BENCHMARK.json with every metric open to any cell."""
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in b["end_to_end"] + b["per_layer"]:
        m.pop("workloads", None)
    return b


def cell(mix: str = "short", rate: float = 8.0, ramp: float = 0.5,
         limit: float = 0.5):
    return {"cell": {"name": f"tiny.qwen2.{mix}"},
            "hf": copy.deepcopy(QWEN2), "mix": copy.deepcopy(MIXES[mix]),
            "params": {"rate_rps": rate, "ramp_s": ramp,
                       "check": {"logit_gap": limit}}}
