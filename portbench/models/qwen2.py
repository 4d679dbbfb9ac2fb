"""Qwen2 (model_type "qwen2") as the port runs it: its configuration,
its parameter tree made from the seed-made leaves, and the work of its
step by kernel class.

The program is imported inside the functions that need it, so that the
reference and the harness's CPU tests can import this module's
arithmetic without it.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from portbench.core import work
from portbench.reference import qwen2 as reference

dims = reference.dims


def check(hf: Dict) -> None:
    """Refuse a file that states what the port does not run."""
    if hf.get("tie_word_embeddings"):
        raise ValueError("this adapter makes an untied lm_head")
    if hf["hidden_size"] % hf["num_attention_heads"]:
        raise ValueError("hidden_size must be a multiple of the heads")


def port_config(hf: Dict, serve: Dict):
    """The port's ModelConfig for the file's numbers."""
    from repro_torch.configs.base import ModelConfig
    check(hf)
    m = dims(hf)
    return ModelConfig(
        name=hf["name"], family="dense", num_layers=m["layers"],
        d_model=m["d"], num_heads=m["h"], num_kv_heads=m["hkv"],
        d_ff=m["f"], vocab_size=m["v"], head_dim=m["hd"], qkv_bias=True,
        rope_theta=float(hf["rope_theta"]), norm_eps=hf["rms_norm_eps"],
        max_seq_len=hf["max_position_embeddings"], quant=serve["quant"])


def port_params(hf: Dict, cfg, t: Dict) -> Dict:
    """The port's dense (bf16) parameter tree over the leaves ``t``;
    norms as float32 copies, biases copied, so that quantizing the tree
    keeps no view of a leaf group alive."""
    from repro_torch.models.lm import layer_groups

    def lin(n, bias=None):
        out = {"w": t[n]}
        if bias:
            out["b"] = t[bias].clone()
        return out

    def norm(n):
        return {"g": t[n].float()}

    def layer(i):
        return {"mixer_norm": norm(f"L{i}.mixer_norm"),
                "attn": {n: lin(f"L{i}.{n}",
                                f"L{i}.{n}_bias" if n != "o" else None)
                         for n in ("q", "k", "v", "o")},
                "ffn_norm": norm(f"L{i}.ffn_norm"),
                "ffn": {n: lin(f"L{i}.{n}") for n in ("gate", "up",
                                                      "down")}}
    tree = {"embed": {"w": t["embed"]}, "final_norm": norm("final_norm"),
            "lm_head": {"w": t["lm_head"]}}
    i = 0
    for name, count, _ in layer_groups(cfg):
        tree[name] = [layer(i + j) for j in range(count)]
        i += count
    return tree


def matmul_shapes(hf: Dict) -> List[Tuple[int, int]]:
    """(N, K) of every q8_0 matmul of one step, lm_head included."""
    m = dims(hf)
    d, q, kv, f = m["d"], m["h"] * m["hd"], m["hkv"] * m["hd"], m["f"]
    per_layer = [(q, d), (kv, d), (kv, d), (d, q), (f, d), (f, d), (d, f)]
    return per_layer * m["layers"] + [(m["v"], d)]


def attention_work(hf: Dict, feeds) -> work.Work:
    """Paged attention (B1) of one step, every layer."""
    m = dims(hf)
    return work.gqa_attention(feeds, m["h"], m["hkv"],
                              m["hd"]).scaled(m["layers"])


def useful_flops(hf: Dict, feeds, sampled_rows: int) -> float:
    """Model flops of one step: every linear on each fed token, attention
    at each token's context, the lm_head on the rows that were sampled."""
    m = dims(hf)
    d, q, kv, f = m["d"], m["h"] * m["hd"], m["hkv"] * m["hd"], m["f"]
    per_token = m["layers"] * 2.0 * (d * (q + 2 * kv) + q * d + 3 * d * f)
    tokens = sum(n for _, n in feeds)
    return tokens * per_token + attention_work(hf, feeds).flops \
        + sampled_rows * 2.0 * d * m["v"]
