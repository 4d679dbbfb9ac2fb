"""Plain float32 reference of a Qwen2 decoder (model_type "qwen2").

The published architecture: token embedding; per layer, RMSNorm, grouped
query attention with biases on q, k and v, rotary embedding (rotate-half
form, ``rope_theta``), causal softmax attention scaled by head_dim^-1/2,
output projection, residual; RMSNorm, SwiGLU FFN, residual; a final
RMSNorm and an untied lm_head. Every linear weight, the embedding and
the lm_head are first stored in ``fmt`` (q8_0 as served; q4_0 for the
control) by ``reference.quant`` and read back in float32; norms and
biases stay as made. Imports nothing of the program.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import torch

from portbench.reference import core, quant
from portbench.reference.weights import Leaf


def dims(hf: Dict) -> Dict:
    d, h = hf["hidden_size"], hf["num_attention_heads"]
    return dict(d=d, h=h, hkv=hf["num_key_value_heads"], hd=d // h,
                f=hf["intermediate_size"], v=hf["vocab_size"],
                layers=hf["num_hidden_layers"])


def leaves(hf: Dict) -> List[Leaf]:
    """Every tensor of the model, in groups of one draw each."""
    m = dims(hf)
    d, hd, f = m["d"], m["hd"], m["f"]
    out = [Leaf("embed", (m["v"], d), "embed", 0.02)]
    for i in range(m["layers"]):
        g = f"layer{i}"
        out += [Leaf(f"L{i}.q", (m["h"] * hd, d), g, d ** -0.5),
                Leaf(f"L{i}.k", (m["hkv"] * hd, d), g, d ** -0.5),
                Leaf(f"L{i}.v", (m["hkv"] * hd, d), g, d ** -0.5),
                Leaf(f"L{i}.o", (d, m["h"] * hd), g, (m["h"] * hd) ** -0.5),
                Leaf(f"L{i}.gate", (f, d), g, d ** -0.5),
                Leaf(f"L{i}.up", (f, d), g, d ** -0.5),
                Leaf(f"L{i}.down", (d, f), g, f ** -0.5)]
        out += [Leaf(f"L{i}.q_bias", (m["h"] * hd,), "bias", 0.1),
                Leaf(f"L{i}.k_bias", (m["hkv"] * hd,), "bias", 0.1),
                Leaf(f"L{i}.v_bias", (m["hkv"] * hd,), "bias", 0.1)]
        out += [Leaf(f"L{i}.mixer_norm", (d,), "norms", 0.1, norm=True),
                Leaf(f"L{i}.ffn_norm", (d,), "norms", 0.1, norm=True)]
    out += [Leaf("final_norm", (d,), "norms", 0.1, norm=True),
            Leaf("lm_head", (m["v"], d), "lm_head", d ** -0.5)]
    return out


def forward(hf: Dict, W: Callable[[str], torch.Tensor],
            seqs: List[torch.Tensor], fmt: str,
            on_logits: Callable[[int, int, torch.Tensor], None]) -> None:
    """Run every sequence (1-D token tensors on one device) through the
    model and hand its logits on with ``on_logits(seq, row0, block)``."""
    m = dims(hf)
    eps = hf["rms_norm_eps"]
    hd = m["hd"]

    def lin(n):
        return quant.dequantized(W(n), fmt)

    def vec(n):
        return W(n).to(torch.float32)

    with core.exact_f32():
        table = W("embed")
        hs = [quant.dequantized(table[s], fmt) for s in seqs]
        del table
        for i in range(m["layers"]):
            wq, wk, wv, wo, wg, wu, wd = (
                lin(f"L{i}.{n}")
                for n in ("q", "k", "v", "o", "gate", "up", "down"))
            bq, bk, bv = (vec(f"L{i}.{n}_bias") for n in ("q", "k", "v"))
            g1, g2 = vec(f"L{i}.mixer_norm"), vec(f"L{i}.ffn_norm")
            for j, h in enumerate(hs):
                L = h.shape[0]
                x = core.rmsnorm(h, g1, eps)
                q = (x @ wq.T + bq).view(L, m["h"], hd)
                k = (x @ wk.T + bk).view(L, m["hkv"], hd)
                v = (x @ wv.T + bv).view(L, m["hkv"], hd)
                q = core.rope(q, hf["rope_theta"])
                k = core.rope(k, hf["rope_theta"])
                a = core.causal_attention(q, k, v, hd ** -0.5)
                h = h + a.reshape(L, -1) @ wo.T
                h = h + core.swiglu(core.rmsnorm(h, g2, eps), wg, wu, wd)
                hs[j] = h
            del wq, wk, wv, wo, wg, wu, wd
        gf = vec("final_norm")
        wl = lin("lm_head")
        for j, h in enumerate(hs):
            core.head_logits(core.rmsnorm(h, gf, eps), wl,
                             lambda r0, lg, j=j: on_logits(j, r0, lg))
