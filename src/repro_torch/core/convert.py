"""Parameter conversion: quantize dense parameters into a recipe, and carry
the JAX package's parameters into the port's layout.

``quantize_params`` is the llama.cpp "model quantization" stage, after
``repro.core.convert.quantize_params``: every linear/embedding weight is
quantized per the recipe, norms stay high precision (paper §III.B), the
MoE router is kept unquantized (rounded to bf16, as the JAX stage does),
the SSM mixer's conv taps, A_log, D and dt_bias stay f32 (only its
in/out projections are quantized), and an MoE expert bank (E, out, in) is quantized row by row into (E, out,
packed) planes. Rows are quantized ``_ROW_ELEMS`` elements at a time, so
a bank or an embedding never needs an f32 copy of itself.

``shard_params`` is the serving mesh's counterpart of the JAX package's
``serving_param_shardings``: each rank keeps the block of every
linear's and expert bank's planes that ``serving_weight_spec`` names.

``params_from_jax`` takes the JAX package's parameter tree *as numpy
arrays* (the caller does the ``np.asarray``; this module never imports
JAX) and returns the port's tree on ``device``: each ``jax.vmap``-stacked
layer group (``repro.models.lm.lm_init``; whisper's ``enc_layers`` and
``dec_layers``) becomes a list of per-layer dicts (jamba's ``blocks``
group: a list of ``{"sub0": ..., "sub7": ...}`` block dicts). bf16 leaves travel as their uint16 bit pattern, because
``torch.from_numpy`` rejects ``ml_dtypes.bfloat16``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quant import pack
from repro_torch.core.quant.formats import RECIPES
from repro_torch.models.lm import layer_groups
from repro_torch.parallel import sharding

_NORM_KEYS = {"mixer_norm", "ffn_norm", "final_norm", "q_norm", "k_norm",
              "norm", "norm1", "norm2", "self_norm", "cross_norm",
              "enc_norm", "dec_norm"}
_EMBED_KEYS = {"embed", "lm_head"}
_RAW_KEYS = {"conv_w", "conv_b", "A_log", "D", "dt_bias", "router"}
# Weight elements quantized at a time (block quantization only touches
# the last axis, so row grouping does not change the planes).
_ROW_ELEMS = 1 << 26


def _is_linear_node(node: Any) -> bool:
    return (isinstance(node, dict) and isinstance(node.get("w"), torch.Tensor)
            and node["w"].ndim >= 2)


def _quantize_rows(w: torch.Tensor, fmt: str) -> Dict:
    """(..., out, in) weights -> planes (..., out, packed), quantizing
    ``_ROW_ELEMS`` elements' worth of rows at a time."""
    flat = w.reshape(-1, w.shape[-1])
    step = max(1, _ROW_ELEMS // flat.shape[1])
    out: Dict[str, torch.Tensor] = {}
    for r0 in range(0, flat.shape[0], step):
        planes = pack.quantize(flat[r0:r0 + step].to(torch.float32), fmt)
        for k, v in planes.items():
            if k not in out:
                out[k] = torch.empty((flat.shape[0],) + tuple(v.shape[1:]),
                                     dtype=v.dtype, device=v.device)
            out[k][r0:r0 + step] = v
    return {k: v.reshape(*w.shape[:-1], -1) for k, v in out.items()}


def _quantize_leaf_dict(node: Dict, fmt: str) -> Dict:
    w = node["w"]
    if fmt == "none":
        out = {"w": w.to(torch.bfloat16)}
    else:
        out = _quantize_rows(w, fmt)
    if "b" in node:
        out["b"] = node["b"]
    return out


def quantize_params(params: Dict, quant: str) -> Dict:
    """Dense params tree -> quantized tree (recipe ``quant``)."""
    recipe = RECIPES[quant] if quant != "none" else None

    def walk(node, path):
        if _is_linear_node(node):
            key = path[-1] if path else ""
            if recipe is None or key in _RAW_KEYS:
                fmt = "none"
            elif key in _EMBED_KEYS:
                fmt = recipe["embed"]
            else:
                fmt = recipe["linear"]
            return _quantize_leaf_dict(node, fmt)
        if isinstance(node, dict):
            return {k: v if k in _NORM_KEYS else walk(v, path + (k,))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path) for v in node]
        return node

    return walk(params, ())


def shard_params(params: Dict, mesh) -> Dict:
    """This rank's parameters on a serving ``mesh``: every plane dict of
    a linear or an MoE expert bank (a dict of tensors) whose planes the
    rule (``sharding.serving_weight_spec``) cuts over 'model' keeps its
    rank's block of their out-feature axis, as a ``sharding.ModelShard``
    (a bias, 1-D, stays whole). Everything else stays whole: the
    embedding and routers (replicated by the rule), norms, and the
    tensors that sit directly in a mixer's dict (the SSM's conv taps,
    A_log, D, dt_bias: the rule would cut the conv taps' axis -2, which
    the causal conv sums over, so they are kept whole instead of
    gathered back every step). A dict that is already a ModelShard is
    kept as it is."""
    tp = sharding.serving_degrees(mesh)[1]

    def walk(node, path):
        if isinstance(node, sharding.ModelShard):
            return node
        if isinstance(node, dict) and node and all(
                isinstance(v, torch.Tensor) for v in node.values()):
            specs = {k: sharding.serving_weight_spec(path + (k,),
                                                     tuple(v.shape), mesh)
                     for k, v in node.items()}
            if not any("model" in sp for sp in specs.values()):
                return node
            return sharding.ModelShard(
                {k: sharding.apply_spec(v, specs[k], mesh)
                 for k, v in node.items()}, tp, mesh.coords["model"])
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path) for v in node]
        return node

    return walk(params, ())


def _to_torch(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a.view(np.uint16))).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def _map(node, fn):
    if isinstance(node, dict):
        return {k: _map(v, fn) for k, v in node.items()}
    return fn(node)


def params_from_jax(np_tree: Dict, cfg: ModelConfig, *,
                    device="cuda") -> Dict:
    """The JAX package's parameter tree (numpy leaves) as the port's tree
    on ``device``: layer groups unstacked into lists of per-layer dicts,
    every other leaf converted as is."""
    if cfg.family == "encdec":
        groups = {"enc_layers": cfg.encoder_layers,
                  "dec_layers": cfg.num_layers}
    else:
        groups = {name: count for name, count, _ in layer_groups(cfg)}
    out = {}
    for key, node in np_tree.items():
        if key in groups:
            out[key] = [_map(node, lambda a, i=i: _to_torch(a[i], device))
                        for i in range(groups[key])]
        else:
            out[key] = _map(node, lambda a: _to_torch(a, device))
    return out
