"""Per-group L/L+1 differencing of the dry-run's counts, ported from
``repro.analysis.extrapolate``.

The JAX package needs it because XLA's HloCostAnalysis counts a
while-loop body once whatever its trip count, so a scanned 126-layer
model reports about one layer of FLOPs; it counts a unit config (one
layer a group) and one config a group with one layer more, and

    cost_total = cost(unit) + sum_g (count_g - 1) * delta_g.

The port counts eagerly, every layer as it runs, so the full config's
count needs no correction; the differencing gives the same numbers
(a test holds it to the full count) from configs of one or two layers
a group, which only cuts the dry-run's time at 61 or 126 layers.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from repro_torch.configs.base import ModelConfig


def variant_cfgs(cfg: ModelConfig):
    """(unit_cfg, {group: plus_one_cfg}, {group: layer_count_in_full})."""
    dc = dataclasses.replace
    if cfg.family == "encdec":
        unit = dc(cfg, encoder_layers=1, num_layers=1)
        plus = {"enc": dc(cfg, encoder_layers=2, num_layers=1),
                "dec": dc(cfg, encoder_layers=1, num_layers=2)}
        counts = {"enc": cfg.encoder_layers, "dec": cfg.num_layers}
    elif cfg.family == "hybrid":
        unit = dc(cfg, num_layers=cfg.attn_period)
        plus = {"blocks": dc(cfg, num_layers=2 * cfg.attn_period)}
        counts = {"blocks": cfg.num_layers // cfg.attn_period}
    elif cfg.moe is not None and cfg.moe.first_dense_layers > 0:
        m1 = dc(cfg.moe, first_dense_layers=1)
        m2 = dc(cfg.moe, first_dense_layers=2)
        unit = dc(cfg, num_layers=2, moe=m1)
        plus = {"dense": dc(cfg, num_layers=3, moe=m2),
                "moe": dc(cfg, num_layers=3, moe=m1)}
        counts = {"dense": cfg.moe.first_dense_layers,
                  "moe": cfg.num_layers - cfg.moe.first_dense_layers}
    else:
        unit = dc(cfg, num_layers=1)
        plus = {"layers": dc(cfg, num_layers=2)}
        counts = {"layers": cfg.num_layers}
    return unit, plus, counts


def measure(lowered) -> Dict:
    """{flops, bytes, collective_bytes, collectives} of a lowered cell
    (``launch.dryrun.Lowered``)."""
    c = lowered.counts
    return {"flops": c["flops"], "bytes": c["bytes"],
            "collective_bytes": c["collective_bytes"],
            "collectives": dict(c["collectives"])}


def _combine(base: Dict, delta: Dict, times: int) -> Dict:
    out = {
        "flops": base["flops"] + times * max(delta["flops"], 0.0),
        "bytes": base["bytes"] + times * max(delta["bytes"], 0.0),
        "collective_bytes": base["collective_bytes"]
        + times * max(delta["collective_bytes"], 0.0),
    }
    colls = dict(base["collectives"])
    for k, v in delta["collectives"].items():
        colls[k] = colls.get(k, 0) + times * max(v, 0)
    out["collectives"] = colls
    return out


def extrapolate(cfg: ModelConfig, lower_fn: Callable[[ModelConfig], object],
                ) -> Dict:
    """lower_fn(cfg_variant) -> a lowered cell. Returns the corrected
    {flops, bytes, collective_bytes, collectives} (per device)."""
    from repro_torch.models import flags
    unit, plus, counts = variant_cfgs(cfg)
    with flags.unroll_inner_scans():
        c0 = measure(lower_fn(unit))
        total = dict(c0)
        total["collectives"] = dict(c0["collectives"])
        for g, pcfg in plus.items():
            cg = measure(lower_fn(pcfg))
            delta = {
                "flops": cg["flops"] - c0["flops"],
                "bytes": cg["bytes"] - c0["bytes"],
                "collective_bytes": (cg["collective_bytes"]
                                     - c0["collective_bytes"]),
                "collectives": {
                    k: cg["collectives"].get(k, 0)
                    - c0["collectives"].get(k, 0)
                    for k in set(cg["collectives"]) | set(c0["collectives"])
                },
            }
            total = _combine(total, delta, counts[g] - 1)
    return total
