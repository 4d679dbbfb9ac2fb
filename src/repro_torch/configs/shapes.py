"""The four assigned input-shape cells (shared by all LM-family archs),
copied from ``repro.configs.shapes``.

``decode_*`` / ``long_*`` lower a decode step (one new token against a
KV cache of ``seq_len``), NOT the train step. ``long_500k`` requires
sub-quadratic token mixing and is only run for SSM/hybrid archs (the
dry-run records the skip).
"""
from __future__ import annotations

from repro_torch.configs.base import ShapeSpec

SHAPES = {
    "train_4k": ShapeSpec("train_4k", seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": ShapeSpec("prefill_32k", seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": ShapeSpec("decode_32k", seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": ShapeSpec("long_500k", seq_len=524288, global_batch=1, kind="decode"),
}


def shape_applicable(arch_subquadratic: bool, shape: ShapeSpec) -> bool:
    """long_500k only runs for sub-quadratic (SSM/hybrid) archs."""
    if shape.name == "long_500k":
        return arch_subquadratic
    return True
