"""The dry-run and roofline tables from the port's dry-run cells, a
copy of ``repro.analysis.report`` reading ``launch.dryrun``'s JSON (the
JAX cell's keys).

  PYTHONPATH=src python -m repro_torch.analysis.report [--dir out/dryrun_torch]
"""
from __future__ import annotations

import argparse
import json
import pathlib
from typing import Dict, List

ARCH_ORDER = ["llama3.2-3b", "qwen2-72b", "llama3-405b", "qwen3-0.6b",
              "qwen2-vl-2b", "jamba-v0.1-52b", "deepseek-v3-671b",
              "granite-moe-3b-a800m", "whisper-small", "mamba2-1.3b"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load_cells(d: pathlib.Path) -> List[Dict]:
    return [json.loads(f.read_text()) for f in sorted(d.glob("*.json"))]


def fmt_bytes(b) -> str:
    if b >= 1e9:
        return f"{b/1e9:.2f}GB"
    if b >= 1e6:
        return f"{b/1e6:.1f}MB"
    return f"{b/1e3:.0f}KB"


def is_baseline(c: Dict) -> bool:
    return (c.get("quant", "none") == "none" and not c.get("mixed")
            and c.get("remat", "full") == "full"
            and c.get("seq_parallel", True))


def dryrun_table(cells: List[Dict], multi_pod: bool) -> str:
    rows = ["| arch | shape | status | bytes/device (args+temp) | FLOPs/dev | collective schedule |",
            "|---|---|---|---|---|---|"]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            match = [c for c in cells
                     if c["arch"] == arch and c["shape"] == shape
                     and c.get("multi_pod") == multi_pod and is_baseline(c)]
            if not match:
                rows.append(f"| {arch} | {shape} | (missing) | | | |")
                continue
            c = match[0]
            if "skipped" in c:
                rows.append(f"| {arch} | {shape} | SKIP (full attention; "
                            f"long_500k needs sub-quadratic mixing) | | | |")
                continue
            if "error" in c:
                rows.append(f"| {arch} | {shape} | ERROR "
                            f"{c['error'][:60]} | | | |")
                continue
            colls = c.get("collectives", {})
            sched = ", ".join(f"{k}:{fmt_bytes(v)}"
                              for k, v in sorted(colls.items())) or "none"
            mem = f"{fmt_bytes(c.get('argument_bytes', 0))}+" \
                  f"{fmt_bytes(c.get('temp_bytes', 0))}"
            rows.append(
                f"| {arch} | {shape} | counted ({c.get('compile_s', 0):.0f}s)"
                f" | {mem} | {c['flops_per_device']/1e12:.2f}T | {sched} |")
    return "\n".join(rows)


def roofline_table(cells: List[Dict]) -> str:
    rows = ["| arch | shape | compute (s) | memory (s) | collective (s) | "
            "bottleneck | MODEL/HLO flops | roofline MFU | what would move the dominant term |",
            "|---|---|---|---|---|---|---|---|---|"]
    hints = {
        ("memory", "decode"): "quantize weights/KV (paper's technique) — fewer HBM bytes/token",
        ("memory", "train"): "bf16 intermediates + dots_saveable remat (less score/recompute traffic)",
        ("memory", "prefill"): "bf16 attention intermediates; larger KV chunk to cut q re-reads",
        ("collective", "train"): "reduce remat re-all-gathers; reduce-scatter grads; EP for MoE dispatch",
        ("collective", "decode"): "replicate small weights (skip all-gather); batch-shard lm_head",
        ("collective", "prefill"): "overlap all-gather with layer compute; 1D TP for small layers",
        ("compute", "train"): "fp8/int8 tensor cores (2x peak); drop full remat",
    }
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            match = [c for c in cells
                     if c["arch"] == arch and c["shape"] == shape
                     and not c.get("multi_pod") and is_baseline(c)]
            if not match:
                continue
            c = match[0]
            if "skipped" in c:
                rows.append(f"| {arch} | {shape} | — | — | — | SKIP | — | — | "
                            "full-attention arch; long_500k needs sub-quadratic mixing |")
                continue
            if "error" in c:
                rows.append(f"| {arch} | {shape} | — | — | — | ERROR | — | — | {c['error'][:40]} |")
                continue
            kind = ("decode" if "decode" in shape or "long" in shape
                    else ("train" if "train" in shape else "prefill"))
            hint = hints.get((c["bottleneck"], kind), "")
            rows.append(
                f"| {arch} | {shape} | {c['compute_s']:.3f} | "
                f"{c['memory_s']:.3f} | {c['collective_s']:.3f} | "
                f"**{c['bottleneck']}** | "
                f"{c['useful_flops_fraction']:.2f} | {c['mfu']:.3f} | {hint} |")
    return "\n".join(rows)


def perf_variants_table(cells: List[Dict], arch: str, shape: str) -> str:
    match = [c for c in cells if c["arch"] == arch and c["shape"] == shape
             and not c.get("multi_pod") and "skipped" not in c
             and "error" not in c]
    rows = [f"| variant | compute (s) | memory (s) | collective (s) | "
            f"bottleneck | step (s) | MFU |",
            "|---|---|---|---|---|---|---|"]
    for c in sorted(match, key=lambda c: c.get("step_time_s", 0),
                    reverse=True):
        tag = []
        if c.get("quant", "none") != "none":
            tag.append(f"quant={c['quant']}")
        if c.get("mixed"):
            tag.append("mixed-bf16")
        if c.get("remat", "full") != "full":
            tag.append(f"remat={c['remat']}")
        if not c.get("seq_parallel", True):
            tag.append("no-seq-parallel")
        name = " + ".join(tag) if tag else "baseline (paper-faithful, f32 scores, full remat)"
        rows.append(f"| {name} | {c['compute_s']:.3f} | {c['memory_s']:.3f} |"
                    f" {c['collective_s']:.3f} | {c['bottleneck']} | "
                    f"{c['step_time_s']:.3f} | {c['mfu']:.3f} |")
    return "\n".join(rows)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="out/dryrun_torch")
    args = ap.parse_args()
    cells = load_cells(pathlib.Path(args.dir))
    print("### Single-pod (16x16 = 256 ranks)\n")
    print(dryrun_table(cells, multi_pod=False))
    print("\n### Multi-pod (2x16x16 = 512 ranks)\n")
    print(dryrun_table(cells, multi_pod=True))
    print("\n### Roofline (single-pod baselines)\n")
    print(roofline_table(cells))
    for arch, shape in [("qwen3-0.6b", "decode_32k"),
                        ("llama3-405b", "train_4k"),
                        ("jamba-v0.1-52b", "train_4k")]:
        print(f"\n### Perf variants: {arch} x {shape}\n")
        print(perf_variants_table(cells, arch, shape))


if __name__ == "__main__":
    main()
