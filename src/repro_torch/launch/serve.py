"""Serving launcher for the port — continuous-batching request-stream driver.

``repro.launch.serve`` with the same flags, plus ``--device``. Stream
mode replays a stream of requests (Poisson or back-to-back arrivals)
through the serving engine — on the paged arena with ``--block-size``
(bf16 pages, or int8 pages with ``--kv-quant int8``), else on the
contiguous slot arena — and reports completions, step time, throughput
and the transfer ledger. ``build_stream`` is the JAX launcher's, so with
the same ``--seed`` both serves see the same requests. Weights are
random, made from ``--seed`` on the device.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --quant q8_0 --slots 8 --chunk-size 8 --block-size 16 \
      --num-blocks 256 --requests 16 --prompt-len 128 --gen 32 \
      --arrival back2back [--kv-quant int8]

Batch mode (the lockstep ``Engine`` on the contiguous arena, kept for the
paper's fixed [in:out] workload grid):

  PYTHONPATH=src python -m repro_torch.launch.serve --mode batch \
      --quant q8_0 --prompt-len 128 --gen 32 --batch 8

``--arch`` takes the ported configs: qwen3-0.6b/1.7b/8b, and the MoE
models granite-moe-3b-a800m and deepseek-v3-671b (MLA; its 61 layers at
full width do not fit one card: ``--reduced`` for the CPU).

The card is the default device. Without one the launcher exits with an
error unless ``--device cpu`` asks for the plain CPU path explicitly.
Flags whose feature is not ported yet are refused with the ROADMAP item
that ports them.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.configs.registry import family_of, get_config
from repro_torch.core import convert
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ops import MATMUL_KERNELS
from repro_torch.kernels.paged_attention import paged_decode_attention
from repro_torch.models.api import build_model
from repro_torch.runtime.engine import Engine, ServingEngine
from repro_torch.runtime.request import Request, SamplingParams

# Every hand-written kernel's wrapper, each with its ``launches`` count.
KERNELS = tuple(w for w, _ in MATMUL_KERNELS.values()) + (
    paged_decode_attention, flash_attention)


# The paged attention's other forms, each counted as a kernel of its own:
# (name, counter attribute of paged_decode_attention).
PAGED_FORMS = (("paged_decode_attention_int8", "int8_launches"),
               ("paged_decode_attention_mla", "mla_launches"),
               ("paged_decode_attention_mla_int8", "mla_int8_launches"))


def launch_counts():
    """{kernel: launches} of every hand-written kernel, each form of the
    paged attention (int8, MLA, MLA int8) as a kernel of its own."""
    out = {k.__name__: k.launches for k in KERNELS}
    for name, attr in PAGED_FORMS:
        out[name] = getattr(paged_decode_attention, attr)
    return out


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for k in KERNELS:
        k.launches = 0
    for _, attr in PAGED_FORMS:
        setattr(paged_decode_attention, attr, 0)


def make_extras(cfg, batch: int):
    """Per-request frontend stubs: dense and moe models take none
    (vlm/encdec stubs come with ROADMAP A16)."""
    return {}


def build_stream(cfg, args, rng: np.random.RandomState):
    """Request stream with randomized lengths + Poisson/back-to-back
    arrival offsets."""
    lo = max(args.prompt_len // 2, 2)
    samp = SamplingParams(temperature=args.temperature)
    shared = rng.randint(0, cfg.vocab_size, args.shared_prefix) \
        if args.shared_prefix else None
    t = 0.0
    reqs = []
    for i in range(args.requests):
        L = int(rng.randint(lo, args.prompt_len + 1))
        if args.arrival == "poisson" and args.rate > 0:
            t += float(rng.exponential(1.0 / args.rate))
        extras = make_extras(cfg, 1)
        tokens = rng.randint(0, cfg.vocab_size, L)
        if shared is not None:
            # system-prompt workload: every request opens with the same
            # token prefix (what --prefix-cache deduplicates)
            tokens = np.concatenate([shared, tokens])
        reqs.append(Request(
            rid=i, tokens=tokens,
            max_new_tokens=args.gen, sampling=samp,
            arrival_s=t if args.arrival == "poisson" else 0.0,
            extras=extras or None))
    return reqs


def build_params(model, args, device, quantize: bool = True):
    """Seeded random weights at the config's widths, made on ``device``
    as the JAX launcher does (bf16 init, then — unless ``quantize`` is
    False — the quantization stage)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = model.init(gen)
    if quantize and args.quant != "none":
        params = convert.quantize_params(params, args.quant)
    return params


def run_stream(cfg, model, params, args, device):
    """Serve the stream; returns (engine, report, requests)."""
    rng = np.random.RandomState(args.seed)
    reqs = build_stream(cfg, args, rng)
    max_seq = args.max_seq or (args.shared_prefix + args.prompt_len
                               + args.gen)
    engine = ServingEngine(
        model, params, quant=args.quant, num_slots=args.slots,
        max_seq=max_seq, chunk_size=args.chunk_size,
        block_size=args.block_size or None,
        num_blocks=args.num_blocks or None,
        paged_attn=args.paged_attn or "fused", kv_quant=args.kv_quant,
        host_sampling=args.host_sampling, device=device)
    report = engine.serve(reqs, seed=args.seed)
    return engine, report, reqs


def run_batch(cfg, model, dense_params, args, device):
    """Lockstep generation of ``--batch`` seeded random prompts of
    ``--prompt-len`` tokens, ``--gen`` new tokens each, through
    ``Engine.from_dense`` (the quantization stage runs here). Returns
    (tokens (batch, gen), stats)."""
    max_seq = args.max_seq or (args.prompt_len + args.gen)
    engine = Engine.from_dense(model, dense_params, args.quant,
                               max_seq=max_seq, chunk_size=args.chunk_size,
                               device=device)
    prompt = np.random.RandomState(args.seed + 1).randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    return engine.generate(prompt, args.gen, temperature=args.temperature,
                           seed=args.seed)


def batch_lines(stats, args):
    """The batch report: phase times, per-sequence and total decode
    throughput, arena bytes and the ledger's bytes per token."""
    return [
        f"prefill {stats.prefill_s * 1e3:.1f} ms | decode "
        f"{stats.decode_s * 1e3:.1f} ms "
        f"({stats.decode_tok_per_s / args.batch:.1f} tok/s/seq, "
        f"{stats.decode_tok_per_s:.1f} tok/s total) | cache "
        f"{stats.cache_bytes / 1e6:.1f} MB | bytes/token "
        f"{stats.transfers.bytes_per_token / 1e6:.2f} MB",
        "kernels: " + " | ".join(f"{name} launches {n}"
                                 for name, n in launch_counts().items())]


def report_lines(engine, report, total_requests: int):
    """The serve report: completions, steps, throughput, step time,
    latency percentiles, the ledger and the kernels' launch counts."""
    st = report.stats
    lat = report.latency_percentiles()
    lines = [
        f"completed {len(report.sequences)}/{total_requests} requests | "
        f"steps {st.steps} | preemptions {report.sched.preemptions} | "
        f"mean occupancy {report.sched.mean_occupancy:.2f}",
        f"tokens: prompt {st.prefill_tokens} generated {st.decode_tokens} | "
        f"throughput {report.throughput_tok_s:.1f} tok/s | "
        f"p50 step {report.step_ms_percentile(50):.2f} ms "
        f"p90 step {report.step_ms_percentile(90):.2f} ms",
        f"latency p50 {lat[50]*1e3:.1f} ms p90 {lat[90]*1e3:.1f} ms "
        f"p99 {lat[99]*1e3:.1f} ms | arena {st.cache_bytes/1e6:.1f} MB "
        f"peak resident {st.peak_resident_bytes/1e6:.1f} MB | "
        f"paged KV reads {st.paged_kv_read_bytes/1e6:.1f} MB",
    ]
    lines += report.ledger.summary_lines(
        {"prefill": st.prefill_s, "decode": st.decode_s})
    lines.append("kernels: " + " | ".join(
        f"{name} launches {n}" for name, n in launch_counts().items()))
    return lines


def validate_args(ap, args) -> None:
    """Fail fast on flags whose feature is not ported, or that do not
    combine — never silently measure a different configuration. The
    combination checks are the JAX launcher's."""
    refused = [
        (args.spec != "off" or args.spec_k is not None
         or args.spec_draft_model, "--spec is ROADMAP A12"),
        (args.prefix_cache or args.shared_prefix, "--prefix-cache and "
                                                  "--shared-prefix are "
                                                  "ROADMAP A13"),
        (args.dp * args.tp != 1, "--dp/--tp are ROADMAP A17"),
        (getattr(args, "metrics_out", None) or getattr(args, "trace", None),
         "--metrics-out/--trace (telemetry) are ROADMAP A11"),
        (getattr(args, "offload_policy", False),
         "--offload-policy needs the IMAX model, ROADMAP A21"),
    ]
    for bad, why in refused:
        if bad:
            ap.error(f"not ported to repro_torch: {why}")
    if args.num_blocks and not args.block_size:
        ap.error("--num-blocks requires --block-size (paged arena)")
    if args.kv_quant != "none":
        if not args.block_size:
            ap.error("--kv-quant requires the paged arena (--block-size): "
                     "quantize-on-insert and in-kernel dequant live on "
                     "the paged block-table path; the contiguous slot "
                     "arena has no quantized read path")
        if args.mode != "stream":
            ap.error("--kv-quant requires --mode stream (the lockstep "
                     "batch path builds its own contiguous-arena engines)")
        fam = family_of(args.arch)
        if fam in ("ssm", "hybrid"):
            ap.error(f"--kv-quant is unsupported for the {fam!r} family "
                     f"({args.arch}): recurrent state is a running "
                     "summary, not per-position KV pages — requantizing "
                     "it every step would compound rounding error")
        if fam == "encdec":
            ap.error(f"--kv-quant is unsupported for the {fam!r} family "
                     f"({args.arch}): cross-attention KV is written by "
                     "the one-time encoder pass, which bypasses the "
                     "quantize-on-insert path")
    if args.paged_attn and not args.block_size:
        ap.error(f"--paged-attn {args.paged_attn} requires a paged arena "
                 "(--block-size); the contiguous slot arena has no block "
                 "tables to attend through")


def resolve_device(ap, args) -> torch.device:
    """``cuda`` unless ``--device cpu``; no card and no explicit CPU
    request is an error, never a silent CPU run."""
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda (the default) but no CUDA device is "
                 "available; pass --device cpu to run the plain CPU path")
    return torch.device(args.device)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--quant", default="none",
                    choices=["none", "fp16", "q8_0", "q3_k_s", "q6_k"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--mode", default="stream", choices=["stream", "batch"])
    ap.add_argument("--chunk-size", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--batch", type=int, default=2,
                    help="batch mode: lockstep batch size")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--block-size", type=int, default=0)
    ap.add_argument("--num-blocks", type=int, default=0)
    ap.add_argument("--paged-attn", default=None, choices=["fused", "ref"])
    ap.add_argument("--spec", default="off",
                    choices=["off", "ngram", "draft"])
    ap.add_argument("--spec-k", type=int, default=None)
    ap.add_argument("--spec-draft-model", default=None)
    ap.add_argument("--kv-quant", default="none", choices=["none", "int8"])
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--shared-prefix", type=int, default=0)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--arrival", default="poisson",
                    choices=["poisson", "back2back"])
    ap.add_argument("--rate", type=float, default=8.0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--max-seq", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--offload-policy", action="store_true")
    ap.add_argument("--host-sampling", action="store_true")
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--trace", default=None)
    return ap


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    validate_args(ap, args)
    device = resolve_device(ap, args)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    if args.mode == "batch":
        dense = build_params(model, args, device, quantize=False)
        out, stats = run_batch(cfg, model, dense, args, device)
        print(f"arch={cfg.name} quant={args.quant} device={device} "
              f"[{args.prompt_len}:{args.gen}] batch={args.batch}")
        for line in batch_lines(stats, args):
            print(f"  {line}")
        print(f"  first generated tokens: {out[0, :8].tolist()}")
        sys.stdout.flush()
        return
    params = build_params(model, args, device)
    engine, report, _ = run_stream(cfg, model, params, args, device)
    arena = engine.arena
    where = (f"paged[{arena.num_blocks}x{arena.block_size} "
             f"attn={engine.paged_attn} kv={arena.kv_quant}]"
             if engine.paged else f"contiguous[{args.slots}x"
             f"{arena.max_seq}]")
    print(f"arch={cfg.name} quant={args.quant} device={device} "
          f"stream={args.requests} reqs ({args.arrival}) slots={args.slots} "
          f"{where} prefill=chunked[{engine.chunk_size}] gen={args.gen}")
    for line in report_lines(engine, report, args.requests):
        print(f"  {line}")
    print(f"  first request tokens: {report.sequences[0].generated[:8]}")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
