"""Serving launcher for the port — continuous-batching request-stream driver.

``repro.launch.serve`` with the same flags, plus ``--device``. Stream
mode replays a stream of requests (Poisson or back-to-back arrivals)
through the serving engine — on the paged arena with ``--block-size``
(bf16 pages, or int8 pages with ``--kv-quant int8``), else on the
contiguous slot arena — with telemetry on, and reports completions, step
time, throughput, the transfer ledger and the bottleneck attribution
(``runtime/telemetry.py``'s ``serve_report_lines``). ``build_stream`` is
the JAX launcher's, so with the same ``--seed`` both serves see the same
requests. Weights are random, made from ``--seed`` on the device.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --quant q8_0 --slots 8 --chunk-size 8 --block-size 16 \
      --num-blocks 256 --requests 16 --prompt-len 128 --gen 32 \
      --arrival back2back [--kv-quant int8]

The paper's system-evaluation serve adds a shared system prompt, the
prefix cache with copy-on-write, the Table-2 offload policy and the
telemetry exports (JSONL metrics, Perfetto/Chrome trace; check them with
``python -m repro_torch.runtime.telemetry validate FILE...``):

  ... --shared-prefix 256 --prefix-cache --offload-policy \
      --metrics-out build/serve_q8_0.jsonl --trace build/serve_q8_0.json

Speculative decoding (propose k tokens per decoding slot, verify them in
ONE unified step): ``--spec ngram`` is the model-free prompt-lookup
proposer; ``--spec draft`` runs a small draft model over its own
contiguous arena, with its own ledger account (weights from ``--seed`` +
17, quantized with the serve's recipe). The report's speculative line
gives the accept rate, the rolled-back tokens and steps per token:

  ... --spec ngram --spec-k 4 [--kv-quant int8]
  ... --arch qwen3-1.7b --spec draft --spec-draft-model qwen3-0.6b

Batch mode (the lockstep ``Engine`` on the contiguous arena, kept for the
paper's fixed [in:out] workload grid):

  PYTHONPATH=src python -m repro_torch.launch.serve --mode batch \
      --quant q8_0 --prompt-len 128 --gen 32 --batch 8

``--arch`` takes the ported configs: qwen3-0.6b/1.7b/8b, the MoE
models granite-moe-3b-a800m and deepseek-v3-671b (MLA; its 61 layers at
full width do not fit one card: ``--reduced`` for the CPU), and the
recurrent families mamba2-1.3b (SSD) and jamba-v0.1-52b (Mamba +
attention + MoE; its 32 layers at full width do not fit one card either),
which refuse ``--spec``, ``--prefix-cache`` and ``--kv-quant``, and the
conditioned families whisper-small (encoder-decoder, zero stub frames)
and qwen2-vl-2b (M-RoPE, zero stub vision embeddings), which refuse
``--prefix-cache`` (whisper also ``--kv-quant``).

Serving meshes (``--dp D --tp T``, stream mode): the launcher spawns
D*T ranks (``launch/mesh.py``; under ``torchrun`` it joins the ranks it
is given instead), each serving the same stream over a ('data',
'model') mesh — slots in contiguous blocks over 'data', heads, vocab and
weight out-features over 'model' — with tokens identical to one device.
Rank 0 prints the report (with the mesh line: backend, devices,
collectives) and writes the exports. ``--ranks-per-device K`` lets K
ranks share one device (the CPU counts as one), over gloo:

  PYTHONPATH=src python -m repro_torch.launch.serve --reduced \
      --device cpu --slots 4 --dp 2 --tp 2 --ranks-per-device 4 \
      --block-size 8 --quant q8_0

The card is the default device. Without one the launcher exits with an
error unless ``--device cpu`` asks for the plain CPU path explicitly.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs.registry import family_of, get_config
from repro_torch.core import convert
from repro_torch.core.imax_model import asic_28nm
from repro_torch.core.offload import OffloadPolicy, model_kernel_calls
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ops import MATMUL_KERNELS
from repro_torch.kernels.paged_attention import paged_decode_attention
from repro_torch.launch import mesh as meshes
from repro_torch.models.api import build_model
from repro_torch.runtime.engine import Engine, ServingEngine
from repro_torch.runtime.request import Request, SamplingParams
from repro_torch.runtime.telemetry import serve_report_lines

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


def make_extras(cfg, batch: int, device="cpu"):
    """Frontend stubs for ``batch`` requests, bf16 zeros on ``device``:
    the vlm family's vision embeddings (batch, vision_tokens, d), the
    encdec family's encoder frames (batch, encoder_seq_len, d); no entry
    for the other families."""
    extras = {}
    if cfg.family == "vlm":
        extras["vision_embeds"] = torch.zeros(
            (batch, cfg.vision_tokens, cfg.d_model), dtype=torch.bfloat16,
            device=device)
    if cfg.family == "encdec":
        extras["frames"] = torch.zeros(
            (batch, cfg.encoder_seq_len, cfg.d_model), dtype=torch.bfloat16,
            device=device)
    return extras


def build_stream(cfg, args, rng: np.random.RandomState, device="cpu"):
    """Request stream with randomized lengths + Poisson/back-to-back
    arrival offsets (frontend stubs made on ``device``)."""
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
        extras = make_extras(cfg, 1, device)
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


def offload_decisions(cfg, quant: str, seq: int, n_out: int):
    """Static offload table (paper Table 2) applied to the live ledger so
    host-resident kernels charge no DMA bytes."""
    q = quant if quant != "none" else "fp16"
    prefill = model_kernel_calls(cfg, q, seq, 1, decode=False)
    decode = [dataclasses.replace(c, count=c.count * n_out)
              for c in model_kernel_calls(cfg, q, seq, 1, decode=True)]
    by_name = {}
    for c in prefill + decode:
        by_name.setdefault(c.name, []).append(c)
    return OffloadPolicy(asic_28nm()).decide_table(prefill, by_name)


def build_params(model, args, device, quantize: bool = True, mesh=None):
    """Seeded random weights at the config's widths, made on ``device``
    as the JAX launcher does (bf16 init, then — unless ``quantize`` is
    False — the quantization stage). ``mesh``: a serving mesh whose
    rank keeps only its 'model' shard (``convert.shard_params``); the
    full weights are freed before this returns."""
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = model.init(gen)
    if quantize and args.quant != "none":
        params = convert.quantize_params(params, args.quant)
    if mesh is not None:
        params = convert.shard_params(params, mesh)
        if device.type == "cuda":
            torch.cuda.empty_cache()    # hand the card back to its peers
    return params


def build_draft(args, device, mesh=None):
    """Draft model + params for ``--spec draft``: ``--reduced`` follows
    the target's, the weights come from ``--seed`` + 17, are made on
    ``device`` and are quantized with the serve's recipe (so the draft's
    ledger account charges the same recipe); ``mesh``: as
    ``build_params``."""
    dcfg = get_config(args.spec_draft_model)
    if args.reduced:
        dcfg = dcfg.reduced()
    dmodel = build_model(dcfg)
    draft_args = argparse.Namespace(seed=args.seed + 17, quant=args.quant)
    return dmodel, build_params(dmodel, draft_args, device, mesh=mesh)


def run_stream(cfg, model, params, args, device, draft=None, mesh=None):
    """Serve the stream with telemetry on and write the exports that
    ``--metrics-out``/``--trace`` ask for (rank 0 of a mesh only);
    returns (engine, report, requests). ``draft``: the (model, params)
    of ``--spec draft``'s draft, else ``build_draft`` makes them.
    ``mesh``: the rank's ``ServingMesh`` (params sharded or whole)."""
    rng = np.random.RandomState(args.seed)
    reqs = build_stream(cfg, args, rng, device)
    max_seq = args.max_seq or (args.shared_prefix + args.prompt_len
                               + args.gen)
    decisions = offload_decisions(cfg, args.quant, args.prompt_len,
                                  args.gen) if args.offload_policy else None
    if args.spec == "draft" and draft is None:
        draft = build_draft(args, device, mesh)
    draft_model, draft_params = draft or (None, None)
    engine = ServingEngine(
        model, params, quant=args.quant, num_slots=args.slots,
        max_seq=max_seq, offload_decisions=decisions,
        chunk_size=args.chunk_size,
        block_size=args.block_size or None,
        num_blocks=args.num_blocks or None,
        paged_attn=args.paged_attn or "fused",
        spec=args.spec, spec_k=args.spec_k or 4,
        spec_draft_model=draft_model, spec_draft_params=draft_params,
        prefix_cache=args.prefix_cache, kv_quant=args.kv_quant,
        host_sampling=args.host_sampling, telemetry=True, device=device,
        mesh=mesh)
    report = engine.serve(reqs, seed=args.seed)
    if mesh is None or not any(mesh.coords.values()):
        write_exports(report.timeline, args)
    return engine, report, reqs


def write_exports(timeline, args) -> None:
    """Write the JSONL metrics (``--metrics-out``) and the Chrome/Perfetto
    trace (``--trace``) of a served stream's timeline."""
    for path, write in ((args.metrics_out, timeline.write_metrics_jsonl),
                        (args.trace, timeline.write_chrome_trace)):
        if path:
            Path(path).parent.mkdir(parents=True, exist_ok=True)
            write(path)


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
    extras = make_extras(cfg, args.batch, device)
    return engine.generate(prompt, args.gen, temperature=args.temperature,
                           seed=args.seed, extras=extras or None)


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


def validate_args(ap, args) -> None:
    """Fail fast on flags that do not combine — never silently measure a
    different configuration. The combination checks are the JAX
    launcher's, message for message; the mesh's device check counts
    ``--ranks-per-device`` ranks a device."""
    if args.num_blocks and not args.block_size:
        ap.error("--num-blocks requires --block-size (paged arena)")
    if args.prefix_cache:
        if not args.block_size:
            ap.error("--prefix-cache requires the paged arena "
                     "(--block-size): sharing works at block granularity")
        if args.mode != "stream":
            ap.error("--prefix-cache requires --mode stream")
        fam = family_of(args.arch)
        if fam in ("ssm", "hybrid"):
            ap.error(f"--prefix-cache is unsupported for the {fam!r} "
                     f"family ({args.arch}): recurrent state is not "
                     "addressable by token-block chains")
        if fam in ("encdec", "vlm"):
            ap.error(f"--prefix-cache is unsupported for the {fam!r} "
                     f"family ({args.arch}): prompt KV depends on "
                     "per-request encoder/vision conditioning, so equal "
                     "token prefixes do not imply equal pages")
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
    if args.shared_prefix < 0:
        ap.error("--shared-prefix must be >= 0")
    # getattr: callers may validate partial Namespaces without the
    # export flags.
    if (getattr(args, "metrics_out", None) or getattr(args, "trace", None)) \
            and args.mode != "stream":
        ap.error("--metrics-out/--trace require --mode stream (telemetry "
                 "instruments the continuous-batching step loop)")
    if args.paged_attn and not args.block_size:
        ap.error(f"--paged-attn {args.paged_attn} requires a paged arena "
                 "(--block-size); the contiguous slot arena has no block "
                 "tables to attend through")
    if args.spec == "off":
        if args.spec_k is not None:
            ap.error("--spec-k requires --spec {ngram,draft}")
        if args.spec_draft_model:
            ap.error("--spec-draft-model requires --spec draft")
    if args.spec == "draft":
        if not args.spec_draft_model:
            ap.error("--spec draft requires --spec-draft-model (e.g. "
                     "qwen3-0.6b); use --spec ngram for model-free "
                     "drafting")
        dfam = family_of(args.spec_draft_model)
        if dfam in ("ssm", "hybrid", "encdec", "vlm"):
            ap.error(f"--spec-draft-model {args.spec_draft_model} "
                     f"({dfam!r} family) cannot draft: recurrent state "
                     "cannot roll back, and encoder/vision conditioning "
                     "cannot be supplied to a draft pass — use a "
                     "decoder-only draft model")
    if args.spec == "ngram" and args.spec_draft_model:
        ap.error("--spec-draft-model is only used by --spec draft")
    if args.spec != "off":
        if args.mode != "stream":
            ap.error("--spec requires --mode stream (the lockstep batch "
                     "path has no proposer/verifier)")
        fam = family_of(args.arch)
        if fam in ("ssm", "hybrid"):
            ap.error(f"--spec is unsupported for the {fam!r} family "
                     f"({args.arch}): rejected tokens advance the "
                     "recurrent state, which cannot be rolled back")
        if args.spec_k is not None and args.spec_k < 1:
            ap.error(f"--spec-k must be >= 1, got {args.spec_k}")
        if args.chunk_size < 2:
            ap.error("--spec needs --chunk-size >= 2 (one committed-token "
                     "lane plus at least one proposal lane)")
    rpd = getattr(args, "ranks_per_device", 1)
    if rpd < 1:
        ap.error(f"--ranks-per-device must be >= 1, got {rpd}")
    if args.dp < 1 or args.tp < 1:
        ap.error(f"--dp/--tp must be >= 1, got dp={args.dp} tp={args.tp}")
    if args.dp * args.tp > 1:
        if args.mode != "stream":
            ap.error("--dp/--tp require --mode stream (the lockstep batch "
                     "path builds unsharded engines)")
        dev = getattr(args, "device", "cuda")
        cap = meshes.device_capacity(dev, rpd)
        if args.dp * args.tp > cap:
            ap.error(f"mesh dp={args.dp} x tp={args.tp} needs "
                     f"{args.dp * args.tp} devices but only {cap} "
                     f"visible ({cap // rpd} {dev} device(s) x "
                     f"--ranks-per-device {rpd}; pass --ranks-per-device N "
                     "to let N ranks share a device)")
        mcfg = get_config(args.arch)
        if args.reduced:
            mcfg = mcfg.reduced()
        _check_mesh_divisibility(ap, mcfg, args.arch, args)
        if args.dp > 1 and args.slots % args.dp:
            ap.error(f"--slots {args.slots} not divisible by --dp "
                     f"{args.dp}: each 'data' replica must own an equal "
                     "contiguous slot block")
        if args.spec == "draft" and args.tp > 1:
            dcfg = get_config(args.spec_draft_model)
            if args.reduced:
                dcfg = dcfg.reduced()
            _check_mesh_divisibility(ap, dcfg, args.spec_draft_model,
                                     args, role="draft model ")


def _check_mesh_divisibility(ap, cfg, arch: str, args,
                             role: str = "") -> None:
    """Refuse a tensor-parallel degree the architecture cannot shard
    evenly — an uneven head split would need padded shards and break
    token identity with the single-device run."""
    for what, n in (("kv-heads", cfg.num_kv_heads),
                    ("attention heads", cfg.num_heads),
                    ("vocab", cfg.vocab_size)):
        if n % args.tp:
            ap.error(f"--tp {args.tp} does not divide {role}{arch}'s "
                     f"{n} {what}; pick a tp that divides every "
                     "sharded axis (heads, kv-heads, vocab)")


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
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel degree: slots (and the paged "
                         "arena's pages) over the mesh 'data' axis; "
                         "requires --slots divisible by dp")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: heads, kv-heads, vocab "
                         "and weight out-features over the mesh 'model' "
                         "axis; requires each divisible by tp")
    ap.add_argument("--ranks-per-device", type=int, default=1,
                    help="mesh ranks that share one device (gloo); the "
                         "CPU counts as one device")
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
    if args.dp * args.tp > 1:
        if meshes.joined_from_env():
            ctx = meshes.init_rank(
                int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                device_type=device.type,
                ranks_per_device=args.ranks_per_device,
                init_method="env://")
            try:
                if device.type == "cuda":
                    meshes.load_kernels(ctx)
                serve_rank(ctx, args)
            finally:
                meshes.teardown()
            return
        world = args.dp * args.tp
        threads = max(1, (os.cpu_count() or 1) // world) \
            if device.type == "cpu" else 0
        meshes.spawn(serve_rank, world, (args,), device_type=device.type,
                     ranks_per_device=args.ranks_per_device,
                     threads=threads)
        return
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
    print_stream(cfg, engine, report, args, device, launch_counts())


def serve_rank(ctx, args) -> None:
    """One rank of a ``--dp/--tp`` serve: build the mesh, this rank's
    weight shards (ranks sharing a card in turn) and serve; rank 0
    prints the report with every rank's launch counts."""
    mesh = meshes.make_host_mesh(args.dp, args.tp, device=ctx.device,
                                 ranks_per_device=ctx.ranks_per_device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = mesh.serialized(build_params, model, args, ctx.device, True,
                             mesh)
    draft = mesh.serialized(build_draft, args, ctx.device, mesh) \
        if args.spec == "draft" else None
    reset_launches()
    engine, report, _ = run_stream(cfg, model, params, args, ctx.device,
                                   draft=draft, mesh=mesh)
    # Every rank's counts, in rank order (row-major over the mesh).
    every = [c for row in mesh.all_gather_objects(
        mesh.all_gather_objects(launch_counts(), "model"), "data")
        for c in row]
    if ctx.rank == 0:
        print_stream(cfg, engine, report, args, ctx.device, every)


def print_stream(cfg, engine, report, args, device, launches) -> None:
    """The stream report: the header, ``serve_report_lines`` (with the
    mesh line under a mesh; ``launches``: the launch counts, a list of
    one dict per rank under a mesh) and the first request's tokens."""
    arena = engine.arena
    where = (f"paged[{arena.num_blocks}x{arena.block_size} "
             f"attn={engine.paged_attn} kv={arena.kv_quant}]"
             if engine.paged else f"contiguous[{args.slots}x"
             f"{arena.max_seq}]")
    print(f"arch={cfg.name} quant={args.quant} device={device} "
          f"stream={args.requests} reqs ({args.arrival}) slots={args.slots} "
          f"{where} prefill=chunked[{engine.chunk_size}] gen={args.gen}")
    for line in serve_report_lines(engine, report, args.requests,
                                   launches=launches):
        print(f"  {line}")
    print(f"  first request tokens: {report.sequences[0].generated[:8]}")
    if args.metrics_out:
        print(f"  metrics: wrote {len(report.timeline.events)} step "
              f"events to {args.metrics_out}")
    if args.trace:
        print(f"  trace: wrote Perfetto/Chrome trace to {args.trace} "
              f"(open at https://ui.perfetto.dev)")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
