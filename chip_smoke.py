#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, one line each (every failure exits non-zero):

1. card   — ``nvidia-smi`` name and power limit;
2. build  — compiles every ``src/repro_torch/csrc/*.cu`` with nvcc for
            sm_90a into ``build/`` (one nvcc per source, in parallel);
3. kernels — each hand-written kernel (matmul_q8_0, matmul_fp16,
            matmul_q6_k, matmul_q3_k and its approx_cvt53 form,
            paged_decode_attention in its bf16, int8, MLA and MLA-int8
            forms, flash_attention) against its plain PyTorch version on
            the card at the main path's shapes (and ragged ones,
            qwen3-8b's and granite-moe's widths, and deepseek-v3's MLA
            decode and prefill widths), with the tolerance stated, its
            time, the plain version's time, one library call's time (a
            yardstick only: the port never calls it) and the least time
            the card could take for the same work; the matmuls also at
            the prefill's M = 4,096 (per prefill beside per step); the
            MLA forms run the tensor-core kernel (two launches
            bit-identical, no CUDA-core launch), also on a 4,096-page
            table;
4. serve  — ``repro_torch.launch.serve`` at the full width of
            qwen3-0.6b (seeded random weights made on the card): the
            paged stream once for each of the paper's weight recipes
            (q8_0, fp16, q6_k, q3_k_s) and once on int8 KV pages
            (``--kv-quant int8``), the lockstep batch (``--mode batch``,
            contiguous arena), and ``model.prefill`` of 8 x 512 tokens,
            asserting that every quantized product and every attention
            of each run went through the kernels (exact launches per step
            and per prefill); then the MoE models at full width (q8_0):
            deepseek-v3 cut to 4 layers (3 dense MLA layers and one MLA +
            MoE layer) on bf16 and int8 pages and its ``model.prefill``
            of 8 x 512 tokens, and granite-moe at its full 32 layers, with
            the same stream and exact launches; from here on every
            attention and matmul launch's route is counted (by dtype):
            a serve or prefill that reaches a CUDA-core (f32) kernel
            fails, as does any model-path attention launch that does;
   prefix — the paper's system-evaluation serve: the same stream behind
            a 256-token shared system prompt with ``--prefix-cache
            --offload-policy --metrics-out --trace`` (telemetry on), for
            qwen3-0.6b on bf16 and int8 pages and deepseek-v3 (4 layers)
            on bf16 pages, each beside the same stream without the
            cache, and the bf16 streams once more on the warm cache:
            cold prefix hits of 256 tokens each, a hit for every warm
            admission, exact launches per
            step (the recipe's), the timeline closed against the ledger,
            both exports valid, and tokens equal to the unshared run's
            up to near-ties (the unshared run's logit rows are the
            reference); the copy-on-write split itself on full-width
            arenas of bf16, int8 and MLA pages (the copy equals its
            source, the sibling's pages keep every bit);
   spec   — speculative decoding: the stream with ``--spec ngram
            --spec-k 4`` on bf16 and int8 pages and for deepseek-v3 (4
            layers), each beside the same stream without it, then
            qwen3-1.7b drafted by qwen3-0.6b (``--spec draft``) beside
            qwen3-1.7b alone, a self-draft of qwen3-0.6b, and a spec
            serve behind the shared system prompt with the prefix cache:
            proposals accepted and rolled back, exact launches per verify
            step and per draft pass, every block returned, tokens equal
            to the plain run's up to near-ties (deepseek-v3's MoE
            capacity dispatch couples a token to its step's rows: its
            partings beyond the rule are printed), the self-draft
            accepting at least 90 %, every rollback leaving shared and
            cached pages bit-equal; and the rollback itself on
            full-width arenas of bf16, int8 and MLA pages (bit-identical
            to never inserting the rejected rows);
5. checks — per recipe, one full-width decode step (depth cut to 2
            layers) against the plain CPU path, and a shorter serve under
            torch.profiler; for q8_0 also a 2-layer prefill and a 2-layer
            decode step on int8 pages against the CPU path; deepseek-v3
            cut to its 2 dense MLA layers (bf16 and int8 pages) and
            granite-moe cut to 2 MoE layers against the CPU path, the
            deepseek-v3 MoE layer's device time and transient memory,
            and a profiled serve of each;
6. the ``kernels`` JSON line, then the device JSON line, last.

It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T0 = time.perf_counter()

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and
# bf16 tensor-core flop/s. The least time for a piece of work is the
# larger of its bytes over the first and its flops over the second.
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12

SERVE_ARGS = ["--arch", "qwen3-0.6b", "--slots", "8", "--chunk-size", "8",
              "--block-size", "16", "--num-blocks", "256", "--requests",
              "16", "--prompt-len", "128", "--gen", "32", "--arrival",
              "back2back"]
# (name, N, K) of the linear layers of qwen3-0.6b, each launched once per
# layer (28 per unified step), and its tied lm_head (once per step).
LINEARS = [("q", 2048, 1024), ("k", 1024, 1024), ("v", 1024, 1024),
           ("o", 1024, 2048), ("gate", 3072, 1024), ("up", 3072, 1024),
           ("down", 1024, 3072)]
LM_HEAD = ("lm_head", 151936, 1024)
# kernel -> (format, its TPU kernel, whether its own recipe runs the
# lm_head through it, ragged K). The per-step figures are those of the
# recipe named after the format (q3_k: q3_k_s); q6_k also carries the
# q3_k_s lm_head.
MATMULS = {
    "matmul_q8_0": ("q8_0", "src/repro/kernels/q8_0_matmul.py:36", True, 96),
    "matmul_fp16": ("fp16", "src/repro/kernels/fp16_matmul.py:33", False,
                    100),
    "matmul_q6_k": ("q6_k", "src/repro/kernels/q6_k_matmul.py:43", True,
                    256),
    "matmul_q3_k": ("q3_k", "src/repro/kernels/q3_k_matmul.py:47", False,
                    256),
    # B6': the same kernel with the paper's CVT53 scales (sc & ~1), which
    # no serving path runs: checked and timed at the q3_k_s recipe's
    # shapes, launched on no main path (its row says so).
    "matmul_q3_k_approx_cvt53": ("q3_k",
                                 "src/repro/kernels/q3_k_matmul.py:33",
                                 False, 256),
}
OFF_MAIN_PATH = {"matmul_q3_k_approx_cvt53"}
# qwen3-8b's K (d_model, d_ff) at its d_model N: checked, not timed.
WIDE = [("qwen3-8b q/o", 4096, 4096), ("qwen3-8b down", 4096, 12288)]
# Full-width attention shapes of the flash kernel's checks: (label, B, Sq,
# Skv, H, Hkv, D, causal, q_offset, dtype name). The first is the timed
# one: qwen3-0.6b's prefill of 8 x 512 tokens.
FLASH_CASES = [
    ("qwen3-0.6b prefill", 8, 512, 512, 16, 8, 128, True, 0, "bfloat16"),
    ("ragged S=500", 8, 500, 500, 16, 8, 128, True, 0, "bfloat16"),
    ("non-causal", 8, 512, 512, 16, 8, 128, False, 0, "bfloat16"),
    ("q_offset 384", 8, 128, 512, 16, 8, 128, True, 384, "bfloat16"),
    ("f32", 8, 512, 512, 16, 8, 128, True, 0, "float32"),
    ("qwen3-8b", 1, 2048, 2048, 32, 8, 128, True, 0, "bfloat16"),
]
PREFILL_SHAPE = (8, 512)                        # batch x tokens
# run -> {kernel: launches per unified step}
RECIPE_LAUNCHES = {
    "q8_0": {"matmul_q8_0": 197, "paged_decode_attention": 28},
    "fp16": {"matmul_fp16": 196, "paged_decode_attention": 28},
    "q6_k": {"matmul_q6_k": 197, "paged_decode_attention": 28},
    "q3_k_s": {"matmul_q3_k": 196, "matmul_q6_k": 1,
               "paged_decode_attention": 28},
}
INT8_LAUNCHES = {"matmul_q8_0": 197, "paged_decode_attention_int8": 28}
BATCH_LAUNCHES = {"matmul_q8_0": 197}           # contiguous arena
PREFILL_LAUNCHES = {"matmul_q8_0": 197, "flash_attention": 28}
M_STEP = 64                                     # slots x chunk
M_PREFILL = PREFILL_SHAPE[0] * PREFILL_SHAPE[1]
# The MoE models: the same stream at full width (q8_0). deepseek-v3 is cut
# to 4 layers (its 3 dense MLA layers and one MLA + MoE layer; 61 do not
# fit one card), granite-moe runs all 32.
DEEPSEEK_LAYERS = 4
DEEPSEEK_ARGS = ["--arch", "deepseek-v3-671b"] + SERVE_ARGS[2:]
GRANITE_ARGS = ["--arch", "granite-moe-3b-a800m"] + SERVE_ARGS[2:]
# Per step: 4 MLA layers x 4 linears (q_a, q_b, kv_a, o; kv_b is folded
# into the attention), 3 dense SwiGLUs x 3, the shared expert's 3, the
# lm_head; the prefill adds kv_b per layer.
DEEPSEEK_LAUNCHES = {"matmul_q8_0": 29, "paged_decode_attention_mla": 4}
DEEPSEEK_INT8_LAUNCHES = {"matmul_q8_0": 29,
                          "paged_decode_attention_mla_int8": 4}
DEEPSEEK_PREFILL_LAUNCHES = {"matmul_q8_0": 33, "flash_attention": 4}
GRANITE_LAUNCHES = {"matmul_q8_0": 129, "paged_decode_attention": 32}
# The prefix phase: the stream behind a shared system prompt of 16 full
# blocks, with the Table-2 offload policy; the shared run adds the cache
# and the telemetry exports. Each hit maps the whole system prompt.
SHARED_PREFIX = 256
PREFIX_FLAGS = ["--shared-prefix", str(SHARED_PREFIX), "--offload-policy"]
# The near-tie rule (ROADMAP's North star): a request's tail may differ
# from the reference run's only from a position where the reference's
# top-2 logit gap is below this share of its max |logit|.
LOGIT_TOL = 2.5e-2
# B9 at the deepseek serve's decode shape: (B, C, H, rank, rope, bs, MB,
# physical blocks), and a ragged one (rows not a multiple of the 64-row
# tile, chunk 5, block 64).
MLA_CASE = (8, 8, 128, 512, 64, 16, 10, 256)
MLA_RAGGED = (3, 5, 20, 512, 64, 64, 3, 12)
# deepseek-v3's MLA prefill attention: (B, S, H, D, Dv) bf16, causal.
FLASH_MLA = (8, 512, 128, 192, 128)
# The spec phase: the stream above with prompt-lookup speculation (k = 4),
# and qwen3-1.7b drafted by qwen3-0.6b (the JAX launcher's draft example),
# each beside the same stream without it. Every spec step is a verify
# step, so the recipes' launches per step hold; a draft pass launches the
# draft's 197 linears (qwen3-0.6b's, like qwen3-1.7b's: 28 layers x 7 and
# the lm_head) and no attention kernel (its arena is contiguous).
SPEC_FLAGS = ["--spec", "ngram", "--spec-k", "4"]
DRAFT_ARGS = ["--arch", "qwen3-1.7b"] + SERVE_ARGS[2:]
DRAFT_FLAGS = ["--spec", "draft", "--spec-draft-model", "qwen3-0.6b"]
DRAFT_PASS_LAUNCHES = {"matmul_q8_0": 197}


def within_one_ulp(torch, out, ref32, rtol: float, atol: float) -> bool:
    """bf16 ``out`` is an f32 result rounded once: within one bf16 ulp
    (of the element's own magnitude) of a value that lies within the f32
    tolerance (``rtol``, ``atol``: the kernel's summation order) of the
    plain version's f32 result ``ref32``."""
    r = ref32.float()
    ulp = torch.ldexp(torch.ones_like(r), torch.frexp(r).exponent - 8)
    ulp = torch.where(r == 0, torch.zeros_like(r), ulp)
    return bool(((out.float() - r).abs()
                 <= ulp + atol + rtol * r.abs()).all())


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def bound(nbytes: float, flops: float, peak: float = BF16_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BPS, flops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_ms(torch, fns, iters: int) -> float:
    """Device ms per call: ``iters`` calls, cycling through ``fns``
    (distinct operand copies, so weights stream from HBM and not from the
    50 MB L2), captured in one CUDA graph and replayed, so the host's
    launch overhead does not enter the figure."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns[:2]:
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (3 * iters)


def check_matmul(torch, dev, name):
    """One matmul kernel against its plain version at the serving shapes,
    a ragged shape and qwen3-8b's K; timed at the serving shapes."""
    from repro_torch.core.quant import dequant, pack
    from repro_torch.kernels.ops import MATMUL_KERNELS
    from repro_torch.kernels.ref import matmul_ref
    fmt, replaces, lm_head, ragged_k = MATMULS[name]
    wrapper, layout = MATMUL_KERNELS[fmt]
    kw = {"approx_cvt53": True} if name in OFF_MAIN_PATH else {}
    dequantize = (lambda p: dequant.dequantize(p, fmt, **kw)) if kw \
        else dequant.DEQUANTIZERS[fmt]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, flops=0.0)
    worst = 0.0
    shapes = [(s, M_STEP, n, k, 28) for s, n, k in LINEARS]
    if lm_head:
        shapes.append((LM_HEAD[0], M_STEP, LM_HEAD[1], LM_HEAD[2], 1))
    shapes += [("ragged", 3, 1000, ragged_k, 0)] + [
        (s, M_STEP, n, k, 0) for s, n, k in WIDE]
    per_step = 0
    for shape, m, n, k, count in shapes:
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn((n, k), generator=gen, device=dev) * 0.02
        planes = pack.quantize(w, fmt)
        del w
        args = [planes[p] for p in layout]
        y = wrapper(x, *args, **kw)
        ref = matmul_ref(x, planes, fmt, **kw)
        # The serving layers ask for bf16: the kernel's own f32 result,
        # rounded once.
        y16 = wrapper(x, *args, out_dtype=torch.bfloat16, **kw)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        # Same products, another summation order: the repo's 2e-5
        # (tests/test_kernels.py) relative to the output's scale.
        tol = 2e-5 * max(1.0, float(ref.abs().max()))
        if not bool(torch.isfinite(y).all()) or err > tol \
                or not torch.equal(y16, y.to(torch.bfloat16)):
            fail(f"{name} {shape} ({m}x{n}x{k}): max_abs_err {err:.3e} "
                 f"> {tol:.3e}, or the bf16 output is not the f32 result "
                 "rounded")
        worst = max(worst, err)
        del y, y16, ref
        if not count:
            print(f"kernel {name} {shape} M={m} N={n} K={k}: max_abs_err "
                  f"{err:.3e} (tol {tol:.3e}), bf16 out = f32 out rounded",
                  flush=True)
            continue
        wbytes = sum(p.numel() * p.element_size() for p in planes.values())
        copies = max(1, min(48, math.ceil(150e6 / wbytes)))
        cps = [planes] + [{k2: v.clone() for k2, v in planes.items()}
                          for _ in range(copies - 1)]
        wf = [dequantize(p) for p in cps]
        xf = x.float()
        iters = 20 if n * k > 1e8 else 100
        launches0 = wrapper.launches
        bf16 = torch.bfloat16               # the serving layers' form
        t_k = time_ms(torch, [lambda p=p: wrapper(
            x, *[p[q] for q in layout], out_dtype=bf16, **kw) for p in cps],
            iters)
        wrapper.launches = launches0         # timing launches do not count
        t_p = time_ms(torch, [lambda p=p: matmul_ref(x, p, fmt, **kw).to(
            bf16) for p in cps], iters)
        t_l = time_ms(torch, [lambda wq=wq: torch.matmul(xf, wq.T)
                              for wq in wf], iters)
        nbytes = wbytes + x.numel() * 2 + m * n * 2
        flops = 2.0 * m * n * k
        b_ms, b_by = bound(nbytes, flops)
        print(f"kernel {name} {shape} M={m} N={n} K={k}: max_abs_err "
              f"{err:.3e} (tol {tol:.3e}), bf16 out = f32 out rounded | "
              f"bf16-out kernel {t_k:.4f} ms | plain "
              f"{t_p:.4f} ms | library(torch.matmul f32, pre-dequantized) "
              f"{t_l:.4f} ms | bound {b_ms:.4f} ms ({b_by})", flush=True)
        for key, v in (("ms", t_k), ("plain_ms", t_p), ("library_ms", t_l),
                       ("bytes", nbytes), ("flops", flops)):
            totals[key] += count * v
        per_step += count
        del cps, wf
    b_ms, b_by = bound(totals["bytes"], totals["flops"])
    prefill, err = time_matmul_prefill(torch, dev, name)
    worst = max(worst, err)
    print(f"kernel {name} per unified step of the {fmt} recipe ({per_step} "
          f"launches at M={M_STEP}): kernel {totals['ms']:.4f} ms | plain "
          f"{totals['plain_ms']:.4f} ms | library {totals['library_ms']:.4f} "
          f"ms | bound {b_ms:.4f} ms ({b_by}) || per {PREFILL_SHAPE[0]} x "
          f"{PREFILL_SHAPE[1]} prefill (196 linears at M={M_PREFILL}): kernel "
          f"{prefill['ms']:.3f} ms | plain {prefill['plain_ms']:.3f} ms | "
          f"library {prefill['library_ms']:.3f} ms | bound "
          f"{prefill['bound_ms']:.3f} ms ({prefill['bound_by']})", flush=True)
    row = dict(name=name, route="cuda",
               source=f"src/repro_torch/csrc/{fmt}_matmul.cu",
               replaces=replaces, max_abs_err=worst, ms=totals["ms"],
               plain_ms=totals["plain_ms"], bound_ms=b_ms, bound_by=b_by,
               library_ms=totals["library_ms"], prefill=prefill)
    if name in OFF_MAIN_PATH:
        row["main_path"] = False
    return row


def time_matmul_prefill(torch, dev, name):
    """The seven linears of qwen3-0.6b at the prefill's M = 8 x 512
    (each 28 times per prefill): the kernel against its plain version
    (2e-5 of the output's scale, bf16 output the f32 one rounded), timed
    beside the plain version and cuBLAS f32, each with its bound (the
    flops bound it here). Returns the per-prefill totals and the worst
    error."""
    from repro_torch.core.quant import dequant, pack
    from repro_torch.kernels.ops import MATMUL_KERNELS
    from repro_torch.kernels.ref import matmul_ref
    fmt = MATMULS[name][0]
    wrapper, layout = MATMUL_KERNELS[fmt]
    kw = {"approx_cvt53": True} if name in OFF_MAIN_PATH else {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, flops=0.0)
    worst = 0.0
    for shape, n, k in LINEARS:
        m = M_PREFILL
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        planes = pack.quantize(
            torch.randn((n, k), generator=gen, device=dev) * 0.02, fmt)
        args = [planes[p] for p in layout]
        y = wrapper(x, *args, **kw)
        y16 = wrapper(x, *args, out_dtype=torch.bfloat16, **kw)
        ref = matmul_ref(x, planes, fmt, **kw)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        tol = 2e-5 * max(1.0, float(ref.abs().max()))
        if not bool(torch.isfinite(y).all()) or err > tol \
                or not torch.equal(y16, y.to(torch.bfloat16)):
            fail(f"{name} {shape} ({m}x{n}x{k}): max_abs_err {err:.3e} "
                 f"> {tol:.3e}, or the bf16 output is not the f32 result "
                 "rounded")
        worst = max(worst, err)
        del y, y16, ref
        launches0 = wrapper.launches
        bf16 = torch.bfloat16
        t_k = time_ms(torch, [lambda: wrapper(x, *args, out_dtype=bf16,
                                               **kw)], 10)
        wrapper.launches = launches0
        t_p = time_ms(torch, [lambda: matmul_ref(x, planes, fmt, **kw).to(
            bf16)], 3)
        xf = x.float()
        wf = dequant.dequantize(planes, fmt, **kw) if kw else \
            dequant.DEQUANTIZERS[fmt](planes)
        t_l = time_ms(torch, [lambda: torch.matmul(xf, wf.T)], 5)
        wbytes = sum(p.numel() * p.element_size() for p in planes.values())
        nbytes = wbytes + x.numel() * 2 + m * n * 2
        flops = 2.0 * m * n * k
        b_ms, b_by = bound(nbytes, flops)
        print(f"kernel {name} {shape} M={m} N={n} K={k}: max_abs_err "
              f"{err:.3e} (tol {tol:.3e}), bf16 out = f32 out rounded | "
              f"bf16-out kernel {t_k:.4f} ms ({flops / t_k / 1e9:.1f} "
              f"TFLOP/s) | plain {t_p:.4f} ms | library(torch.matmul f32, "
              f"pre-dequantized) {t_l:.4f} ms | bound {b_ms:.4f} ms ({b_by})",
              flush=True)
        for key, v in (("ms", t_k), ("plain_ms", t_p), ("library_ms", t_l),
                       ("bytes", nbytes), ("flops", flops)):
            tot[key] += 28 * v
        del x, xf, wf, planes, args
    b_ms, b_by = bound(tot.pop("bytes"), tot.pop("flops"))
    torch.cuda.empty_cache()
    return dict(tot, bound_ms=b_ms, bound_by=b_by), worst


def _paged_case(torch, np, dev, dtype, H=16, D=128, MB=16):
    """Full-width paged attention operands: fragmented, permuted and
    partly null tables, mixed lengths, every slot active; qwen3-0.6b's
    heads by default (H = 16, Hkv = 8, D = 128), MB pages of 16 keys a
    slot (the serve's 256-key table by default)."""
    B, C, Hkv, bs = 8, 8, 8, 16
    nb = max(256, B * MB)
    rng = np.random.RandomState(1)
    perm = rng.permutation(nb)
    owned = rng.randint(1, MB + 1, size=B)
    owned[0] = MB
    tables = np.full((B, MB), nb, np.int32)
    pos = np.zeros(B, np.int32)
    lens = rng.randint(1, C + 1, size=B).astype(np.int32)
    for b in range(B):
        tables[b, :owned[b]] = perm[b * MB:b * MB + owned[b]]
        pos[b] = rng.randint(0, owned[b] * bs - lens[b] + 1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    kp = torch.randn((nb + 1, bs, Hkv, D), generator=gen, device=dev)
    vp = torch.randn((nb + 1, bs, Hkv, D), generator=gen, device=dev)
    q = torch.randn((B, C, H, D), generator=gen, device=dev)
    t = lambda a: torch.from_numpy(a).to(dev)     # noqa: E731
    return dict(q=q.to(dtype), kp=kp.to(dtype), vp=vp.to(dtype),
                tables=t(tables), pos=t(pos), lens=t(lens), np_tables=tables,
                np_pos=pos, np_lens=lens, sm=D ** -0.5, bs=bs, MB=MB, nb=nb)


def check_paged_attention(torch, np, dev):
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.ref import paged_attention_ref
    worst = 0.0
    # (dtype, rtol, atol): f32 is the blocked-online vs dense softmax
    # reorder (tests/test_paged_attention_kernel.py FP32_TOL); bf16
    # outputs round an f32 result, so they may differ by one bf16 ulp.
    for dtype, rtol, atol in ((torch.float32, 2e-5, 2e-6),
                              (torch.bfloat16, 2 ** -7, 1e-3)):
        c = _paged_case(torch, np, dev, dtype)
        args = (c["q"], c["kp"], c["vp"], c["tables"], c["pos"])
        out = paged_decode_attention(*args, sm_scale=c["sm"],
                                     lengths=c["lens"])
        ref = paged_attention_ref(*args, sm_scale=c["sm"])
        torch.cuda.synchronize()
        err = 0.0
        for b in range(out.shape[0]):
            n = int(c["np_lens"][b])
            o, r = out[b, :n].float(), ref[b, :n].float()
            if not bool(torch.isfinite(o).all()) or \
                    not torch.allclose(o, r, rtol=rtol, atol=atol):
                fail(f"paged_decode_attention {dtype} slot {b}: max_abs_err "
                     f"{float((o - r).abs().max()):.3e}")
            err = max(err, float((o - r).abs().max()))
        worst = max(worst, err)
        # Every page a slot's walk never reaches (and the null page) full
        # of NaN: the output must not change by one bit.
        live = set()
        for b in range(out.shape[0]):
            last = (int(c["np_pos"][b]) + max(int(c["np_lens"][b]), 1) - 1) \
                // c["bs"]
            live.update(int(p) for p in c["np_tables"][b, :last + 1])
        dead = torch.tensor([p for p in range(c["nb"] + 1) if p not in live],
                            device=dev)
        kp2, vp2 = c["kp"].clone(), c["vp"].clone()
        kp2[dead] = float("nan")
        vp2[dead] = float("nan")
        out2 = paged_decode_attention(c["q"], kp2, vp2, c["tables"],
                                      c["pos"], sm_scale=c["sm"],
                                      lengths=c["lens"])
        torch.cuda.synchronize()
        if not torch.equal(out, out2):
            fail(f"paged_decode_attention {dtype}: NaN in {len(dead)} dead "
                 "pages changed the output")
        print(f"kernel paged_decode_attention {dtype}: max_abs_err {err:.3e} "
              f"(rtol {rtol:g} atol {atol:g}, valid rows) | {len(dead)} dead "
              "pages NaN-filled: output bit-identical", flush=True)
    # Timing at the serving dtype (bf16), the case above.
    B, C, H, D = c["q"].shape
    Hkv = c["kp"].shape[2]
    G, bs = H // Hkv, c["bs"]
    launches0 = paged_decode_attention.launches
    t_k = time_ms(torch, [lambda: paged_decode_attention(
        *args, sm_scale=c["sm"], lengths=c["lens"])], 200)
    paged_decode_attention.launches = launches0
    t_p = time_ms(torch, [lambda: paged_attention_ref(
        *args, sm_scale=c["sm"])], 50)
    # Library yardstick: SDPA over the gathered (B, H, S, D) view with the
    # causal-depth mask, gathered outside the timed call.
    kv = [x[c["tables"].long()].flatten(1, 2).repeat_interleave(G, dim=2)
          .transpose(1, 2).contiguous() for x in (c["kp"], c["vp"])]
    s = kv[0].shape[2]
    depth = c["pos"].long()[:, None] + torch.arange(C, device=dev) + 1
    mask = (torch.arange(s, device=dev)[None, None, :]
            < depth[:, :, None])[:, None]             # (B, 1, C, S)
    qh = c["q"].transpose(1, 2).contiguous()
    t_l = time_ms(torch, [lambda: F.scaled_dot_product_attention(
        qh, kv[0], kv[1], attn_mask=mask, scale=c["sm"])], 200)
    keys = nbytes = flops = 0
    for b in range(B):
        last = (int(c["np_pos"][b]) + max(int(c["np_lens"][b]), 1) - 1) // bs
        keys += (last + 1) * bs
    nbytes = keys * Hkv * D * 2 * 2 + 2 * c["q"].numel() * 2 \
        + c["tables"].numel() * 4 + 2 * B * 4
    flops = keys * Hkv * (C * G) * 4 * D
    b_ms, b_by = bound(nbytes, flops)
    print(f"kernel paged_decode_attention bf16 B={B} C={C} H={H} Hkv={Hkv} "
          f"D={D} bs={bs}: kernel {t_k:.4f} ms | plain {t_p:.4f} ms | "
          f"library(SDPA on gathered view) {t_l:.4f} ms | bound {b_ms:.5f} ms "
          f"({b_by}) | per step x28: kernel {28 * t_k:.4f} ms", flush=True)
    return dict(name="paged_decode_attention", route="cuda",
                source="src/repro_torch/csrc/paged_attention.cu",
                replaces="src/repro/kernels/paged_attention.py:156",
                max_abs_err=worst, ms=28 * t_k, plain_ms=28 * t_p,
                bound_ms=28 * b_ms, bound_by=b_by, library_ms=28 * t_l,
                ms_per_call=t_k, granite=time_paged_granite(torch, np, dev),
                long_table=check_paged_long_table(torch, np, dev))


def check_paged_long_table(torch, np, dev):
    """The GQA form at the serve's widths on a 1024-key table (64 pages of
    16 a slot), where the tensor-core kernel splits a slot's walk (256
    keys a split, up to four) and the last block of a (slot, kv-head)
    merges them: bf16 and int8 pages with bf16 q against the plain
    version, two launches bit-identical, dead pages NaN-filled changing
    no bit. Times the bf16-page call."""
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.ref import paged_attention_ref
    from repro_torch.models.attention import quantize_kv
    c = _paged_case(torch, np, dev, torch.float32, MB=64)
    live, keys = _live_pages(c)
    dead = torch.tensor([p for p in range(c["nb"] + 1) if p not in live],
                        dtype=torch.long, device=dev)
    q = c["q"].to(torch.bfloat16)
    kq, ks = quantize_kv(c["kp"])
    vq, vs = quantize_kv(c["vp"])
    forms = {"bf16": (c["kp"].to(torch.bfloat16), c["vp"].to(torch.bfloat16),
                      {}),
             "int8": (kq, vq, dict(k_scales=ks, v_scales=vs))}
    run = lambda kp, vp, kw: paged_decode_attention(  # noqa: E731
        q, kp, vp, c["tables"], c["pos"], sm_scale=c["sm"],
        lengths=c["lens"], **kw)
    depth = [-(-(int(c["np_pos"][b]) + max(int(c["np_lens"][b]), 1)) // 256)
             for b in range(len(c["np_pos"]))]
    errs = {}
    for form, (kp, vp, kw) in forms.items():
        out, out2 = run(kp, vp, kw), run(kp, vp, kw)
        ref = paged_attention_ref(q.float(), kp, vp, c["tables"], c["pos"],
                                  sm_scale=c["sm"], **kw)            # f32
        kd, vd = kp.clone(), vp.clone()
        kwd = {n: v.clone() for n, v in kw.items()}
        if form == "int8":
            kd[dead], vd[dead] = 127, -127
            for v in kwd.values():
                v[dead] = float("nan")
        else:
            kd[dead], vd[dead] = float("nan"), float("nan")
        out3 = run(kd, vd, kwd)
        torch.cuda.synchronize()
        err = 0.0
        for b in range(out.shape[0]):
            n = int(c["np_lens"][b])
            o, r = out[b, :n], ref[b, :n]
            # bf16 pages: the bf16 check above; int8: check_paged_int8's.
            ok = torch.allclose(o.float(), r, rtol=2 ** -7, atol=1e-3) \
                if form == "bf16" else within_one_ulp(torch, o, r, 2e-5, 2e-6)
            if not bool(torch.isfinite(o.float()).all()) or not ok:
                fail(f"paged_decode_attention {form} pages, 1024-key table, "
                     f"slot {b}: max_abs_err "
                     f"{float((o.float() - r).abs().max()):.3e}")
            err = max(err, float((o.float() - r).abs().max()))
        if not torch.equal(out, out2):
            fail(f"paged_decode_attention {form} pages, 1024-key table: two "
                 "launches differ")
        if not torch.equal(out, out3):
            fail(f"paged_decode_attention {form} pages, 1024-key table: NaN "
                 f"in {len(dead)} dead pages changed the output")
        errs[form] = err
        print(f"kernel paged_decode_attention {form} pages, bf16 q, 1024-key "
              f"table (splits a slot walks: {depth}): max_abs_err {err:.3e} "
              f"| two launches bit-identical | {len(dead)} dead pages "
              "NaN-filled: output bit-identical", flush=True)
    kp, vp, kw = forms["bf16"]
    launches0 = paged_decode_attention.launches
    t_k = time_ms(torch, [lambda: run(kp, vp, kw)], 200)
    paged_decode_attention.launches = launches0
    print(f"kernel paged_decode_attention bf16 1024-key table: kernel "
          f"{t_k:.4f} ms per call ({keys} live keys)", flush=True)
    return dict(max_abs_err=errs, ms_per_call=t_k, splits=depth)


def time_paged_granite(torch, np, dev):
    """The GQA form at granite-moe's decode widths (H = 24, Hkv = 8,
    D = 64: 24 query rows of a kv-head, two 16-row tiles), bf16, against
    the plain version, timed per call and per step (32 layers)."""
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.ref import paged_attention_ref
    c = _paged_case(torch, np, dev, torch.bfloat16, H=24, D=64)
    args = (c["q"], c["kp"], c["vp"], c["tables"], c["pos"])
    out = paged_decode_attention(*args, sm_scale=c["sm"], lengths=c["lens"])
    ref = paged_attention_ref(*args, sm_scale=c["sm"])
    torch.cuda.synchronize()
    err = 0.0
    for b in range(out.shape[0]):
        n = int(c["np_lens"][b])
        o, r = out[b, :n].float(), ref[b, :n].float()
        if not torch.allclose(o, r, rtol=2 ** -7, atol=1e-3):
            fail(f"paged_decode_attention granite widths slot {b}: "
                 f"max_abs_err {float((o - r).abs().max()):.3e}")
        err = max(err, float((o - r).abs().max()))
    launches0 = paged_decode_attention.launches
    t_k = time_ms(torch, [lambda: paged_decode_attention(
        *args, sm_scale=c["sm"], lengths=c["lens"])], 200)
    paged_decode_attention.launches = launches0
    t_p = time_ms(torch, [lambda: paged_attention_ref(
        *args, sm_scale=c["sm"])], 50)
    B, C, H, D = c["q"].shape
    _, keys = _live_pages(c)
    nbytes = keys * 8 * D * 2 * 2 + 2 * c["q"].numel() * 2 \
        + c["tables"].numel() * 4 + 2 * B * 4
    b_ms, b_by = bound(nbytes, keys * 8 * (C * 3) * 4 * D)
    print(f"kernel paged_decode_attention bf16 granite-moe widths B={B} "
          f"C={C} H={H} Hkv=8 D={D}: max_abs_err {err:.3e} (rtol 2^-7 atol "
          f"1e-3) | kernel {t_k:.4f} ms | plain {t_p:.4f} ms | bound "
          f"{b_ms:.5f} ms ({b_by}) | per step x32: kernel {32 * t_k:.4f} "
          "ms", flush=True)
    return dict(ms_per_call=t_k, plain_ms=t_p, bound_ms=b_ms,
                max_abs_err=err)


def _live_pages(c):
    """Page ids some slot's walk reaches in ``_paged_case`` ``c``, and the
    number of keys the walks read."""
    live, keys = set(), 0
    for b in range(len(c["np_pos"])):
        last = (int(c["np_pos"][b]) + max(int(c["np_lens"][b]), 1) - 1) \
            // c["bs"]
        live.update(int(p) for p in c["np_tables"][b, :last + 1])
        keys += (last + 1) * c["bs"]
    return live, keys


def check_paged_int8(torch, np, dev):
    """The int8 form of paged_decode_attention (int8 code pages, fp16
    scale pages) at the main path's decode shapes."""
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.ref import paged_attention_ref
    from repro_torch.models.attention import quantize_kv
    c = _paged_case(torch, np, dev, torch.float32)
    kq, ks = quantize_kv(c["kp"])
    vq, vs = quantize_kv(c["vp"])
    live, keys = _live_pages(c)
    dead = torch.tensor([p for p in range(c["nb"] + 1) if p not in live],
                        dtype=torch.long, device=dev)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        q = c["q"].to(dtype)
        args = (q, kq, vq, c["tables"], c["pos"])
        kw = dict(sm_scale=c["sm"], k_scales=ks, v_scales=vs)
        out = paged_decode_attention(*args, lengths=c["lens"], **kw)
        ref = paged_attention_ref(q.float(), *args[1:], **kw)   # f32
        torch.cuda.synchronize()
        err = 0.0
        for b in range(out.shape[0]):
            n = int(c["np_lens"][b])
            o, r = out[b, :n], ref[b, :n]
            # FP32_TOL of tests/test_paged_attention_kernel.py; a bf16
            # output is that f32 result rounded once (one bf16 ulp more).
            ok = torch.allclose(o, r, rtol=2e-5, atol=2e-6) \
                if dtype == torch.float32 else \
                within_one_ulp(torch, o, r, 2e-5, 2e-6)
            if not bool(torch.isfinite(o.float()).all()) or not ok:
                fail(f"paged_decode_attention int8 {dtype} slot {b}: "
                     f"max_abs_err {float((o - r).float().abs().max()):.3e}")
            err = max(err, float((o.float() - r.float()).abs().max()))
        if dtype == torch.float32:      # the JSON's error: f32 vs f32
            worst = err
        # Dead pages: garbage codes and NaN scales must not change a bit.
        kq2, vq2, ks2, vs2 = kq.clone(), vq.clone(), ks.clone(), vs.clone()
        kq2[dead], vq2[dead] = 127, -127
        ks2[dead], vs2[dead] = float("nan"), float("nan")
        out2 = paged_decode_attention(q, kq2, vq2, c["tables"], c["pos"],
                                      sm_scale=c["sm"], lengths=c["lens"],
                                      k_scales=ks2, v_scales=vs2)
        # Zeroed pages (codes 0, scales 0) read as exactly 0.
        zq, zs = torch.zeros_like(kq), torch.zeros_like(ks)
        out0 = paged_decode_attention(q, zq, zq, c["tables"], c["pos"],
                                      sm_scale=c["sm"], lengths=c["lens"],
                                      k_scales=zs, v_scales=zs)
        torch.cuda.synchronize()
        if not torch.equal(out, out2):
            fail(f"paged_decode_attention int8 {dtype}: NaN scales in "
                 f"{len(dead)} dead pages changed the output")
        if bool(out0.any()):
            fail(f"paged_decode_attention int8 {dtype}: zeroed pages did "
                 "not read as 0")
        print(f"kernel paged_decode_attention int8 q {dtype}: max_abs_err "
              f"{err:.3e} (rtol 2e-5 atol 2e-6 of the f32 plain version"
              f"{'' if dtype == torch.float32 else ', + one bf16 ulp'}"
              f", valid rows) | {len(dead)} dead pages with NaN scales: "
              "output bit-identical | zeroed pages read as 0", flush=True)
    # Timing at the serving dtype (bf16 q), the case above.
    B, C, H, D = c["q"].shape
    Hkv = kq.shape[2]
    args = (q, kq, vq, c["tables"], c["pos"])
    launches0 = paged_decode_attention.int8_launches
    t_k = time_ms(torch, [lambda: paged_decode_attention(
        *args, sm_scale=c["sm"], lengths=c["lens"], k_scales=ks,
        v_scales=vs)], 200)
    paged_decode_attention.int8_launches = launches0
    t_p = time_ms(torch, [lambda: paged_attention_ref(
        *args, sm_scale=c["sm"], k_scales=ks, v_scales=vs)], 50)
    # Library yardstick: SDPA over the dequantized gathered (B, H, S, D)
    # view with the causal-depth mask, built outside the timed call.
    G = H // Hkv
    tb = c["tables"].long()
    kv = [(x[tb].float() * sc[tb].float()[..., None]).flatten(1, 2)
          .to(torch.bfloat16).repeat_interleave(G, dim=2).transpose(1, 2)
          .contiguous() for x, sc in ((kq, ks), (vq, vs))]
    s = kv[0].shape[2]
    depth = c["pos"].long()[:, None] + torch.arange(C, device=dev) + 1
    mask = (torch.arange(s, device=dev)[None, None, :]
            < depth[:, :, None])[:, None]
    qh = q.transpose(1, 2).contiguous()
    t_l = time_ms(torch, [lambda: F.scaled_dot_product_attention(
        qh, kv[0], kv[1], attn_mask=mask, scale=c["sm"])], 200)
    nbytes = keys * Hkv * (D + 2) * 2 + 2 * q.numel() * 2 \
        + c["tables"].numel() * 4 + 2 * B * 4
    flops = keys * Hkv * (C * G) * 4 * D
    b_ms, b_by = bound(nbytes, flops)
    print(f"kernel paged_decode_attention int8 B={B} C={C} H={H} Hkv={Hkv} "
          f"D={D} bs={c['bs']}: kernel {t_k:.4f} ms | plain {t_p:.4f} ms | "
          f"library(SDPA on dequantized gathered view) {t_l:.4f} ms | bound "
          f"{b_ms:.5f} ms ({b_by}) | per step x28: kernel {28 * t_k:.4f} ms",
          flush=True)
    return dict(name="paged_decode_attention_int8", route="cuda",
                source="src/repro_torch/csrc/paged_attention.cu",
                replaces="src/repro/kernels/paged_attention.py:156",
                max_abs_err=worst, ms=28 * t_k, plain_ms=28 * t_p,
                bound_ms=28 * b_ms, bound_by=b_by, library_ms=28 * t_l,
                ms_per_call=t_k)


def _mla_case(torch, np, dev, shape, seed, entries=None, deep=False):
    """MLA operands (Hkv = 1) at full width: fragmented, permuted and
    partly null tables, mixed lengths (or ``entries`` valid chunk entries
    in every slot) and depths (or, ``deep``, every slot's chunk ending at
    its last position), f32 q_eff and q2, f32 ckv/krope the caller casts
    or quantizes."""
    B, C, H, rank, rope, bs, MB, nb = shape
    rng = np.random.RandomState(seed)
    perm = rng.permutation(nb)
    owned = rng.randint(1, MB + 1, size=B)
    owned[0] = MB
    if deep:
        owned[:] = MB
    tables = np.full((B, MB), nb, np.int32)
    lens = rng.randint(1, C + 1, size=B).astype(np.int32)
    if entries is not None:
        lens[:] = entries
    pos = np.zeros(B, np.int32)
    for b in range(B):
        tables[b, :owned[b]] = perm[b * MB:b * MB + owned[b]]
        pos[b] = rng.randint(0, owned[b] * bs - lens[b] + 1)
        if deep:
            pos[b] = owned[b] * bs - lens[b]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    t = lambda a: torch.from_numpy(a).to(dev)     # noqa: E731
    return dict(
        q=torch.randn((B, C, H, rank), generator=gen, device=dev),
        q2=torch.randn((B, C, H, rope), generator=gen, device=dev),
        ckv=torch.randn((nb + 1, bs, 1, rank), generator=gen, device=dev),
        kr=torch.randn((nb + 1, bs, 1, rope), generator=gen, device=dev),
        tables=t(tables), pos=t(pos), lens=t(lens), np_tables=tables,
        np_pos=pos, np_lens=lens, bs=bs, nb=nb,
        sm=(128 + rope) ** -0.5)           # deepseek-v3: (nope + rope)^-1/2


def _mla_pages(torch, c, form):
    """(k, k2, scales) of the case's pages: bf16, or int8 codes with fp16
    scale pages."""
    from repro_torch.models.attention import quantize_kv
    if form == "bf16":
        return c["ckv"].to(torch.bfloat16), c["kr"].to(torch.bfloat16), {}
    kq, ks = quantize_kv(c["ckv"][:, :, 0])
    k2q, k2s = quantize_kv(c["kr"][:, :, 0])
    return kq[:, :, None], k2q[:, :, None], dict(
        k_scales=ks[:, :, None], k2_scales=k2s[:, :, None])


def _time_mla(torch, c, k, k2, sc, run, form, counter, label):
    """B9 on case ``c`` (length pattern ``label``) timed per call: the
    kernel, its plain version, the library yardstick and the bound,
    printed and returned; printed beside them, the split the kernel took
    (as it wrote it back) and the tensor-core work its design does."""
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.ref import paged_attention_ref
    dev = c["q"].device
    B, C, H, rank = c["q"].shape
    rope = c["q2"].shape[-1]
    launches0 = getattr(paged_decode_attention, counter)
    t_k = time_ms(torch, [run], 200)
    run()
    per, items, most = pa.mla_last_plan()
    setattr(paged_decode_attention, counter, launches0)
    t_p = time_ms(torch, [lambda: paged_attention_ref(
        c["q"], k, None, c["tables"], c["pos"], sm_scale=c["sm"],
        q2=c["q2"], k2_pages=k2, **sc)], 20)
    # Library yardstick: SDPA (f32, as q_eff) over the gathered,
    # dequantized view, K = [ckv | krope], V = ckv, one kv-head shared by
    # the 128 heads, with the causal-depth mask; built outside the timed
    # call.
    tb = c["tables"].long()

    def view(x, s):
        v = x[tb].float()
        if s is not None:
            v = v * s[tb].float()[..., None]
        return v.flatten(1, 2).transpose(1, 2)     # (B, 1, S, D)
    kv = view(k, sc.get("k_scales"))
    kk = torch.cat([kv, view(k2, sc.get("k2_scales"))], -1).contiguous()
    vv = kv.contiguous()
    qh = torch.cat([c["q"], c["q2"]], -1).transpose(1, 2).contiguous()
    s = kk.shape[2]
    depth = c["pos"].long()[:, None] + torch.arange(C, device=dev) + 1
    mask = (torch.arange(s, device=dev)[None, None, :]
            < depth[:, :, None])[:, None]          # (B, 1, C, S)
    t_l = time_ms(torch, [lambda: F.scaled_dot_product_attention(
        qh, kk, vv, attn_mask=mask, scale=c["sm"], enable_gqa=True)], 50)
    # The bytes the function must move: the valid rows' f32 q_eff and q2
    # in and f32 output out (rows past a slot's length are garbage by
    # contract, so it needs none of them), each live page once, the
    # tables, positions and lengths.
    _, keys = _live_pages(c)
    rows = H * sum(int(n) for n in c["np_lens"])
    per_key = (rank + rope) * (2 if form == "bf16" else 1) + \
        (0 if form == "bf16" else 4)
    nbytes = 4 * rows * (2 * rank + rope) + keys * per_key + \
        c["tables"].numel() * 4 + 2 * B * 4
    # The causal work of the valid rows: H rows per chunk entry, each over
    # its depth pos + i + 1, 2 flops per multiply-add over the score
    # (rank + rope) and the P.V (rank) features, once, at the bf16
    # tensor-core peak. The design does more: each product once per bf16
    # part of q (scores) and of p (P.V).
    depths = sum(int(c["np_pos"][b]) * int(c["np_lens"][b])
                 + int(c["np_lens"][b]) * (int(c["np_lens"][b]) + 1) // 2
                 for b in range(B))
    flops = 2.0 * H * depths * (2 * rank + rope)
    b_ms, b_by = bound(nbytes, flops)
    nq, np_ = pa.mla_parts()
    tc_flops = 2.0 * H * depths * (nq * (rank + rope) + np_ * rank)
    print(f"kernel paged_decode_attention mla {form} B={B} C={C} H={H} "
          f"rank={rank} rope={rope} bs={c['bs']} lengths {label}: kernel "
          f"{t_k:.4f} ms (split, as the kernel wrote it: {per} key tiles "
          f"of 16 a split, {items} items, at most {most} splits a row "
          f"tile) | plain {t_p:.4f} ms | "
          f"library(SDPA f32 on the gathered view, K=[ckv|krope], V=ckv) "
          f"{t_l:.4f} ms | bound {b_ms:.5f} ms ({b_by}; {nbytes / 1e6:.2f} "
          f"MB, {flops / 1e9:.3f} GFLOP at the bf16 peak) | tensor-core "
          f"work done ({nq} q parts, {np_} p parts): {tc_flops / 1e9:.3f} "
          f"GFLOP, {tc_flops / BF16_FLOPS * 1e3:.5f} ms at the bf16 peak",
          flush=True)
    return dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                bound_ms=b_ms, bound_by=b_by)


def check_paged_mla_long_table(torch, np, dev, form):
    """The MLA form at the serve's widths on a 4,096-page table (65,536
    keys a slot; the kernel's shared memory does not grow with the
    table's width): slot 0 decodes at the end of a 2,048-page walk
    (32,768 keys, over pages 0..99 of the pool, reused), slots 1..3 own
    short runs of pages 100..139. Against the plain version, two
    launches bit-identical, dead pages filled with garbage changing no
    bit, rows past each length 0; the split read back from the kernel
    (more than one split of a row tile); timed per call."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.ref import paged_attention_ref
    c = _mla_case(torch, np, dev, (4, 8, 128, 512, 64, 16, 40, 160), 11)
    rng = np.random.RandomState(11)
    mb, nb, bs = 4096, c["nb"], c["bs"]
    tables = np.full((4, mb), nb, np.int32)
    tables[0, :2048] = rng.randint(0, 100, size=2048)
    owned = [2048, 17, 9, 3]
    for i, o in enumerate(owned[1:], 1):
        tables[i, :o] = 100 + rng.permutation(40)[:o]
    lens = np.array([1, 8, 3, 8], np.int32)
    pos = np.array([o * bs - n for o, n in zip(owned, lens)], np.int32)
    t = lambda a: torch.from_numpy(a).to(dev)     # noqa: E731
    c.update(tables=t(tables), pos=t(pos), lens=t(lens), np_tables=tables,
             np_pos=pos, np_lens=lens)
    k, k2, sc = _mla_pages(torch, c, form)
    counter = "mla_launches" if form == "bf16" else "mla_int8_launches"

    def run(k=k, k2=k2, sc=sc):
        return paged_decode_attention(
            c["q"], k, None, c["tables"], c["pos"], sm_scale=c["sm"],
            lengths=c["lens"], q2=c["q2"], k2_pages=k2, **sc)
    launches0 = getattr(paged_decode_attention, counter)
    out = run()
    per, items, most = pa.mla_last_plan()
    again = run()
    dead = torch.arange(140, nb + 1, device=dev)
    k_d, k2_d = k.clone(), k2.clone()
    sc_d = {n: v.clone() for n, v in sc.items()}
    if form == "int8":
        k_d[dead], k2_d[dead] = 127, -127
        for v in sc_d.values():
            v[dead] = float("nan")
    else:
        k_d[dead], k2_d[dead] = float("nan"), float("nan")
    out2 = run(k=k_d, k2=k2_d, sc=sc_d)
    ref = paged_attention_ref(c["q"], k, None, c["tables"], c["pos"],
                              sm_scale=c["sm"], q2=c["q2"], k2_pages=k2,
                              **sc)
    torch.cuda.synchronize()
    err = 0.0
    for b in range(4):
        n = int(lens[b])
        o, r = out[b, :n], ref[b, :n]
        if not bool(torch.isfinite(o).all()) or \
                not torch.allclose(o, r, rtol=2e-5, atol=1e-5):
            fail(f"paged_decode_attention mla {form}, 4,096-page table, slot "
                 f"{b}: max_abs_err {float((o - r).abs().max()):.3e}")
        if bool(out[b, n:].any()):
            fail(f"paged_decode_attention mla {form}, 4,096-page table: rows "
                 f"past slot {b}'s length are not 0")
        err = max(err, float((o - r).abs().max()))
    if not torch.equal(out, again):
        fail(f"paged_decode_attention mla {form}, 4,096-page table: two "
             "launches differ")
    if not torch.equal(out, out2):
        fail(f"paged_decode_attention mla {form}, 4,096-page table: garbage "
             f"in {len(dead)} dead pages changed the output")
    if most < 2:
        fail(f"paged_decode_attention mla {form}, 4,096-page table: the "
             f"32,768-key walk was not split ({per} key tiles a split)")
    t_k = time_ms(torch, [run], 50)
    setattr(paged_decode_attention, counter, launches0)
    print(f"kernel paged_decode_attention mla {form} 4,096-page table "
          f"(slot 0 decoding 32,768 keys deep): max_abs_err {err:.3e} "
          f"(rtol 2e-5 atol 1e-5) | split, as the kernel wrote it: {per} "
          f"key tiles of 16 a split, {items} items, at most {most} splits "
          f"a row tile | two launches bit-identical | {len(dead)} dead "
          f"pages garbage: output bit-identical | rows past each length 0 "
          f"| kernel {t_k:.4f} ms per call", flush=True)
    return dict(max_abs_err=err, ms_per_call=t_k)


def check_paged_mla(torch, np, dev):
    """The MLA form of paged_decode_attention (bf16 pages, then int8 codes
    with fp16 scales) against its plain version at a ragged shape and at
    the deepseek serve's decode shape with four length patterns: every
    slot with one valid chunk entry (steady decode: the page walk split
    finely), with full chunks (an all-prefill step: fewer splits), with
    full chunks at the deepest position (depth 160: one split) and mixed
    lengths. Each case is timed per call; the rows' numbers are the
    serve shape's mixed pattern per step (4 MLA layers). Returns the two
    forms' kernel rows."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.ref import paged_attention_ref
    routes = record_routes(torch, mla_only=True)
    TC, CC = "paged MLA bf16 (tensor cores)", "paged MLA f32 (CUDA cores)"
    rows = []
    full = MLA_CASE[1]
    cases = (("ragged, mixed lengths", MLA_RAGGED, 8, None, False),
             ("decode", MLA_CASE, 7, 1, False),
             ("full chunk", MLA_CASE, 7, full, False),
             ("full chunk at depth 160", MLA_CASE, 7, full, True),
             ("mixed", MLA_CASE, 7, None, False))
    for form, counter in (("bf16", "mla_launches"),
                          ("int8", "mla_int8_launches")):
        worst = 0.0
        serve_cases = {}
        for label, shape, seed, entries, deep in cases:
            c = _mla_case(torch, np, dev, shape, seed, entries=entries,
                          deep=deep)
            k, k2, sc = _mla_pages(torch, c, form)
            rt = pa.mla_row_tile(k.dtype)

            def run(k=k, k2=k2, sc=sc, c=c):
                return paged_decode_attention(
                    c["q"], k, None, c["tables"], c["pos"],
                    sm_scale=c["sm"], lengths=c["lens"], q2=c["q2"],
                    k2_pages=k2, **sc)
            before = dict(routes)
            out, again = run(), run()
            ref = paged_attention_ref(c["q"], k, None, c["tables"],
                                      c["pos"], sm_scale=c["sm"],
                                      q2=c["q2"], k2_pages=k2, **sc)
            torch.cuda.synchronize()
            if not torch.equal(out, again):
                fail(f"paged_decode_attention mla {form} {shape}: two "
                     "launches differ")
            if routes.get(TC, 0) != before.get(TC, 0) + 2 or \
                    routes.get(CC, 0) != before.get(CC, 0):
                fail(f"paged_decode_attention mla {form} {shape}: not two "
                     f"tensor-core launches ({routes})")
            err = 0.0
            for b in range(out.shape[0]):
                n = int(c["np_lens"][b])
                o, r = out[b, :n], ref[b, :n]
                # f32 q_eff and output: the reorder of 576-feature scores
                # and of up to 160 keys' weighted values up to ~4 in
                # magnitude, merged across page splits (tests/
                # test_torch_cuda.py's MLA tolerance).
                if not bool(torch.isfinite(o).all()) or \
                        not torch.allclose(o, r, rtol=2e-5, atol=1e-5):
                    fail(f"paged_decode_attention mla {form} {shape} slot "
                         f"{b}: max_abs_err "
                         f"{float((o - r).abs().max()):.3e}")
                err = max(err, float((o - r).abs().max()))
                # The kernel writes a row tile of garbage rows as 0: with
                # H a multiple of the tile, every row past the length (the
                # plain version computes them).
                if out.is_cuda and shape[2] % rt == 0 and \
                        bool(out[b, n:].any()):
                    fail(f"paged_decode_attention mla {form}: rows past "
                         f"slot {b}'s length are not 0")
            worst = max(worst, err)
            live, keys = _live_pages(c)
            dead = torch.tensor([p for p in range(c["nb"] + 1)
                                 if p not in live], dtype=torch.long,
                                device=dev)
            k_d, k2_d = k.clone(), k2.clone()
            sc_d = {n: v.clone() for n, v in sc.items()}
            if form == "int8":          # codes cannot hold NaN
                k_d[dead], k2_d[dead] = 127, -127
                for v in sc_d.values():
                    v[dead] = float("nan")
            else:
                k_d[dead], k2_d[dead] = float("nan"), float("nan")
            out2 = run(k=k_d, k2=k2_d, sc=sc_d)
            torch.cuda.synchronize()
            if not torch.equal(out, out2):
                fail(f"paged_decode_attention mla {form} {shape}: garbage "
                     f"in {len(dead)} dead pages changed the output")
            zero = " rows past each length 0 |" if shape[2] % rt == 0 \
                else ""
            serve_cases[label] = (c, k, k2, sc, run)
            print(f"kernel paged_decode_attention mla {form} B,C,H,rank,"
                  f"rope,bs,MB={shape[:7]} lengths "
                  f"{label}: max_abs_err {err:.3e} (rtol "
                  f"2e-5 atol 1e-5, valid rows) | two launches "
                  f"bit-identical, both tensor-core |{zero}"
                  f" {len(dead)} dead pages "
                  f"{'NaN scales, +-127 codes' if form == 'int8' else 'NaN'}"
                  ": output bit-identical", flush=True)
        timed = {label: _time_mla(torch, *case, form, counter, label)
                 for label, case in serve_cases.items()}
        del serve_cases
        name = "paged_decode_attention_mla" + \
            ("" if form == "bf16" else "_int8")
        n = DEEPSEEK_LAYERS
        t = timed["mixed"]
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/paged_attention.cu",
            replaces="src/repro/kernels/paged_attention.py:156",
            max_abs_err=worst, ms=n * t["ms"], plain_ms=n * t["plain_ms"],
            bound_ms=n * t["bound_ms"], bound_by=t["bound_by"],
            library_ms=n * t["library_ms"],
            per_call=timed,
            long_table=check_paged_mla_long_table(torch, np, dev, form)))
    return rows


def check_flash(torch, dev):
    """flash_attention against attention_ref at full width (FLASH_CASES),
    timed at qwen3-0.6b's prefill of 8 x 512 tokens, per prefill (28
    calls)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    worst = 0.0
    timed = None
    for label, b, sq, skv, h, hkv, d, causal, off, dt in FLASH_CASES:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn((b, n_s, n_h, d), generator=gen,
                               device=dev).to(dtype)
                   for n_s, n_h in ((sq, h), (skv, hkv), (skv, hkv)))
        out = flash_attention(q, k, v, causal=causal, q_offset=off)
        ref = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                            q_offset=off)                       # f32
        torch.cuda.synchronize()
        err = float((out.float() - ref).abs().max())
        # tests/test_kernels.py's 1e-4 (blocked online vs dense softmax);
        # a bf16 output is that f32 result rounded once (one ulp more).
        ok = torch.allclose(out, ref, rtol=1e-4, atol=1e-4) \
            if dtype == torch.float32 else \
            within_one_ulp(torch, out, ref, 1e-4, 1e-4)
        if not bool(torch.isfinite(out.float()).all()) or not ok:
            fail(f"flash_attention {label}: max_abs_err {err:.3e}")
        if dtype == torch.float32:      # the JSON's error: f32 vs f32
            worst = max(worst, err)
        print(f"kernel flash_attention {label} B={b} Sq={sq} Skv={skv} "
              f"H={h} Hkv={hkv} D={d} causal={causal} q_offset={off} {dt}: "
              f"max_abs_err {err:.3e} (rtol/atol 1e-4 of the f32 plain "
              f"version{'' if dtype == torch.float32 else ', + one bf16 ulp'})",
              flush=True)
        if timed is None:
            timed = (q, k, v, causal, b, sq, h, hkv, d)
        del out, ref
    q, k, v, causal, b, sq, h, hkv, d = timed
    launches0 = flash_attention.launches
    t_k = time_ms(torch, [lambda: flash_attention(q, k, v, causal=causal)],
                  50)
    flash_attention.launches = launches0
    t_p = time_ms(torch, [lambda: attention_ref(q, k, v, causal=causal)], 20)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    t_l = time_ms(torch, [lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True, enable_gqa=True)], 50)
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    pairs = sq * (sq + 1) // 2 if causal else sq * sq   # visible (i, j)
    flops = 4.0 * b * h * d * pairs
    b_ms, b_by = bound(nbytes, flops)
    print(f"kernel flash_attention bf16 B={b} S={sq} H={h} Hkv={hkv} D={d} "
          f"causal: kernel {t_k:.4f} ms | plain {t_p:.4f} ms | "
          f"library(SDPA is_causal, enable_gqa) {t_l:.4f} ms | bound "
          f"{b_ms:.5f} ms ({b_by}) | per prefill x28: kernel "
          f"{28 * t_k:.4f} ms", flush=True)
    del q, k, v, qh, kh, vh
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:73",
                max_abs_err=worst, ms=28 * t_k, plain_ms=28 * t_p,
                bound_ms=28 * b_ms, bound_by=b_by, library_ms=28 * t_l,
                ms_per_call=t_k,
                deepseek_prefill=check_flash_mla(torch, dev))


def check_flash_mla(torch, dev):
    """flash_attention at deepseek-v3's MLA prefill widths (FLASH_MLA:
    D = nope + rope = 192, Dv = 128, H = Hkv = 128, bf16, causal) against
    attention_ref, timed per call and per prefill (4 MLA layers).
    Returns those numbers (an extra key of the flash row)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_ref
    b, s, h, d, dv = FLASH_MLA
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    q, k = (torch.randn((b, s, h, d), generator=gen,
                        device=dev).to(torch.bfloat16) for _ in range(2))
    v = torch.randn((b, s, h, dv), generator=gen,
                    device=dev).to(torch.bfloat16)
    sm = d ** -0.5
    out = flash_attention(q, k, v, causal=True, sm_scale=sm)
    ref = attention_ref(q.float(), k.float(), v.float(), causal=True,
                        sm_scale=sm)
    torch.cuda.synchronize()
    err = float((out.float() - ref).abs().max())
    if not bool(torch.isfinite(out.float()).all()) or \
            not within_one_ulp(torch, out, ref, 1e-4, 1e-4):
        fail(f"flash_attention deepseek-v3 prefill widths: max_abs_err "
             f"{err:.3e}")
    del ref
    launches0 = flash_attention.launches
    t_k = time_ms(torch, [lambda: flash_attention(
        q, k, v, causal=True, sm_scale=sm)], 10)
    flash_attention.launches = launches0
    t_p = time_ms(torch, [lambda: attention_ref(
        q, k, v, causal=True, sm_scale=sm)], 3)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    t_l = time_ms(torch, [lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True, scale=sm)], 10)
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + b * s * h * dv)
    flops = 2.0 * b * h * (s * (s + 1) // 2) * (d + dv)
    b_ms, b_by = bound(nbytes, flops)
    n = DEEPSEEK_LAYERS
    print(f"kernel flash_attention deepseek-v3 prefill bf16 B={b} S={s} "
          f"H={h} D={d} Dv={dv} causal: max_abs_err {err:.3e} (rtol/atol "
          f"1e-4 of the f32 plain version + one bf16 ulp) | kernel "
          f"{t_k:.4f} ms | plain "
          f"{t_p:.4f} ms | library(SDPA is_causal) "
          f"{t_l:.4f} ms | bound {b_ms:.5f} ms ({b_by}) | per prefill x{n}:"
          f" kernel {n * t_k:.4f} ms", flush=True)
    del q, k, v, qh, kh, vh, out
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=n * t_k, plain_ms=n * t_p,
                bound_ms=n * b_ms, bound_by=b_by, library_ms=n * t_l,
                ms_per_call=t_k)


def _to(tree, d):
    if isinstance(tree, dict):
        return {k: _to(v, d) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, d) for v in tree]
    return tree.to(d)


def _cut_to_two(params, model):
    """The weights of ``model`` (a 2-layer cut whose layers all sit in
    group layers0) taken from the full model's ``params``: the first two
    layers of layers0, no other layer group."""
    from repro_torch.models.lm import layer_groups
    assert [(n, c) for n, c, _ in layer_groups(model.cfg)] == \
        [("layers0", 2)]
    return {k: (v[:2] if k == "layers0" else v) for k, v in params.items()
            if not k.startswith("layers") or k == "layers0"}


def check_prefill_vs_cpu(torch, dev, params, cfg, quant):
    """A full-width prefill with depth cut to 2 layers: the card (matmul
    and flash kernels) against the plain path on the CPU, same weights,
    a ragged 100-token sequence."""
    import dataclasses
    from repro_torch.models.api import build_model
    model = build_model(dataclasses.replace(cfg, num_layers=2))
    cut = _cut_to_two(params, model)
    rng = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (2, 100), generator=rng,
                           dtype=torch.int32)
    out = {}
    for d in ("cpu", dev):
        logits, cache = model.prefill(_to(cut, d), {"tokens": tokens.to(d)},
                                      quant=quant)
        out[str(d)] = (logits.float().cpu(), _to(cache, "cpu"))
    (a, ca), (r, cr) = out[str(dev)], out["cpu"]
    scale = float(r.abs().max())
    worst = float((a - r).abs().max())
    if a.shape != (2, 1, cfg.vocab_size) or not bool(torch.isfinite(a).all()) \
            or worst > 1e-2 * scale:
        fail(f"full-width {quant} prefill (2 layers) card vs CPU: "
             f"max_abs_err {worst:.3e} vs max|logit| {scale:.3e}")
    # Caches: within one bf16 ulp of their scale (2^(e - 8) for the
    # largest magnitude m * 2^e of the leaf, m in [0.5, 1)).
    parts = []
    for leaf in ("k", "v"):
        x, y = ca["layers0"][leaf].float(), cr["layers0"][leaf].float()
        ulp = 2.0 ** (int(torch.frexp(y.abs().max()).exponent) - 8)
        e = float((x - y).abs().max())
        if e > ulp:
            fail(f"full-width {quant} prefill: cache {leaf} max_abs_err "
                 f"{e:.3e} > one bf16 ulp of its scale {ulp:.3e}")
        parts.append(f"{leaf} {e:.3e} (ulp {ulp:.3e})")
    print(f"step check: full-width qwen3-0.6b {quant} prefill, 2 layers, "
          f"2 x 100 tokens, card kernels vs CPU plain: last-token logits "
          f"max_abs_err {worst:.3e} (bound 1e-2 x max|logit| = "
          f"{1e-2 * scale:.3e}); caches {', '.join(parts)}", flush=True)


def check_step_vs_cpu(torch, dev, params, cfg, quant, kv_quant="none"):
    """One full-width decode step with depth cut to 2 layers under recipe
    ``quant`` (on int8 KV pages with ``kv_quant="int8"``): the kernels on
    the card against the plain path on the CPU, same weights."""
    import dataclasses
    from repro_torch.models.api import build_model
    small = dataclasses.replace(cfg, num_layers=2)
    model = build_model(small)
    cut = _cut_to_two(params, model)
    dtypes = {"q": torch.int8, "s": torch.float16}

    rng = torch.Generator().manual_seed(3)
    B, C, bs, MB = 2, 8, 16, 4
    tokens = torch.randint(0, cfg.vocab_size, (B, C), generator=rng,
                           dtype=torch.int32)
    pos = torch.tensor([0, 5], dtype=torch.int32)
    lens = torch.tensor([8, 3], dtype=torch.int32)
    tables = torch.tensor([[3, 1, 8, 8], [0, 2, 8, 8]], dtype=torch.int32)
    shapes = model.paged_cache_shapes(B, 9, bs, kv_quant=kv_quant)
    out = {}
    for d in ("cpu", dev):
        cache = {n: {k: {p: torch.zeros(sp, dtype=dtypes[p], device=d)
                         for p, sp in s.items()} if kv_quant == "int8"
                     else torch.zeros(s, dtype=torch.bfloat16, device=d)
                     for k, s in leaves.items()}
                 for n, leaves in shapes.items()}
        logits, _ = model.decode_step(
            _to(cut, d), tokens.to(d), pos.to(d), cache, quant=quant,
            block_tables=tables.to(d), lengths=lens.to(d))
        out[str(d)] = logits.float().cpu()
    a, r = out[str(dev)], out["cpu"]
    worst = 0.0
    for b in range(B):
        n = int(lens[b])
        worst = max(worst, float((a[b, :n] - r[b, :n]).abs().max()))
    scale = float(r.abs().max())
    # Both sides round the activations to bf16 after every op, in another
    # summation order; with these weights that has come to 1.8e-2 (q8_0)
    # to 2.7e-2 (q3_k_s) against a max |logit| of ~3, so 1e-2 x max|logit|
    # is 1.2-1.7x the readings and tight enough that one layer's attention
    # going wrong shows. On int8 pages the same one-ulp difference of a
    # new K/V element can move its code by a whole step (1/127 of the
    # row's absmax, ~2.5x a bf16 ulp): the first reading was 3.1e-2
    # (q8_0), so that step is held to tests/test_torch_model.py's
    # LOGIT_TOL, 2.5e-2 x max|logit|, the port's bound for two bf16
    # paths in another order; a wrong attention moves logits by O(1).
    rel = 1e-2 if kv_quant == "none" else 2.5e-2
    if a.shape != (B, C, cfg.vocab_size) or not bool(torch.isfinite(a).all()) \
            or worst > rel * scale:
        fail(f"full-width {quant} kv={kv_quant} step (2 layers) card vs "
             f"CPU: max_abs_err {worst:.3e} vs max|logit| {scale:.3e}")
    print(f"step check: full-width {cfg.name} {quant} kv={kv_quant}, 2 "
          f"layers, card kernels "
          f"vs CPU plain: logits {tuple(a.shape)} finite, max_abs_err "
          f"{worst:.3e} (bound {rel:g} x max|logit| = {rel * scale:.3e})",
          flush=True)


def _device_events(torch, prof):
    """Device-side events of a profile with device time: a CPU op's
    device time repeats the time of the kernels it launched, which appear
    as events of their own."""
    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    return [e for e in prof.key_averages()
            if e.device_type != torch.autograd.DeviceType.CPU
            and dev_us(e) > 0], dev_us


def profile_prefill(torch, model, params, tokens, cfg) -> None:
    """Where a prefill's time goes: one more ``model.prefill`` under
    torch.profiler, device busy against its wall time and the heaviest
    kernels (after the timed prefills and their launch check)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.prefill(params, {"tokens": tokens}, quant="q8_0")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events, dev_us = _device_events(torch, prof)
    tag = f"profile prefill {cfg.name}:"
    if not events:
        print(f"{tag} the profiler recorded no device time (not measured)",
              flush=True)
        return
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    print(f"{tag} wall {wall_ms:.1f} ms (under the profiler), device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%)", flush=True)
    for e in sorted(events, key=dev_us, reverse=True)[:8]:
        print(f"{tag}   device {dev_us(e) / 1e3:8.3f} ms {e.count:6d} calls"
              f"  {e.key[:90]}", flush=True)


def profile_serve(torch, serve, cfg, model, params, dev, quant,
                  arena=SERVE_ARGS[:-8], label=None) -> None:
    """Where a serve step's time goes: a shorter stream of the same shape
    (slots, chunk and the ``arena`` flags) under torch.profiler, device
    time by kernel against the wall time, and the host's kernel launches
    per step and cost per launch."""
    from torch.profiler import ProfilerActivity, profile
    ap = serve.build_parser()
    args = ap.parse_args(list(arena) + [
        "--quant", quant, "--requests", "8", "--prompt-len", "32", "--gen",
        "8", "--arrival", "back2back"])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, rep, _ = serve.run_stream(cfg, model, params, args, dev)
        torch.cuda.synchronize()

    events, dev_us = _device_events(torch, prof)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    wall_ms = sum(rep.stats.step_s) * 1e3
    steps = rep.stats.steps
    tag = f"profile {label or quant}:"
    if not events:
        print(f"{tag} the profiler recorded no device time (not measured)",
              flush=True)
        return
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    # Plain launches and the matmuls' cluster launches (cudaLaunchKernelEx).
    launch = [e for e in host
              if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC")]
    count = sum(e.count for e in launch)
    per_launch = (f"{count / steps:.1f} kernel launches/step at "
                  f"{sum(e.self_cpu_time_total for e in launch) / count:.1f}"
                  " us each") if launch else "launches not recorded"
    print(f"{tag} {steps} steps of a {args.requests}-request stream: "
          f"step wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f}% of step wall, idle "
          f"{100 - 100 * busy_ms / wall_ms:.1f}%), {per_launch}", flush=True)
    top = sorted(events, key=dev_us, reverse=True)
    # The six heaviest kernels, and the attention kernels wherever they
    # rank.
    for e in top[:6] + [e for e in top[6:] if "attention" in e.key
                        or "paged_gqa" in e.key or "flash" in e.key]:
        print(f"{tag}   device {dev_us(e) / 1e3 / steps:8.3f} ms/step "
              f"{e.count / steps:7.1f} calls/step  {e.key[:90]}", flush=True)
    for e in host[:6]:
        print(f"{tag}   host {e.self_cpu_time_total / 1e3 / steps:8.3f} "
              f"ms/step {e.count / steps:7.1f} calls/step  {e.key[:90]}",
              flush=True)


def recipe_setup(torch, dev, serve, quant, argv=SERVE_ARGS,
                 quantize=True, layers=None):
    """(args, cfg, model, params) of the full-width serve ``argv`` under
    recipe ``quant``, with its seeded weights made on the card (left
    dense with ``quantize=False``), depth cut to ``layers`` if given."""
    import dataclasses
    ap = serve.build_parser()
    args = ap.parse_args(list(argv) + ["--quant", quant])
    serve.validate_args(ap, args)
    cfg = serve.get_config(args.arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = serve.build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = serve.build_params(model, args, dev, quantize=quantize)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"serve {quant} setup: full-width {cfg.name} ({cfg.num_layers} "
          f"layers, d_model {cfg.d_model}, vocab {cfg.vocab_size}) weights "
          f"made on the card in {time.perf_counter() - t0:.1f} s: "
          f"{nbytes / 1e9:.2f} GB, peak device memory while making them "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB", flush=True)
    return args, cfg, model, params


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def check_launches(tag, launches, per_step, steps):
    """Fail unless ``launches`` is exactly ``per_step`` x ``steps`` for
    every kernel (0 for a kernel ``per_step`` does not name)."""
    want = {name: per_step.get(name, 0) * steps for name in launches}
    if launches != want:
        fail(f"{tag}: launches {launches} != {want} for {steps} steps")
    print(f"{tag}: kernels launched {launches} over {steps} "
          f"({per_step} per step)", flush=True)
    return {name: n for name, n in launches.items() if n}


def serve_recipe(torch, dev, serve, quant, extra=(), per_step=None,
                 tag=None, argv=SERVE_ARGS, setup=None):
    """Serve the stream ``argv`` at full width under recipe ``quant``
    (plus the flags ``extra``) and assert the exact kernel launches per
    step and every request complete; ``setup``: the ``recipe_setup`` of
    ``argv`` to reuse (its weights are kept), else one is made and
    dropped. Returns {kernel: launches in the serve}."""
    tag = tag or f"serve {quant}"
    if setup is None:
        args, cfg, model, params = recipe_setup(
            torch, dev, serve, quant, argv=list(argv) + list(extra))
    else:
        _, cfg, model, params = setup
        ap = serve.build_parser()
        args = ap.parse_args(list(argv) + list(extra) + ["--quant", quant])
        serve.validate_args(ap, args)
    serve.reset_launches()
    engine, report, reqs = serve.run_stream(cfg, model, params, args, dev)
    launches = serve.launch_counts()
    for line in serve.serve_report_lines(engine, report, args.requests,
                                         launches=launches):
        print(f"{tag}: {line}", flush=True)
    steps = report.stats.steps
    if len(report.sequences) != len(reqs) or any(
            len(s.generated) != args.gen
            or not all(0 <= t < cfg.vocab_size for t in s.generated)
            for s in report.sequences):
        fail(f"{tag}: not every request completed with in-vocab tokens")
    out = check_launches(tag, launches, per_step or RECIPE_LAUNCHES[quant],
                         steps)
    del params, engine
    torch.cuda.empty_cache()
    return out


def serve_batch(torch, dev, serve):
    """``serve --mode batch --prompt-len 128 --gen 32 --batch 8`` at full
    width (q8_0; the lockstep Engine quantizes the dense weights): every
    token in vocab, exact launches per step, no attention kernel (the
    contiguous arena attends in plain PyTorch, as the JAX package's XLA
    does)."""
    argv = ["--mode", "batch", "--prompt-len", "128", "--gen", "32",
            "--batch", "8"]
    args, cfg, model, dense = recipe_setup(torch, dev, serve, "q8_0",
                                           argv=argv, quantize=False)
    serve.reset_launches()
    t0 = time.perf_counter()
    out, stats = serve.run_batch(cfg, model, dense, args, dev)
    wall = time.perf_counter() - t0
    launches = serve.launch_counts()
    for line in serve.batch_lines(stats, args):
        print(f"serve batch: {line}", flush=True)
    print(f"serve batch: {stats.steps} steps in {wall:.2f} s (quantization "
          f"stage included), p50 step {1e3 * sorted(stats.step_s)[len(stats.step_s) // 2]:.2f} ms",
          flush=True)
    if out.shape != (args.batch, args.gen) or not (
            (out >= 0) & (out < cfg.vocab_size)).all():
        fail(f"serve batch: tokens {out.shape} not all in vocab")
    res = check_launches("serve batch", launches, BATCH_LAUNCHES,
                         stats.steps)
    del dense
    torch.cuda.empty_cache()
    return res


@contextlib.contextmanager
def recorded_logits(torch, serve):
    """Record, for the serves run inside, the logit row each emitted
    token was chosen from: yields (rows, index), rows[i] the i-th step's
    (slots, rows, vocab) f32 copy on the card (one copy kernel a step, a
    PyTorch copy: no kernel counter moves) — the sampled row of each slot
    (rows = 1), or with speculation every fed row the verification head
    read (rows = chunk) — and index[(rid, k)] = (step, slot, row) of
    request rid's k-th token: row ``lengths - 1`` of the chunk that
    finished its prompt, row t for the t-th token a verify step emitted
    (after t accepted proposals)."""
    from repro_torch.runtime import sampling
    from repro_torch.runtime.request import SeqState
    rows, index = [], {}
    sample0, verify0 = sampling.sample_slots, sampling.verify_slots
    step0 = serve.ServingEngine._step_once

    def sample(last, *a, **kw):
        rows.append(last[:, None].to(torch.float32, copy=True))
        return sample0(last, *a, **kw)

    def verify(logits, *a, **kw):
        rows.append(logits.to(torch.float32, copy=True))
        return verify0(logits, *a, **kw)

    def step(self, *a, **kw):
        before = {s: (q, q.tokens_out, q.fed, q.state is SeqState.PREFILL)
                  for s, q in self.sched.active.items()}
        step0(self, *a, **kw)
        for s, (q, n0, f0, prefill) in before.items():
            for t in range(q.tokens_out - n0):
                j = t if not prefill else \
                    q.fed - f0 - 1 if self.spec != "off" else 0
                index[(q.rid, n0 + t)] = (len(rows) - 1, s, j)
    sampling.sample_slots, sampling.verify_slots = sample, verify
    serve.ServingEngine._step_once = step
    try:
        yield rows, index
    finally:
        sampling.sample_slots, sampling.verify_slots = sample0, verify0
        serve.ServingEngine._step_once = step0


def check_near_ties(torch, tag, ref, run, strict=True) -> int:
    """Hold the tokens of serve ``run`` against the reference serve
    ``ref`` (each: report, logit rows, index) by the near-tie rule: a
    request may part from the reference only where the reference's top-2
    gap is below LOGIT_TOL of its max |logit|, onto a token it scored
    within that of its best, and at most one request in four (or one in
    eight of the near-tie positions) may. Also prints how far the two
    runs' logit rows drift apart before each request's first divergence
    (a share of max |logit|). ``strict=False`` (an MoE model, whose
    capacity dispatch couples a token to the other rows of its step)
    prints the requests that part beyond the rule instead of failing.
    Returns the number of requests exempted."""
    rep, rows, index = ref
    got, grows, gindex = run
    keys = sorted(index)
    stack = torch.stack([rows[i][s, j] for i, s, j in
                         (index[k] for k in keys)])
    tol = LOGIT_TOL * float(torch.stack([r.abs().max() for r in rows])
                            .max())
    top = stack.topk(2, dim=1).values
    gaps = dict(zip(keys, (top[:, 0] - top[:, 1]).tolist()))
    near = sum(g < tol for g in gaps.values())
    exempt, same, beyond = [], [], []
    for a, b in zip(rep.sequences, got.sequences):
        if a.rid != b.rid or len(a.generated) != len(b.generated):
            fail(f"{tag}: request {b.rid} does not match the reference")
        diff = [k for k, (x, y) in enumerate(zip(a.generated, b.generated))
                if x != y]
        same += [(a.rid, j) for j in range(diff[0] if diff else
                                           len(a.generated))]
        if not diff:
            continue
        k = diff[0]
        i, s, j = index[(a.rid, k)]
        row = rows[i][s, j]
        if gaps[(a.rid, k)] >= tol or float(row[b.generated[k]]) \
                < float(row.max()) - tol:
            msg = (f"{tag}: request {a.rid} parts from the reference at "
                   f"token {k} (top-2 gap {gaps[(a.rid, k)]:.4g}, tolerance"
                   f" {tol:.4g}): {a.generated} vs {b.generated}")
            if strict:
                fail(msg)
            print(f"{msg} -- beyond the near-tie rule (MoE capacity)",
                  flush=True)
            beyond.append((a.rid, k))
            continue
        exempt.append((a.rid, k))
    if strict and len(exempt) > max(len(rep.sequences) // 4, near // 8):
        fail(f"{tag}: {len(exempt)} near-tie exemptions ({near} near-tie "
             "positions)")
    row_of = lambda r, ix, k: r[ix[k][0]][ix[k][1], ix[k][2]]  # noqa: E731
    drift = max(float((row_of(rows, index, k) - row_of(grows, gindex, k))
                      .abs().max()) for k in same) / (tol / LOGIT_TOL)
    print(f"{tag}: tokens equal to the reference up to near-ties"
          + (" except MoE-capacity partings" if beyond else "") + ": "
          f"{len(exempt)} of {len(rep.sequences)} requests exempted "
          f"{exempt} ({near} of {len(keys)} positions are near-ties, "
          f"tolerance {tol:.4g})"
          + (f", {len(beyond)} part beyond the rule {beyond}" if beyond
             else "") + "; logit rows before the first divergence "
          f"differ by at most {drift:.3e} of max|logit|", flush=True)
    return len(exempt) + len(beyond)


def check_cow(torch, dev, serve) -> None:
    """The copy-on-write split on the card, at full width: qwen3-0.6b's
    arena on bf16 and on int8 pages (code and scale pages) and deepseek-v3's
    (4 layers) on bf16 pages (latent and RoPE pages), 257 pages of 16
    filled with seeded values. A cached prompt admitted again whole is
    split at admission, a longer one shares its blocks, and a write range
    over them splits both: every copy equals its source page in every
    leaf, the sibling's pages keep every bit, and the next step uploads
    the remapped table."""
    import dataclasses
    from repro_torch.runtime.kvcache import PagedKVArena, _leaves
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    for arch, kv in (("qwen3-0.6b", "none"), ("qwen3-0.6b", "int8"),
                     ("deepseek-v3-671b", "none")):
        cfg = serve.get_config(arch)
        if arch.startswith("deepseek"):
            cfg = dataclasses.replace(cfg, num_layers=DEEPSEEK_LAYERS)
        arena = PagedKVArena(serve.build_model(cfg), num_slots=8,
                             max_seq=416, block_size=16, num_blocks=256,
                             prefix_cache=True, kv_quant=kv, device=dev)
        for leaf in _leaves(arena.buffers):
            if leaf.dtype == torch.int8:
                leaf.copy_(torch.randint(-127, 128, leaf.shape, device=dev,
                                         generator=gen, dtype=torch.int8))
            else:
                leaf.copy_(torch.randn(leaf.shape, device=dev,
                                       generator=gen))
        before = [x.clone() for x in _leaves(arena.buffers)]
        prompt = list(range(1000, 1040))            # 2 full blocks + 8
        arena.device_tables()
        a, _, _ = arena.alloc_slot_prefix(prompt, 64)
        arena.register_prefix(a, prompt)
        b, hit_b, _ = arena.alloc_slot_prefix(prompt[:32], 8)
        c, hit_c, _ = arena.alloc_slot_prefix(prompt + [7] * 8, 8)
        split = arena.prepare_write(c, 0, 20)
        tables, uploaded = arena.device_tables()
        src, got_b, got_c = (arena.slot_blocks(x) for x in (a, b, c))
        ok = (hit_b, hit_c, split, arena.cow_splits) == (31, 32, 2, 3) \
            and uploaded and bool(torch.equal(
                tables.cpu(), torch.from_numpy(arena.tables)))
        for old, new in zip(before, _leaves(arena.buffers)):
            ok = ok and bool(torch.equal(new[:, src], old[:, src])) \
                and bool(torch.equal(new[:, got_c[:2]], old[:, src[:2]])) \
                and bool(torch.equal(new[:, got_b[1]], old[:, src[1]]))
        if not ok:
            fail(f"copy-on-write {arch} kv={kv}: hits {hit_b}/{hit_c}, "
                 f"splits {split} ({arena.cow_splits}), pages or table "
                 "wrong")
        print(f"copy-on-write {arch} kv={kv}: 3 splits over "
              f"{len(before)} paged leaves, copies equal their sources, "
              "the sibling's pages unchanged, table re-uploaded",
              flush=True)
        del arena, before
    torch.cuda.empty_cache()


def _serve_recorded(torch, dev, serve, setup, argv, tag, card, draft=None):
    """One serve of ``argv`` (q8_0, telemetry on) with ``setup``'s
    weights and its logit rows recorded: the report, the completion and
    timeline-closure checks, and every block back in the allocator.
    Returns (engine, (report, rows, index), {kernel: launches})."""
    _, cfg, model, params = setup
    ap = serve.build_parser()
    args = ap.parse_args(list(argv) + ["--quant", "q8_0"])
    serve.validate_args(ap, args)
    serve.reset_launches()
    with recorded_logits(torch, serve) as (rows, index):
        engine, report, _ = serve.run_stream(cfg, model, params, args, dev,
                                             draft=draft)
    launches = serve.launch_counts()
    _run_lines(serve, tag, engine, report, args, card, launches)
    alloc = engine.arena.allocator
    if alloc.free_blocks != engine.arena.num_blocks:
        fail(f"{tag}: {alloc.used_blocks} blocks still held after the "
             "stream")
    return engine, (report, rows, index), launches


def _spec_summary(tag, card, plain, spec, launches) -> None:
    """The spec run's end-to-end numbers beside the plain run's."""
    p, q = plain.stats, spec.stats
    print(f"{tag} on {card}: spec vs plain: steps {q.steps} vs {p.steps} |"
          f" steps/token {q.steps_per_token:.3f} vs "
          f"{p.steps_per_token:.3f} | accept {q.spec_accepted}/"
          f"{q.spec_proposed} ({100 * q.spec_accept_rate:.1f} %) | rolled "
          f"back {q.spec_rolled_back} tokens | tokens/s "
          f"{spec.throughput_tok_s:.1f} vs {plain.throughput_tok_s:.1f} | "
          f"p50 step {spec.step_ms_percentile(50):.2f} vs "
          f"{plain.step_ms_percentile(50):.2f} ms | kernel launches/step "
          f"{sum(launches.values()) / max(q.steps, 1):.1f}", flush=True)


def serve_spec(torch, dev, serve, setup, per_step, label, card,
               argv=SERVE_ARGS, extra=(), strict=True):
    """The stream ``argv`` (plus ``extra``) with ``--spec ngram --spec-k
    4`` beside the same stream without it: the spec run proposes and
    rolls back, launches exactly ``per_step`` per verify step, returns
    every block, and its tokens equal the plain run's up to near-ties
    (MoE: ``strict=False``, check_near_ties). Returns ({run: {kernel:
    launches}}, the plain run's recorded result)."""
    tag, out = f"spec {label}", {}
    _, plain, launches = _serve_recorded(
        torch, dev, serve, setup, list(argv) + list(extra), f"{tag} plain",
        card)
    out[f"{tag} plain"] = check_launches(f"{tag} plain", launches, per_step,
                                         plain[0].stats.steps)
    _, run, launches = _serve_recorded(
        torch, dev, serve, setup, list(argv) + list(extra) + SPEC_FLAGS,
        f"{tag} ngram", card)
    st = run[0].stats
    if not (st.spec_proposed > 0 and st.spec_rolled_back > 0):
        fail(f"{tag} ngram: proposed {st.spec_proposed}, rolled back "
             f"{st.spec_rolled_back}: the accept or rollback path never ran")
    out[f"{tag} ngram"] = check_launches(f"{tag} ngram", launches, per_step,
                                         st.steps)
    check_near_ties(torch, f"{tag} ngram", plain, run, strict=strict)
    _spec_summary(tag, card, plain[0], run[0], launches)
    return out, plain


def _check_draft_launches(tag, engine, report, launches, per_step):
    """A draft serve's launches: ``per_step`` per verify step plus
    DRAFT_PASS_LAUNCHES per draft pass, exactly."""
    steps, passes = report.stats.steps, engine._proposer.passes
    want = {k: per_step.get(k, 0) * steps
            + DRAFT_PASS_LAUNCHES.get(k, 0) * passes for k in launches}
    if launches != want:
        fail(f"{tag}: launches {launches} != {want} for {steps} verify "
             f"steps and {passes} draft passes")
    print(f"{tag}: kernels launched {launches} over {steps} verify steps "
          f"({per_step} each) and {passes} draft passes in "
          f"{engine._proposer.steps} rounds ({DRAFT_PASS_LAUNCHES} each)",
          flush=True)
    return {k: n for k, n in launches.items() if n}


def serve_draft(torch, dev, serve, pf, plain06, card):
    """``--arch qwen3-1.7b --spec draft --spec-draft-model qwen3-0.6b``
    beside qwen3-1.7b without it (its 197 + 28 launches a step confirmed
    from the plain run's counters first; random weights: near-0 accept,
    verification and heavy rollback), then a self-draft of qwen3-0.6b
    (``pf``, the draft is the target) beside its plain run ``plain06``:
    at least 90 % of proposals accepted and steps per token well under
    the plain run's. Tokens equal up to near-ties in both. Returns {run:
    {kernel: launches}}."""
    out, per_step = {}, RECIPE_LAUNCHES["q8_0"]
    big = recipe_setup(torch, dev, serve, "q8_0", argv=DRAFT_ARGS)
    tag = "spec qwen3-1.7b"
    _, plain, launches = _serve_recorded(torch, dev, serve, big, DRAFT_ARGS,
                                         f"{tag} plain", card)
    out[f"{tag} plain"] = check_launches(f"{tag} plain", launches, per_step,
                                         plain[0].stats.steps)
    args = serve.build_parser().parse_args(DRAFT_ARGS + DRAFT_FLAGS
                                           + ["--quant", "q8_0"])
    draft = serve.build_draft(args, dev)
    eng, run, launches = _serve_recorded(
        torch, dev, serve, big, DRAFT_ARGS + DRAFT_FLAGS, f"{tag} draft",
        card, draft=draft)
    out[f"{tag} draft"] = _check_draft_launches(f"{tag} draft", eng, run[0],
                                                launches, per_step)
    check_near_ties(torch, f"{tag} draft", plain, run)
    _spec_summary(tag, card, plain[0], run[0], launches)
    dt = run[0].stats.draft_transfers
    moved = {d: sum(v.get(d, 0.0) for v in dt.phase_totals.values())
             for d in ("h2d", "d2h")}
    print(f"{tag} draft account: {moved['h2d'] / 1e6:.1f} MB h2d, "
          f"{moved['d2h'] / 1e6:.3f} MB d2h, weight stream "
          f"{dt.weight_stream_bytes / 1e9:.2f} GB over "
          f"{eng._proposer.passes} passes (modeled)", flush=True)
    del big, draft, eng, plain, run
    torch.cuda.empty_cache()

    tag = "spec qwen3-0.6b self-draft"
    _, _, model, params = pf
    eng, run, launches = _serve_recorded(
        torch, dev, serve, pf, SERVE_ARGS + DRAFT_FLAGS, tag, card,
        draft=(model, params))
    out[tag] = _check_draft_launches(tag, eng, run[0], launches, per_step)
    st, pst = run[0].stats, plain06[0].stats
    if st.spec_accept_rate < 0.9 or \
            st.steps_per_token > 0.75 * pst.steps_per_token:
        fail(f"{tag}: accepted {st.spec_accepted}/{st.spec_proposed}, "
             f"steps/token {st.steps_per_token:.3f} (plain "
             f"{pst.steps_per_token:.3f})")
    check_near_ties(torch, tag, plain06, run)
    _spec_summary(tag, card, plain06[0], run[0], launches)
    return out


def serve_spec_prefix(torch, dev, serve, pf, card):
    """A speculative serve behind the shared system prompt with the
    prefix cache (qwen3 q8_0, bf16 pages): every rollback leaves every
    shared (refcount > 1) or cached page of its slot's table bit-equal
    (each call's pages copied before and compared after), launches stay
    the recipe's per step, every block returns, and the timeline closes
    against the ledger."""
    from repro_torch.runtime.kvcache import PagedKVArena, _leaves
    tag = "spec prefix q8_0"
    rollback0 = PagedKVArena.rollback
    seen = {"calls": 0, "pages": 0, "in_range": 0}

    def rollback(self, slot, start, count, width):
        pc, rc = self.prefix_cache, self.allocator.refcounts
        blocks = [b for b in self.slot_blocks(slot)
                  if rc[b] > 1 or pc.is_cached(b)]
        idx = torch.tensor(blocks, dtype=torch.long, device=self.device)
        snap = [leaf.index_select(1, idx) for leaf in _leaves(self.buffers)]
        touched = {self.tables[slot, p // self.block_size]
                   for p in range(start, start + count)}
        dropped = rollback0(self, slot, start, count, width)
        if not all(bool(torch.equal(leaf.index_select(1, idx), x))
                   for leaf, x in zip(_leaves(self.buffers), snap)):
            fail(f"{tag}: a rollback of slot {slot} changed a shared or "
                 "cached page")
        seen["calls"] += 1
        seen["pages"] += len(blocks)
        seen["in_range"] += len(touched & set(blocks))
        return dropped
    PagedKVArena.rollback = rollback
    try:
        eng, run, launches = _serve_recorded(
            torch, dev, serve, pf, SERVE_ARGS + PREFIX_FLAGS
            + ["--prefix-cache"] + SPEC_FLAGS, tag, card)
    finally:
        PagedKVArena.rollback = rollback0
    st = run[0].stats
    if not (st.spec_rolled_back and seen["pages"]):
        fail(f"{tag}: rolled back {st.spec_rolled_back}, shared or cached "
             f"pages checked {seen['pages']}")
    res = check_launches(tag, launches, RECIPE_LAUNCHES["q8_0"], st.steps)
    print(f"{tag} on {card}: {seen['calls']} rollbacks left "
          f"{seen['pages']} shared or cached pages of their tables "
          f"bit-equal ({seen['in_range']} of them in a rolled-back range);"
          f" hits {st.prefix_hits} ({st.prefix_hit_tokens} tokens), accept "
          f"{st.spec_accepted}/{st.spec_proposed}, steps {st.steps}, "
          f"steps/token {st.steps_per_token:.3f}, tokens/s "
          f"{run[0].throughput_tok_s:.1f}", flush=True)
    return {tag: res}


def _insert_rows(torch, arena, vals, pos0, lens):
    """Write a chunk of K/V rows into every paged leaf and layer of
    ``arena`` through the decode step's own page insert (the step's
    routing over the block table; quantize-on-insert on int8 pages):
    ``vals[(group, key)]`` (slots, width, features...) bf16, row b's
    first ``lens[b]`` entries at ``pos0[b] + i``."""
    from repro_torch.models import attention as attn
    tables = arena.device_tables()[0]
    t = lambda a: torch.tensor(a, dtype=torch.int32,  # noqa: E731
                               device=arena.device)
    for name, group in arena.buffers.items():
        for key, leaf in group.items():
            codes = leaf["q"] if isinstance(leaf, dict) else leaf
            new = vals[(name, key)]
            _, rows, offs, valid = attn._routing(
                t(pos0), tables, t(lens), codes.shape[1], codes.shape[2],
                new.shape[1])
            for i in range(codes.shape[0]):
                if isinstance(leaf, dict):
                    attn._paged_insert_quant({k: v[i] for k, v in
                                              leaf.items()}, new, rows,
                                             offs, valid)
                else:
                    attn._write(leaf[i], new, rows, offs, valid)


def check_rollback(torch, dev, serve) -> None:
    """Speculative rollback on the card, at full width: qwen3-0.6b's
    arena on bf16 and int8 pages and deepseek-v3's (4 layers) on bf16
    pages (latent and RoPE pages), 257 pages of 16, 8 slots. Each slot's
    prompt rows, then a verify chunk of 1 + k rows of which it keeps r,
    go through the decode step's page insert with seeded values; rolling
    back the rejected m - r leaves every page but the null page (garbage
    by contract), the tables, the slots' blocks and the free list
    bit-identical to an arena that only ever took the r rows. Then, on a
    prefix-cache arena filled with seeded values, a rollback over a page
    a sibling shares and one over a cached page leave both untouched,
    zero the slot's own rejected positions and trim its table."""
    import dataclasses
    from repro_torch.runtime.kvcache import PagedKVArena, _leaves
    C = 8
    prompt = [13, 30, 15, 16, 1, 47, 8, 20]
    fed = [5, 8, 1, 4, 8, 3, 6, 2]            # 1 + k rows a slot verifies
    kept = [2, 8, 1, 1, 3, 1, 6, 1]           # accepted + 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    for arch, kv in (("qwen3-0.6b", "none"), ("qwen3-0.6b", "int8"),
                     ("deepseek-v3-671b", "none")):
        cfg = serve.get_config(arch)
        if arch.startswith("deepseek"):
            cfg = dataclasses.replace(cfg, num_layers=DEEPSEEK_LAYERS)
        model = serve.build_model(cfg)
        mk = lambda **kw: PagedKVArena(  # noqa: E731
            model, num_slots=8, max_seq=416, block_size=16, num_blocks=256,
            kv_quant=kv, device=dev, **kw)
        a, b = mk(), mk()
        vals = {}
        for name, group in a.buffers.items():
            for key, leaf in group.items():
                codes = leaf["q"] if isinstance(leaf, dict) else leaf
                vals[(name, key)] = [torch.randn(
                    (8, w) + tuple(codes.shape[3:]), generator=gen,
                    device=dev).to(torch.bfloat16) for w in (48, C)]
        chunk = lambda i: {k: v[i] for k, v in vals.items()}  # noqa: E731
        for x in (a, b):
            for s in range(8):
                if x.alloc_slot(x.blocks_needed(prompt[s])) != s:
                    fail(f"rollback {arch}: admission of slot {s} failed")
            _insert_rows(torch, x, chunk(0), [0] * 8, prompt)
            for s in range(8):
                x.ensure(s, prompt[s] + kept[s])
        # The verify chunk's extra blocks are allocated last, so both
        # arenas hold the same blocks for the kept rows.
        for s in range(8):
            a.ensure(s, prompt[s] + fed[s])
        held = sum(len(a.slot_blocks(s)) for s in range(8))
        _insert_rows(torch, a, chunk(1), prompt, fed)
        _insert_rows(torch, b, chunk(1), prompt, kept)
        nb = a.null_block
        differ = not all(bool(torch.equal(x[:, :nb], y[:, :nb])) for x, y in
                         zip(_leaves(a.buffers), _leaves(b.buffers)))
        dropped = sum(a.rollback(s, prompt[s] + kept[s], fed[s] - kept[s],
                                 C) for s in range(8))
        same = all(bool(torch.equal(x[:, :nb], y[:, :nb])) for x, y in
                   zip(_leaves(a.buffers), _leaves(b.buffers)))
        ok = differ and same and (a.tables == b.tables).all() \
            and [a.slot_blocks(s) for s in range(8)] == \
            [b.slot_blocks(s) for s in range(8)] \
            and a.allocator.free_blocks == b.allocator.free_blocks \
            and dropped == held - sum(len(b.slot_blocks(s))
                                      for s in range(8)) > 0
        if not ok:
            fail(f"rollback {arch} kv={kv}: the arena after rollback is not "
                 f"the arena that never took the rejected rows (differed "
                 f"before {differ}, equal after {same}, dropped {dropped})")
        del a, b, vals

        arena = mk(prefix_cache=True)
        for leaf in _leaves(arena.buffers):
            if leaf.dtype == torch.int8:
                leaf.copy_(torch.randint(-127, 128, leaf.shape, device=dev,
                                         generator=gen, dtype=torch.int8))
            else:
                leaf.copy_(torch.randn(leaf.shape, device=dev,
                                       generator=gen))
        before = [x.clone() for x in _leaves(arena.buffers)]
        toks = list(range(1000, 1032))              # 2 full blocks
        sa, _, _ = arena.alloc_slot_prefix(toks, 64)
        arena.register_prefix(sa, toks)
        sb, hit, _ = arena.alloc_slot_prefix(toks, 64)  # root shared
        arena.ensure(sb, 40)
        root, cached = arena.slot_blocks(sa)
        _, copy, third = arena.slot_blocks(sb)
        drops = (arena.rollback(sb, 8, 32, C), arena.rollback(sa, 16, 16, C))
        rc = arena.allocator.refcounts
        ok = hit == 31 and drops == (2, 1) and rc[root] == 2 \
            and rc[cached] == 0 and arena.prefix_cache.is_cached(cached)
        for old, new in zip(before, _leaves(arena.buffers)):
            ok = ok and bool(torch.equal(new[:, [root, cached]],
                                         old[:, [root, cached]])) \
                and not bool(new[:, copy].any()) \
                and not bool(new[:, third, :8].any()) \
                and bool(torch.equal(new[:, third, 8:], old[:, third, 8:]))
        if not ok:
            fail(f"rollback {arch} kv={kv} over shared and cached pages: "
                 f"hit {hit}, dropped {drops}, refcounts {rc[root]}/"
                 f"{rc[cached]}, or a page wrong")
        print(f"rollback {arch} kv={kv}: {dropped} blocks trimmed over 8 "
              f"slots, every page (null page aside) bit-identical to the "
              f"arena that never took the rejected rows over "
              f"{len(before)} paged leaves; the shared root and the cached "
              "page untouched by rollbacks over them, the slot's own "
              "rejected positions zeroed", flush=True)
        del arena, before
    torch.cuda.empty_cache()


def serve_prefix(torch, dev, serve, setup, per_step, label, card,
                 argv=SERVE_ARGS, extra=(), warm=False):
    """The paper's system-evaluation serve of ``argv`` (q8_0, plus
    ``extra``) with ``setup``'s weights: the stream behind the shared
    system prompt without the cache, then with ``--prefix-cache`` and the
    telemetry exports (and, with ``warm``, the same stream again on the
    warm cache of the same engine). Each run: every request complete with
    in-vocab tokens, exact launches per step, the timeline closed against
    the ledger; the shared runs: prefix hits of SHARED_PREFIX tokens
    each (the cold one), both exports valid, tokens within the near-tie
    rule of the unshared run. Returns {run: {kernel: launches}}."""
    from repro_torch.runtime import telemetry
    _, cfg, model, params = setup
    ap = serve.build_parser()
    out, res = {}, {}
    export = ["--prefix-cache",
              "--metrics-out", str(ROOT / "build" / f"serve_{label}.jsonl"),
              "--trace", str(ROOT / "build" / f"serve_{label}.json")]
    for run, flags in (("unshared", []), ("shared", export)):
        args = ap.parse_args(list(argv) + list(extra) + PREFIX_FLAGS
                             + flags + ["--quant", "q8_0"])
        serve.validate_args(ap, args)
        tag = f"prefix {label} {run}"
        serve.reset_launches()
        with recorded_logits(torch, serve) as (rows, index):
            engine, report, reqs = serve.run_stream(cfg, model, params,
                                                    args, dev)
        launches = serve.launch_counts()
        _run_lines(serve, tag, engine, report, args, card, launches)
        out[tag] = check_launches(tag, launches, per_step,
                                  report.stats.steps)
        res[run] = (report, rows, index)
        if warm and run == "shared":
            tag = f"prefix {label} warm"
            serve.reset_launches()
            with recorded_logits(torch, serve) as (rows, index):
                report = engine.serve(reqs, seed=args.seed)
            launches = serve.launch_counts()
            _run_lines(serve, tag, engine, report, args, card, launches)
            out[tag] = check_launches(tag, launches, per_step,
                                      report.stats.steps)
            res["warm"] = (report, rows, index)
    shared, unshared = res["shared"][0], res["unshared"][0]
    st = shared.stats
    # A cold hit maps exactly the system prompt; a warm run admits every
    # request onto its own cached chain (at least the system prompt).
    hits = [st.prefix_hits]
    if st.prefix_hit_tokens != SHARED_PREFIX * st.prefix_hits:
        fail(f"prefix {label}: {st.prefix_hits} hits of "
             f"{st.prefix_hit_tokens} tokens (want {SHARED_PREFIX} each)")
    if "warm" in res:
        w = res["warm"][0].stats
        hits.append(w.prefix_hits)
        if w.prefix_hits != args.requests or \
                w.prefix_hit_tokens < SHARED_PREFIX * w.prefix_hits:
            fail(f"prefix {label} warm: {w.prefix_hits} hits of "
                 f"{w.prefix_hit_tokens} tokens")
    if not any(hits):
        fail(f"prefix {label}: no prefix hit")
    for run in ("shared", "warm"):
        if run in res:
            check_near_ties(torch, f"prefix {label} {run}", res["unshared"],
                            res[run])
    for name in ("jsonl", "json"):
        path = ROOT / "build" / f"serve_{label}.{name}"
        n = (telemetry.validate_metrics_jsonl if name == "jsonl" else
             telemetry.validate_chrome_trace)(str(path))
        print(f"prefix {label}: {path.relative_to(ROOT)} valid ({n} "
              f"{'step events' if name == 'jsonl' else 'spans'})",
              flush=True)
    skipped = unshared.stats.prefill_tokens - st.prefill_tokens
    print(f"prefix {label} on {card}: shared vs unshared tokens/s "
          f"{shared.throughput_tok_s:.1f} vs {unshared.throughput_tok_s:.1f}"
          f" | p50 step {shared.step_ms_percentile(50):.2f} vs "
          f"{unshared.step_ms_percentile(50):.2f} ms | p90 step "
          f"{shared.step_ms_percentile(90):.2f} vs "
          f"{unshared.step_ms_percentile(90):.2f} ms | steps "
          f"{st.steps} vs {unshared.stats.steps} | prefill tokens skipped "
          f"{skipped} | hits {st.prefix_hits} ({st.prefix_hit_tokens} "
          f"tokens) | CoW splits {st.cow_splits}"
          + (f" | warm: hits {res['warm'][0].stats.prefix_hits} "
             f"({res['warm'][0].stats.prefix_hit_tokens} tokens), CoW "
             f"splits {res['warm'][0].stats.cow_splits}, tokens/s "
             f"{res['warm'][0].throughput_tok_s:.1f}" if "warm" in res
             else ""), flush=True)
    del res
    torch.cuda.empty_cache()
    return out


def _run_lines(serve, tag, engine, report, args, card, launches) -> None:
    """One telemetry run's report, completion and ledger-closure checks
    (the draft proposer's account too, with one) and its bottleneck
    share."""
    for line in serve.serve_report_lines(engine, report, args.requests,
                                         launches=launches):
        print(f"{tag}: {line}", flush=True)
    vocab = engine.model.cfg.vocab_size
    if len(report.sequences) != args.requests or any(
            len(s.generated) != args.gen
            or not all(0 <= t < vocab for t in s.generated)
            for s in report.sequences):
        fail(f"{tag}: not every request completed with in-vocab tokens")
    tl = report.timeline
    if tl.ledger_delta_totals() != report.ledger.breakdown():
        fail(f"{tag}: the timeline's ledger deltas do not close against "
             "the ledger")
    draft = getattr(engine._proposer, "ledger", None)
    if draft is not None:
        tot = {}
        for e in tl.events:
            for k, v in e.draft_delta.items():
                tot[k] = tot.get(k, 0.0) + v
        want = {(p, c, d): v for p, cats in draft.breakdown().items()
                for c, dirs in cats.items() for d, v in dirs.items()}
        if tot.keys() != want.keys() or any(
                abs(tot[k] - v) > 1e-9 * abs(v) for k, v in want.items()):
            fail(f"{tag}: the timeline's draft deltas do not close against "
                 "the draft ledger")
    br = tl.bottleneck_report()
    prompt = [e.wall_s for e in tl.events
              if any(s[2] == "prefill" and s[3] for s in e.slots)]
    decode = [e.wall_s for e in tl.events
              if e.slots and not any(s[2] == "prefill" and s[3]
                                     for s in e.slots)]
    gaps = [b.t_start - a.t_end for a, b in zip(tl.events, tl.events[1:])]
    med = lambda v: 1e3 * sorted(v)[len(v) // 2] if v else 0.0  # noqa: E731
    print(f"{tag}: timeline: {len(prompt)} steps with prompt chunks "
          f"(median {med(prompt):.2f} ms), {len(decode)} decode-only "
          f"(median {med(decode):.2f} ms); host time between steps "
          f"{1e3 * sum(gaps):.1f} ms in all (median {med(gaps):.3f} ms) of "
          f"{1e3 * report.wall_s:.1f} ms serve wall", flush=True)
    print(f"{tag} on {card}: {report.throughput_tok_s:.1f} tokens/s, p50 "
          f"step {report.step_ms_percentile(50):.2f} ms, p90 step "
          f"{report.step_ms_percentile(90):.2f} ms; timeline closed "
          f"against the ledger over {len(tl.events)} events; "
          f"transfer-bound steps {br.transfer_bound}/{br.steps} "
          f"({100 * br.transfer_bound / max(br.steps, 1):.1f} %, modeled "
          f"CGLA LOAD {br.load_s * 1e3:.2f} ms vs measured "
          f"{br.exec_s * 1e3:.2f} ms); step compiles "
          f"{report.step_compiles}", flush=True)


def run_prefill(torch, dev, serve, repeats: int = 3, setup=None,
                per_prefill=PREFILL_LAUNCHES):
    """``model.prefill`` of 8 x 512 seeded tokens at full width (q8_0),
    ``repeats`` times: finite last-token logits and caches of the
    expected shapes, exact launches per prefill, prefill tokens/s.
    ``setup``: a ``recipe_setup`` to reuse (default: qwen3-0.6b's)."""
    _, cfg, model, params = setup or recipe_setup(torch, dev, serve, "q8_0")
    b, s = PREFILL_SHAPE
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=dev, dtype=torch.int32)
    serve.reset_launches()
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": tokens},
                                      quant="q8_0")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = serve.launch_counts()
    want = model.cache_shapes(b, s)
    got = {n: {k: tuple(v.shape) for k, v in leaves.items()}
           for n, leaves in cache.items()}
    if logits.shape != (b, 1, cfg.vocab_size) or not bool(
            torch.isfinite(logits.float()).all()) or got != want or not all(
            bool(torch.isfinite(v.float()).all())
            for leaves in cache.values() for v in leaves.values()):
        fail(f"prefill {cfg.name}: logits {tuple(logits.shape)} / caches "
             f"{got} (want {want}) wrong or not finite")
    best = min(times)
    print(f"prefill: full-width {cfg.name} ({cfg.num_layers} layers) q8_0, "
          f"{b} x {s} tokens: {[round(t * 1e3, 2) for t in times]} ms per "
          f"prefill, best {b * s / best:.0f} prefill tokens/s (first call "
          f"included in the list); caches {got}", flush=True)
    res = check_launches(f"prefill {cfg.name}", launches, per_prefill,
                         repeats)
    profile_prefill(torch, model, params, tokens, cfg)
    del cache
    if setup is None:
        del params
    torch.cuda.empty_cache()
    return res


def check_recipe(torch, dev, serve, quant) -> None:
    """Recipe ``quant``'s 2-layer step against the CPU path, and a shorter
    serve of it under the profiler (after every timed serve: a profiler
    session slows the launches of the process that ran it)."""
    _, cfg, model, params = recipe_setup(torch, dev, serve, quant)
    check_step_vs_cpu(torch, dev, params, cfg, quant)
    if quant == "q8_0":
        check_prefill_vs_cpu(torch, dev, params, cfg, quant)
        check_step_vs_cpu(torch, dev, params, cfg, quant, kv_quant="int8")
    profile_serve(torch, serve, cfg, model, params, dev, quant)
    if quant == "q8_0":     # the int8 pages, and the batch mode's arena
        profile_serve(torch, serve, cfg, model, params, dev, quant,
                      arena=SERVE_ARGS[:-8] + ["--kv-quant", "int8"],
                      label="q8_0 kv-int8")
        profile_serve(torch, serve, cfg, model, params, dev, quant,
                      arena=SERVE_ARGS[:4] + ["--chunk-size", "8"],
                      label="q8_0 contiguous")
    del params
    torch.cuda.empty_cache()


def time_moe_layer(torch, dev, cfg, params) -> None:
    """deepseek-v3's MoE layer (layer 3) alone on 8 x 8 tokens (one
    unified step's rows): device time per call from CUDA events around 3
    calls (the per-layer host sync included) and the peak device memory
    above what was allocated before (the transient of the expert
    products)."""
    from repro_torch.models import moe
    lp = params["layers1"][0]["ffn"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    x = torch.randn((8, 8, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    xt = x.reshape(-1, cfg.d_model)
    active = int((moe.route(lp, cfg, xt)[3] > 0).sum())
    moe.moe_apply(lp, cfg, x, fmt="q8_0")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        out, _ = moe.moe_apply(lp, cfg, x, fmt="q8_0")
    end.record()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    if not bool(torch.isfinite(out.float()).all()):
        fail("deepseek-v3 MoE layer: output not finite")
    print(f"moe layer: deepseek-v3 layer 3 on 64 tokens, {active} of "
          f"{cfg.moe.num_experts} experts active: "
          f"{start.elapsed_time(end) / 3:.3f} ms per call (CUDA events, "
          f"host sync included), peak transient {peak / 1e9:.2f} GB",
          flush=True)


def check_moe_vs_cpu(torch, dev, cfg, params) -> None:
    """deepseek-v3's full-width MoE layer (layer 3: 256 experts, top-8,
    capacity 4 per expert at 64 rows, so assignments drop) on the card
    against the CPU plain path, same weights and the same 8 x 8 rows as
    ``time_moe_layer``: which token fills every (expert, capacity) slot
    and which slots every token reads must be identical (a changed drop
    is another function), and the outputs agree within two bf16 ulps of
    the largest |out| (one for each rounding that another summation order
    can move across a boundary: the combine's and the shared expert's
    add)."""
    from repro_torch.models import moe
    lp = params["layers1"][0]["ffn"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    x = torch.randn((8, 8, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    t0 = time.perf_counter()
    got = {}
    for d in (dev, "cpu"):
        p = lp if d == dev else _to(lp, "cpu")
        xd = x.to(d)
        dispatch, _, token_slots, _, _, cap = moe.route(
            p, cfg, xd.reshape(-1, cfg.d_model))
        out, _ = moe.moe_apply(p, cfg, xd, fmt="q8_0")
        got[str(d)] = (dispatch.cpu(), token_slots.cpu(), out.float().cpu())
        del p
    (d_a, s_a, o_a), (d_r, s_r, o_r) = got[str(dev)], got["cpu"]
    e = cfg.moe
    dropped = int((s_r == e.num_experts * cap).sum())
    if not torch.equal(d_a, d_r) or not torch.equal(s_a, s_r):
        fail(f"deepseek-v3 MoE layer: the card's dispatch differs from the "
             f"CPU's in {int((d_a != d_r).sum())} expert slots and "
             f"{int((s_a != s_r).sum())} token slots")
    scale = float(o_r.abs().max())
    # One bf16 ulp of m * 2^e (m in [0.5, 1)) is 2^(e - 8).
    ulp = 2.0 ** (int(torch.frexp(o_r.abs().max()).exponent) - 8)
    err = float((o_a - o_r).abs().max())
    if not bool(torch.isfinite(o_a).all()) or err > 2 * ulp:
        fail(f"deepseek-v3 MoE layer card vs CPU: max_abs_err {err:.3e} vs "
             f"2 bf16 ulps of max|out| {scale:.3e}: {2 * ulp:.3e}")
    print(f"moe check: deepseek-v3 layer 3 on 64 rows, card vs CPU plain: "
          f"dispatch identical ({e.num_experts} experts x capacity {cap}, "
          f"{64 * e.num_experts_per_tok - dropped} assignments kept, "
          f"{dropped} dropped); output max_abs_err {err:.3e} (bound 2 bf16 "
          f"ulps of max|out| {scale:.3e}: {2 * ulp:.3e}); "
          f"{time.perf_counter() - t0:.1f} s with the CPU copy", flush=True)


def check_moe_models(torch, dev, serve, ds, gr) -> None:
    """The MoE models' checks, after every timed serve: the 2-layer decode
    steps against the CPU path (deepseek-v3's 2 dense MLA layers on bf16
    and int8 pages, granite-moe's first 2 MoE layers), deepseek-v3's MoE
    layer alone against the CPU path, its time and transient, and a
    profiled serve of each."""
    _, cfg, model, params = ds
    check_step_vs_cpu(torch, dev, params, cfg, "q8_0")
    check_step_vs_cpu(torch, dev, params, cfg, "q8_0", kv_quant="int8")
    check_moe_vs_cpu(torch, dev, cfg, params)
    time_moe_layer(torch, dev, cfg, params)
    profile_serve(torch, serve, cfg, model, params, dev, "q8_0",
                  arena=DEEPSEEK_ARGS[:-8],
                  label=f"deepseek-v3 ({cfg.num_layers} layers) q8_0")
    _, cfg, model, params = gr
    check_step_vs_cpu(torch, dev, params, cfg, "q8_0")
    profile_serve(torch, serve, cfg, model, params, dev, "q8_0",
                  arena=GRANITE_ARGS[:-8], label="granite-moe q8_0")


def record_routes(torch, mla_only=False):
    """Count, from here on, which kernel each attention and matmul launch
    takes (the wrappers pick by dtype): {route: launches}. Every model
    path passes bf16 activations (and the MLA form bf16 or int8 pages),
    so the f32 (CUDA-core) routes must stay at 0. ``mla_only``: the MLA
    form's two kernels alone."""
    from repro_torch.kernels import _dequant_matmul as dm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    seen = {}

    def counted(fn, label, arg=None):
        def run(*a, **kw):
            route = label if arg is None else label + (
                " bf16 (tensor cores)" if a[arg].dtype == torch.bfloat16
                else " f32 (CUDA cores)")
            seen[route] = seen.get(route, 0) + 1
            return fn(*a, **kw)
        return run
    pa._launch_mla_tc = counted(pa._launch_mla_tc,
                                "paged MLA bf16 (tensor cores)")
    pa._launch_mla_cc = counted(pa._launch_mla_cc,
                                "paged MLA f32 (CUDA cores)")
    if mla_only:
        return seen
    fa._launch = counted(fa._launch, "flash", 0)
    pa._launch_gqa = counted(pa._launch_gqa, "paged GQA", 0)
    dm.launch = counted(dm.launch, "matmul", 2)     # launch(wrapper, name, x)
    return seen


def check_routes(routes, label, kinds):
    """Fail unless every launch of ``kinds`` took the bf16 route, and
    each kind took it at least once."""
    bad = {k: v for k, v in routes.items() if "f32" in k and v}
    missing = [k for k in kinds if not routes.get(f"{k} bf16 (tensor cores)")]
    if bad or missing:
        fail(f"routes of {label}: {routes} (every model path passes bf16: "
             "tensor cores only)")
    print(f"routes of {label}: {routes}", flush=True)


def main() -> None:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"missing dependency: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: chip_smoke needs a CUDA "
             "device")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("src/repro_torch not found next to chip_smoke.py: run it from "
             "a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}"
          f" | {torch.cuda.get_device_name(0)}", flush=True)

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    try:
        libs = _build.build_all()
    except Exception as e:                              # noqa: BLE001
        fail(f"kernel build: {e}")
    print(f"build: {len(libs)} kernel libraries ready in "
          f"{time.perf_counter() - t0:.1f} s (nvcc, one process per source)"
          f" -> {', '.join(p.name for p in libs.values())}", flush=True)

    kernels = [check_matmul(torch, dev, name) for name in MATMULS]
    kernels.append(check_paged_attention(torch, np, dev))
    kernels.append(check_paged_int8(torch, np, dev))
    kernels.append(check_flash(torch, dev))
    kernels += check_paged_mla(torch, np, dev)
    print(f"chip_smoke: kernel phase done at {time.perf_counter() - T0:.1f} "
          "s", flush=True)

    from repro_torch.launch import serve
    routes = record_routes(torch)
    by_serve = {}
    for quant in RECIPE_LAUNCHES:
        by_serve[quant] = serve_recipe(torch, dev, serve, quant)
    by_serve["q8_0 kv-int8"] = serve_recipe(
        torch, dev, serve, "q8_0", extra=["--kv-quant", "int8"],
        per_step=INT8_LAUNCHES, tag="serve q8_0 kv-int8")
    by_serve["batch"] = serve_batch(torch, dev, serve)
    by_serve["prefill"] = run_prefill(torch, dev, serve)
    ds = recipe_setup(torch, dev, serve, "q8_0", argv=DEEPSEEK_ARGS,
                      layers=DEEPSEEK_LAYERS)
    by_serve["deepseek-v3"] = serve_recipe(
        torch, dev, serve, "q8_0", per_step=DEEPSEEK_LAUNCHES,
        tag="serve deepseek-v3 q8_0", argv=DEEPSEEK_ARGS, setup=ds)
    by_serve["deepseek-v3 kv-int8"] = serve_recipe(
        torch, dev, serve, "q8_0", extra=["--kv-quant", "int8"],
        per_step=DEEPSEEK_INT8_LAUNCHES, tag="serve deepseek-v3 q8_0 "
        "kv-int8", argv=DEEPSEEK_ARGS, setup=ds)
    by_serve["deepseek-v3 prefill"] = run_prefill(
        torch, dev, serve, repeats=2, setup=ds,
        per_prefill=DEEPSEEK_PREFILL_LAUNCHES)
    gr = recipe_setup(torch, dev, serve, "q8_0", argv=GRANITE_ARGS)
    by_serve["granite-moe"] = serve_recipe(
        torch, dev, serve, "q8_0", per_step=GRANITE_LAUNCHES,
        tag="serve granite-moe q8_0", argv=GRANITE_ARGS, setup=gr)
    pf = recipe_setup(torch, dev, serve, "q8_0")
    by_serve.update(serve_prefix(torch, dev, serve, pf,
                                 RECIPE_LAUNCHES["q8_0"], "q8_0", card,
                                 warm=True))
    by_serve.update(serve_prefix(torch, dev, serve, pf, INT8_LAUNCHES,
                                 "q8_0_kv-int8", card,
                                 extra=["--kv-quant", "int8"]))
    by_serve.update(serve_prefix(torch, dev, serve, ds, DEEPSEEK_LAUNCHES,
                                 "deepseek-v3", card, argv=DEEPSEEK_ARGS,
                                 warm=True))
    check_cow(torch, dev, serve)
    t_spec = time.perf_counter()
    runs, plain06 = serve_spec(torch, dev, serve, pf, RECIPE_LAUNCHES["q8_0"],
                               "q8_0", card)
    by_serve.update(runs)
    by_serve.update(serve_spec(torch, dev, serve, pf, INT8_LAUNCHES,
                               "q8_0_kv-int8", card,
                               extra=["--kv-quant", "int8"])[0])
    by_serve.update(serve_spec_prefix(torch, dev, serve, pf, card))
    by_serve.update(serve_draft(torch, dev, serve, pf, plain06, card))
    del pf, plain06
    by_serve.update(serve_spec(torch, dev, serve, ds, DEEPSEEK_LAUNCHES,
                               "deepseek-v3", card, argv=DEEPSEEK_ARGS,
                               strict=False)[0])
    check_rollback(torch, dev, serve)
    print(f"chip_smoke: spec phase took {time.perf_counter() - t_spec:.1f} s"
          f"; serves done at {time.perf_counter() - T0:.1f} s", flush=True)
    check_routes(routes, "the serves and prefills",
                 ("flash", "paged GQA", "paged MLA", "matmul"))
    for quant in RECIPE_LAUNCHES:
        check_recipe(torch, dev, serve, quant)
    check_moe_models(torch, dev, serve, ds, gr)
    del ds, gr

    check_routes({k: v for k, v in routes.items() if "matmul" not in k},
                 "the model paths' attention (serves, prefills, checks)",
                 ("flash", "paged GQA", "paged MLA"))
    for k in kernels:
        k["launches"] = sum(c.get(k["name"], 0) for c in by_serve.values())
        k["launches_by_run"] = {q: c[k["name"]] for q, c in by_serve.items()
                                if c.get(k["name"])}
        if not k["launches"] and k.get("main_path", True):
            fail(f"{k['name']} was launched no time on the main path")
    print(f"chip_smoke: {time.perf_counter() - T0:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
