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
            table; matmul_q8_0 also at mamba2's and jamba's projection
            widths, B1 at jamba's G = 4 and B7 at its prefill, B1 at
            whisper's G = 1 / D 64 and qwen2-vl's G = 6 / D 128, B7
            non-causal at whisper's encoder and cross shapes and at
            qwen2-vl's prefill; the dense configs' shapes: matmul_q8_0 at
            K 16,384 / 29,568 / 53,248 and lm_heads of 128,256 and
            152,064 rows, B1 at G = 3, 8, 16 and B8 at G = 16, B7 at
            their 8 x 512 prefills; B7's backward (autograd) against
            autograd of the plain version at G = 2 and 16, timed; the
            matmuls and B1/B8 on column, row, kv-head and slot blocks
            launched with ``plan_parts``, and B9 on head blocks (of 8
            at decode, of 2, 4 and 8 with chunks of 8 and 4) and on two
            'data' halves of 8 slots at unequal depths, launched with
            the whole call's plan inputs (``MlaPlan``), bit-equal to
            their whole calls (``check_shard_plans``);
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
   recurrent — (run first, before any profiler session) mamba2-1.3b
            at full width and depth (48 SSD layers) and jamba-v0.1-52b at
            full width over one 8-layer period (Mamba + attention + MoE):
            ``--mode batch``, the stream (q8_0, bf16 pages beside
            per-slot SSM state) and an 8 x 512 prefill each, with exact
            launches per step and prefill;
   conditioned — (after the recurrent runs, before any profiler
            session) whisper-small at full width and depth (12 encoder
            + 12 decoder layers; the encoder pass at each admission, the
            cross K/V a per-slot state) and qwen2-vl-2b (28 layers,
            M-RoPE, a 256-token stub vision prefix, 256-512-token
            prompts): ``--mode batch``, the stream and a prefill each,
            with exact launches per step, per admission and per
            prefill;
   dense  — (after the conditioned runs, before any profiler session)
            the remaining dense configs at full width (q8_0):
            llama3.2-3b (28 layers, tied embeddings), qwen2-72b cut to
            8 of 80 layers (qkv bias) and llama3-405b cut to 4 of 126
            (128 heads over 8 kv-heads, G = 16): ``--mode batch``, the
            stream (llama3-405b also on int8 pages) and an 8 x 512
            prefill each, exact launches per step and prefill, and the
            peak device memory;
   train  — the paper's train -> quantize -> serve flow: the port's
            trainer on full-width, full-depth qwen3-0.6b (bf16, 8 x 512
            copy task) for 20 steps through ``ElasticRunner`` (the loss
            falls below 0.9x its first value; step ms, train tokens/s),
            exactly 28 flash launches a step (the attention's forward;
            its backward is plain PyTorch) and no other kernel, 56 under
            ``--remat full`` or 2 microbatches, int8 gradient
            compression and ``dots_saveable`` too; a 2-layer cut's train
            step against the CPU path; a failure injected at step 5
            restored from a checkpoint; the trained weights quantized to
            q8_0 serve the stream with 197 + 28 launches a step and a
            2-layer step checked against the CPU path;
5. checks — per recipe, one full-width decode step (depth cut to 2
            layers) against the plain CPU path, and a shorter serve under
            torch.profiler; for q8_0 also a 2-layer prefill and a 2-layer
            decode step on int8 pages against the CPU path; deepseek-v3
            cut to its 2 dense MLA layers (bf16 and int8 pages) and
            granite-moe cut to 2 MoE layers against the CPU path, the
            deepseek-v3 MoE layer's device time and transient memory,
            and a profiled serve of each; the recurrent models'
            profiled prefills (the SSD's device ms; mamba2 cut to 8
            layers), mamba2's two 2-layer
            steps on per-slot state against the CPU path and its padded
            chunk
            bit-exact on the card, jamba's block-0 mamba, attention (B1
            at G = 4) and MoE layers against the CPU path, and a
            profiled serve of each (the phase's seconds printed); the
            CPU path of mamba2's 2-layer steps again with every in_proj
            output moved one bf16 ulp, to show how far rounding alone
            spreads each layer's state; whisper's and qwen2-vl's 2-layer
            steps (whisper after its admission pass, qwen2-vl across the
            vision/text boundary) against the CPU path and a profiled
            serve of each; the dense configs' steps (2 layers;
            llama3-405b 1) against the CPU path and a profiled serve of
            each;
   mesh   — (after the MoE checks, their weights freed) the serving
            meshes: the launcher's refusals (``--tp 3``, a mesh larger
            than the card x ``--ranks-per-device``), then 4 ranks on
            cuda:0 over gloo (``serve_mesh``): qwen3-0.6b at 1x2, 2x1
            and 2x2, on int8 pages at 1x2, with the prefix cache at
            2x1 and n-gram speculation at 1x2, deepseek-v3 (4 layers)
            at 1x2 and 2x1 and granite-moe at 2x1, each beside a 1x1
            run of the same flags: tokens equal (deepseek-v3 at 1x2 by
            the near-tie rule), every step's logits bit-equal (qwen3,
            and deepseek-v3 at 2x1 on both replicas, whose B9 plans
            from the whole step; compared and printed for the others),
            one device's launches a step and the layer structure's
            collectives a step on every rank;
   dryrun — the port's dry-run (``repro_torch.launch.dryrun``) of
            qwen3-0.6b's train_4k and decode_32k cells on 16x16 fake
            ranks, counted on the CPU by a child process that sees no
            card, started after the build and read after the checks:
            per-device flops, bytes and collectives and the three
            roofline terms at the H100's published peaks;
6. the ``kernels`` JSON line, then the device JSON line, last.

It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
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

# The recurrent phase: the same stream (q8_0, bf16 pages) for mamba2 (SSD,
# attention-free) at full width and depth, and jamba (Mamba + attention +
# MoE) at full width over one 8-layer period (32 layers cut to 8: one of
# each layer kind; the full depth does not fit one card), then --mode
# batch and an 8 x 512 prefill of each.
MAMBA_ARGS = ["--arch", "mamba2-1.3b"] + SERVE_ARGS[2:]
JAMBA_ARGS = ["--arch", "jamba-v0.1-52b"] + SERVE_ARGS[2:]
JAMBA_LAYERS = 8
# Per step (and per prefill): mamba2's 48 x (in_proj, out_proj) and its
# tied lm_head, no attention; jamba's 7 mamba layers x 2, the attention
# layer's q/k/v/o, 4 dense SwiGLUs x 3 and the lm_head (the MoE experts
# run on torch.bmm), and one attention (paged on the stream's arena, flash
# in the prefill, plain PyTorch on the batch's contiguous arena).
MAMBA_LAUNCHES = {"matmul_q8_0": 97}
JAMBA_LAUNCHES = {"matmul_q8_0": 31, "paged_decode_attention": 1}
MAMBA_PREFILL_LAUNCHES = {"matmul_q8_0": 97}
JAMBA_PREFILL_LAUNCHES = {"matmul_q8_0": 31, "flash_attention": 1}
# matmul_q8_0 at their projections' widths (label, N, K, launches a step).
RECURRENT_LINEARS = [
    ("mamba2 in_proj", 8512, 2048, 48), ("mamba2 out_proj", 2048, 4096, 48),
    ("mamba2 lm_head", 50280, 2048, 1),
    ("jamba in_proj", 16544, 4096, 7), ("jamba out_proj", 4096, 8192, 7),
    ("jamba lm_head", 65536, 4096, 1)]
# jamba's prefill attention: (B, S, H, Hkv, D) bf16, causal.
FLASH_JAMBA = (8, 512, 32, 8, 128)
# (label, serve argv, depth cut, launches per step, per prefill)
RECURRENT = (("mamba2", MAMBA_ARGS, None, MAMBA_LAUNCHES,
              MAMBA_PREFILL_LAUNCHES),
             ("jamba", JAMBA_ARGS, JAMBA_LAYERS, JAMBA_LAUNCHES,
              JAMBA_PREFILL_LAUNCHES))
# The recurrent checks' depth (their timed serves and prefill above run
# at full depth): mamba2's profiled prefill and serve run 8 of its 48
# layers, which keeps the whole script inside its time limit beside the
# serving meshes' and the dry-run's phases; its step checks cut to 2
# layers.
RECURRENT_CHECK_LAYERS = {"mamba2": 8}

# The conditioned phase, at full width and depth (q8_0, bf16 pages, the
# launcher's zero stub frames / vision embeddings): whisper-small (12
# encoder + 12 decoder layers) on the stream above, and qwen2-vl-2b (28
# layers) on 256-512-token prompts, so every prompt holds the whole
# 256-token vision prefix and some text (320 blocks: no slot is
# preempted); then --mode batch and a prefill of each.
WHISPER_ARGS = ["--arch", "whisper-small"] + SERVE_ARGS[2:]
QWEN2VL_ARGS = ["--arch", "qwen2-vl-2b"] + SERVE_ARGS[2:8] + [
    "--num-blocks", "320", "--requests", "16", "--prompt-len", "512",
    "--gen", "32", "--arrival", "back2back"]
# Per step: whisper's 12 decoder layers x 8 linears (self q/k/v/o, cross
# q/o, fc1/fc2) and the tied lm_head, one B1 a layer (a decode step's
# cross attention is plain PyTorch, as the JAX package leaves it to XLA);
# per admission, the encoder pass: 12 encoder layers x 6 linears, 12 x 2
# cross K/V projections, one B7 a layer. qwen2-vl: 28 x 7 linears and the
# tied lm_head, one B1 (G = 6) a layer.
WHISPER_LAUNCHES = {"matmul_q8_0": 97, "paged_decode_attention": 12}
WHISPER_ADMIT_LAUNCHES = {"matmul_q8_0": 96, "flash_attention": 12}
QWEN2VL_LAUNCHES = {"matmul_q8_0": 197, "paged_decode_attention": 28}
# Per prefill: whisper's encoder (72 linears, 12 B7), decoder (12 x 10
# linears, 12 causal self and 12 non-causal cross B7) and lm_head over
# 8 x 128 decoder tokens; qwen2-vl's 197 linears and 28 B7 over 8 x 512
# tokens behind the vision prefix.
WHISPER_PREFILL_LAUNCHES = {"matmul_q8_0": 193, "flash_attention": 36}
QWEN2VL_PREFILL_LAUNCHES = {"matmul_q8_0": 197, "flash_attention": 28}
# (label, serve argv, per step, per admission, per prefill, prefill shape)
CONDITIONED = (("whisper", WHISPER_ARGS, WHISPER_LAUNCHES,
                WHISPER_ADMIT_LAUNCHES, WHISPER_PREFILL_LAUNCHES, (8, 128)),
               ("qwen2-vl", QWEN2VL_ARGS, QWEN2VL_LAUNCHES, None,
                QWEN2VL_PREFILL_LAUNCHES, PREFILL_SHAPE))
# B7 at the conditioned shapes: (label, B, Sq, Skv, H, Hkv, D, causal,
# calls a prefill), bf16.
FLASH_CONDITIONED = [
    ("whisper encoder", 8, 1500, 1500, 12, 12, 64, False, 12),
    ("whisper cross", 8, 128, 1500, 12, 12, 64, False, 12),
    ("qwen2-vl prefill", 8, 512, 512, 12, 2, 128, True, 28)]

# The dense phase: the three remaining dense configs at full width (q8_0,
# bf16 pages), the stream above, --mode batch and an 8 x 512 prefill each.
# llama3.2-3b runs whole (28 layers, tied embeddings); qwen2-72b (qkv
# bias) is cut to 8 of its 80 layers and llama3-405b (128 heads over 8
# kv-heads, G = 16) to 4 of 126 (full depth needs 74.6 and 427 GB of
# q8_0 planes). Per step and per prefill: layers x 7 linears and the
# lm_head (tied or not), one attention a layer; llama3-405b also serves
# on int8 pages (B8 at G = 16). (label, depth cut or None, the step
# check's depth, per step, per prefill, per step on int8 pages or None)
DENSE = (("llama3.2-3b", None, 2,
          {"matmul_q8_0": 197, "paged_decode_attention": 28},
          {"matmul_q8_0": 197, "flash_attention": 28}, None),
         ("qwen2-72b", 8, 2,
          {"matmul_q8_0": 57, "paged_decode_attention": 8},
          {"matmul_q8_0": 57, "flash_attention": 8}, None),
         ("llama3-405b", 4, 1,
          {"matmul_q8_0": 29, "paged_decode_attention": 4},
          {"matmul_q8_0": 29, "flash_attention": 4},
          {"matmul_q8_0": 29, "paged_decode_attention_int8": 4}))
# matmul_q8_0 at the dense configs' new widths (label, N, K, launches a
# step at the cut depth): K 16,384 and 53,248 (llama3-405b), 29,568
# (qwen2-72b: its q8_0 scale row, 924 halves, is not 16-byte aligned),
# and the lm_heads of 128,256 and 152,064 rows.
DENSE_LINEARS = [
    ("llama3-405b q/o", 16384, 16384, 8),
    ("llama3-405b gate/up", 53248, 16384, 8),
    ("llama3-405b down", 16384, 53248, 4),
    ("llama3-405b lm_head", 128256, 16384, 1),
    ("qwen2-72b gate/up", 29568, 8192, 16),
    ("qwen2-72b down", 8192, 29568, 8),
    ("qwen2-72b lm_head", 152064, 8192, 1)]
# B1 (and B8) and B7 at the dense configs' groups: (label, H, Hkv,
# attention layers a step or prefill), D = 128.
DENSE_HEADS = [("llama3.2-3b", 24, 8, 28), ("qwen2-72b", 64, 8, 8),
               ("llama3-405b", 128, 8, 4)]

# The train phase: the trainer (train/*) on full-width, full-depth
# qwen3-0.6b, bf16 weights (quant none), batch 8 x 512 of the copy task
# over a pool of 2 batches, lr 3e-3; 28 B7 a step (forward; its backward
# is plain PyTorch), twice that under --remat full (the forward runs
# again in the backward) or with 2 microbatches; no matmul or paged
# kernel (every linear is a bf16 product, as in the JAX package).
TRAIN_SHAPE = (8, 512)
TRAIN_STEPS = 20
TRAIN_LAUNCHES = {"flash_attention": 28}


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
        t_k, t_p, t_l, nbytes, flops = _time_matmul(
            torch, name, x, planes, dequantize)
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


def _time_matmul(torch, name, x, planes, dequantize):
    """(kernel ms, plain ms, library ms, bytes, flops) of one matmul of
    the bf16 rows ``x`` (M, K) by ``planes`` (N, K), the kernel giving
    the serving layers' bf16 output; the calls cycle through enough
    copies of the weights (up to 150 MB) that they stream from HBM, not
    from the 50 MB L2. Timing launches do not count."""
    from repro_torch.kernels.ops import MATMUL_KERNELS
    from repro_torch.kernels.ref import matmul_ref
    fmt = MATMULS[name][0]
    wrapper, layout = MATMUL_KERNELS[fmt]
    kw = {"approx_cvt53": True} if name in OFF_MAIN_PATH else {}
    (m, k), n = x.shape, next(iter(planes.values())).shape[0]
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
    del cps, wf
    return t_k, t_p, t_l, wbytes + x.numel() * 2 + m * n * 2, \
        2.0 * m * n * k


def time_matmul_recurrent(torch, dev, linears=RECURRENT_LINEARS):
    """matmul_q8_0 at other models' projection widths at the step's M = 64
    — ``linears``: the recurrent models' (RECURRENT_LINEARS: N tails off
    the 128-wide tile (8,512, 50,280) and K 8,192) or the dense configs'
    (DENSE_LINEARS: K 16,384, 29,568 and 53,248, lm_heads of 128,256 and
    152,064 rows) — against the plain version (2e-5 of the output's
    scale, bf16 output the f32 one rounded), timed beside the plain
    version and cuBLAS f32 with the bound. Returns {shape: numbers} and
    each model's per-step totals of these shapes."""
    from repro_torch.core.quant import dequant, pack
    from repro_torch.kernels.ops import MATMUL_KERNELS
    from repro_torch.kernels.ref import matmul_ref
    wrapper, layout = MATMUL_KERNELS["q8_0"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    out, steps = {}, {}
    for shape, n, k, count in linears:
        m = M_STEP
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        planes = pack.quantize(
            torch.randn((n, k), generator=gen, device=dev) * 0.02, "q8_0")
        args = [planes[p] for p in layout]
        y = wrapper(x, *args)
        y16 = wrapper(x, *args, out_dtype=torch.bfloat16)
        ref = matmul_ref(x, planes, "q8_0")
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        tol = 2e-5 * max(1.0, float(ref.abs().max()))
        if not bool(torch.isfinite(y).all()) or err > tol \
                or not torch.equal(y16, y.to(torch.bfloat16)):
            fail(f"matmul_q8_0 {shape} ({m}x{n}x{k}): max_abs_err "
                 f"{err:.3e} > {tol:.3e}, or the bf16 output is not the "
                 "f32 result rounded")
        del y, y16, ref
        t_k, t_p, t_l, nbytes, flops = _time_matmul(
            torch, "matmul_q8_0", x, planes, dequant.DEQUANTIZERS["q8_0"])
        b_ms, b_by = bound(nbytes, flops)
        print(f"kernel matmul_q8_0 {shape} M={m} N={n} K={k}: max_abs_err "
              f"{err:.3e} (tol {tol:.3e}), bf16 out = f32 out rounded | "
              f"bf16-out kernel {t_k:.4f} ms | plain {t_p:.4f} ms | "
              f"library(torch.matmul f32, pre-dequantized) {t_l:.4f} ms | "
              f"bound {b_ms:.4f} ms ({b_by}) | x{count} per step", flush=True)
        out[shape] = dict(m=m, n=n, k=k, per_step=count, max_abs_err=err,
                          ms=t_k, plain_ms=t_p, library_ms=t_l,
                          bound_ms=b_ms, bound_by=b_by)
        model = shape.split()[0]
        tot = steps.setdefault(model, dict(ms=0.0, plain_ms=0.0,
                                           library_ms=0.0, bytes=0.0,
                                           flops=0.0))
        for key, v in (("ms", t_k), ("plain_ms", t_p), ("library_ms", t_l),
                       ("bytes", nbytes), ("flops", flops)):
            tot[key] += count * v
        del x, planes, args
    for model, tot in steps.items():
        b_ms, b_by = bound(tot.pop("bytes"), tot.pop("flops"))
        tot.update(bound_ms=b_ms, bound_by=b_by)
        print(f"kernel matmul_q8_0 {model}'s timed projections and "
              f"lm_head per step: kernel {tot['ms']:.4f} ms | plain "
              f"{tot['plain_ms']:.4f} ms | library {tot['library_ms']:.4f} "
              f"ms | bound {b_ms:.4f} ms ({b_by})", flush=True)
    torch.cuda.empty_cache()
    return dict(shapes=out, per_step=steps)


def time_flash_at(torch, dev, label, b, sq, skv, h, hkv, d, causal,
                  per_prefill, seed=13):
    """flash_attention at one model's prefill widths (bf16) against
    attention_ref, timed beside the plain version and SDPA with the bound
    (``per_prefill`` calls a prefill). Returns those numbers (an extra
    key of the flash row)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q = torch.randn((b, sq, h, d), generator=gen, device=dev).to(
        torch.bfloat16)
    k, v = (torch.randn((b, skv, hkv, d), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    out = flash_attention(q, k, v, causal=causal)
    ref = attention_ref(q.float(), k.float(), v.float(), causal=causal)
    torch.cuda.synchronize()
    err = float((out.float() - ref).abs().max())
    if not bool(torch.isfinite(out.float()).all()) or \
            not within_one_ulp(torch, out, ref, 1e-4, 1e-4):
        fail(f"flash_attention {label} widths: max_abs_err {err:.3e}")
    del ref
    launches0 = flash_attention.launches
    t_k = time_ms(torch, [lambda: flash_attention(q, k, v, causal=causal)],
                  20)
    flash_attention.launches = launches0
    t_p = time_ms(torch, [lambda: attention_ref(q, k, v, causal=causal)], 5)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    t_l = time_ms(torch, [lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=causal, enable_gqa=True)], 20)
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    pairs = sq * (sq + 1) // 2 if causal else sq * skv  # visible (i, j)
    flops = 4.0 * b * h * d * pairs
    b_ms, b_by = bound(nbytes, flops)
    print(f"kernel flash_attention {label} bf16 B={b} Sq={sq} Skv={skv} "
          f"H={h} Hkv={hkv} D={d} causal={causal}: max_abs_err {err:.3e} "
          f"(rtol/atol 1e-4 of the f32 plain version + one bf16 ulp) | "
          f"kernel {t_k:.4f} ms | plain {t_p:.4f} ms | library(SDPA "
          f"is_causal={causal}, enable_gqa) {t_l:.4f} ms | bound "
          f"{b_ms:.5f} ms ({b_by}) | x{per_prefill} per prefill", flush=True)
    del q, k, v, qh, kh, vh, out
    torch.cuda.empty_cache()
    return dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=err, per_prefill=per_prefill)


def time_flash_jamba(torch, dev):
    """flash_attention at jamba's prefill widths (FLASH_JAMBA: H 32, Hkv
    8, D 128, 8 x 512, bf16, causal; one attention layer a prefill)."""
    b, s, h, hkv, d = FLASH_JAMBA
    return time_flash_at(torch, dev, "jamba prefill", b, s, s, h, hkv, d,
                         True, 1)


def time_flash_conditioned(torch, dev):
    """flash_attention at whisper's encoder and cross shapes (non-causal,
    D 64, 1,500 keys) and qwen2-vl's prefill (G = 6): {label: numbers}."""
    return {c[0]: time_flash_at(torch, dev, *c) for c in FLASH_CONDITIONED}


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


def _paged_case(torch, np, dev, dtype, H=16, D=128, MB=16, Hkv=8):
    """Full-width paged attention operands: fragmented, permuted and
    partly null tables, mixed lengths, every slot active; qwen3-0.6b's
    heads by default (H = 16, Hkv = 8, D = 128), MB pages of 16 keys a
    slot (the serve's 256-key table by default)."""
    B, C, bs = 8, 8, 16
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
                ms_per_call=t_k,
                granite=time_paged_widths(torch, np, dev, "granite-moe", 24,
                                          64, 32),
                jamba=time_paged_widths(torch, np, dev, "jamba", 32, 128, 1),
                whisper=time_paged_widths(torch, np, dev, "whisper", 12, 64,
                                          12, Hkv=12),
                qwen2_vl=time_paged_widths(torch, np, dev, "qwen2-vl", 12,
                                           128, 28, Hkv=2),
                dense={label: time_paged_widths(torch, np, dev, label, h,
                                                128, n, Hkv=hkv)
                       for label, h, hkv, n in DENSE_HEADS},
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


def time_paged_widths(torch, np, dev, label, H, D, per_step, Hkv=8,
                      kv="bf16"):
    """The GQA form at another model's decode widths (Hkv = 8: H = 24,
    D = 64 is granite-moe's G = 3 in two 16-row tiles; H = 32, D = 128
    is jamba's G = 4; whisper's H = Hkv = 12, D = 64 is G = 1; qwen2-vl's
    H = 12 over Hkv = 2, D = 128 is G = 6; the dense configs' H = 24, 64
    and 128 over Hkv = 8, D = 128 are G = 3, 8 and 16), bf16 q on bf16
    pages, or on int8 code pages with fp16 scales (``kv="int8"``, B8),
    against the plain version, timed per call and per step
    (``per_step`` attention layers) beside the plain version and SDPA on
    the gathered (dequantized) view, with the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.ref import paged_attention_ref
    from repro_torch.models.attention import quantize_kv
    c = _paged_case(torch, np, dev, torch.float32 if kv == "int8"
                    else torch.bfloat16, H=H, D=D, Hkv=Hkv)
    q = c["q"].to(torch.bfloat16)
    kw = {}
    kp, vp = c["kp"], c["vp"]
    if kv == "int8":
        (kp, ks), (vp, vs) = quantize_kv(kp), quantize_kv(vp)
        kw = dict(k_scales=ks, v_scales=vs)
    args = (q, kp, vp, c["tables"], c["pos"])
    counter = "int8_launches" if kv == "int8" else "launches"
    out = paged_decode_attention(*args, sm_scale=c["sm"], lengths=c["lens"],
                                 **kw)
    ref = paged_attention_ref(q.float(), *args[1:], sm_scale=c["sm"], **kw)
    torch.cuda.synchronize()
    err = 0.0
    for b in range(out.shape[0]):
        n = int(c["np_lens"][b])
        o, r = out[b, :n], ref[b, :n]
        # bf16 pages: the bf16 check of check_paged_attention; int8:
        # check_paged_int8's (f32 tolerance + one bf16 ulp).
        ok = torch.allclose(o.float(), r, rtol=2 ** -7, atol=1e-3) \
            if kv == "bf16" else within_one_ulp(torch, o, r, 2e-5, 2e-6)
        if not bool(torch.isfinite(o.float()).all()) or not ok:
            fail(f"paged_decode_attention {kv} pages {label} widths slot "
                 f"{b}: max_abs_err {float((o.float() - r).abs().max()):.3e}")
        err = max(err, float((o.float() - r).abs().max()))
    launches0 = getattr(paged_decode_attention, counter)
    t_k = time_ms(torch, [lambda: paged_decode_attention(
        *args, sm_scale=c["sm"], lengths=c["lens"], **kw)], 200)
    setattr(paged_decode_attention, counter, launches0)
    t_p = time_ms(torch, [lambda: paged_attention_ref(
        *args, sm_scale=c["sm"], **kw)], 50)
    B, C, H, D = q.shape
    G = H // Hkv
    tb = c["tables"].long()
    kv_view = [(x[tb].float() * sc[tb].float()[..., None]).to(torch.bfloat16)
               if kv == "int8" else x[tb]
               for x, sc in ((kp, kw.get("k_scales")),
                             (vp, kw.get("v_scales")))]
    kv_view = [x.flatten(1, 2).repeat_interleave(G, dim=2).transpose(1, 2)
               .contiguous() for x in kv_view]
    depth = c["pos"].long()[:, None] + torch.arange(C, device=dev) + 1
    mask = (torch.arange(kv_view[0].shape[2], device=dev)[None, None, :]
            < depth[:, :, None])[:, None]             # (B, 1, C, S)
    qh = q.transpose(1, 2).contiguous()
    t_l = time_ms(torch, [lambda: F.scaled_dot_product_attention(
        qh, kv_view[0], kv_view[1], attn_mask=mask, scale=c["sm"])], 200)
    _, keys = _live_pages(c)
    per_key = D * (1 if kv == "int8" else 2) + (2 if kv == "int8" else 0)
    nbytes = keys * Hkv * per_key * 2 + 2 * q.numel() * 2 \
        + c["tables"].numel() * 4 + 2 * B * 4
    b_ms, b_by = bound(nbytes, keys * Hkv * (C * G) * 4 * D)
    print(f"kernel paged_decode_attention {kv} pages {label} widths B={B} "
          f"C={C} H={H} Hkv={Hkv} D={D} (G={G}): max_abs_err {err:.3e} "
          f"({'rtol 2^-7 atol 1e-3' if kv == 'bf16' else 'rtol 2e-5 atol 2e-6 + one bf16 ulp'}) | kernel {t_k:.4f} ms | plain "
          f"{t_p:.4f} ms | library(SDPA on gathered view) {t_l:.4f} ms | "
          f"bound {b_ms:.5f} ms ({b_by}) | per step x{per_step}: kernel "
          f"{per_step * t_k:.4f} ms", flush=True)
    return dict(ms_per_call=t_k, plain_ms=t_p, library_ms=t_l,
                bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                per_step=per_step)


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
                ms_per_call=t_k,
                llama3_405b=time_paged_widths(torch, np, dev, "llama3-405b",
                                              128, 128, 4, kv="int8"))


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
                deepseek_prefill=check_flash_mla(torch, dev),
                jamba_prefill=time_flash_jamba(torch, dev),
                conditioned=time_flash_conditioned(torch, dev),
                dense=time_flash_dense(torch, dev),
                backward=check_flash_backward(torch, dev))


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


def _cut_to(params, model):
    """The weights of ``model`` (a depth cut whose layers all sit in group
    layers0) taken from the full model's ``params``: the first
    ``model.cfg.num_layers`` layers of layers0, no other layer group."""
    from repro_torch.models.lm import layer_groups
    n = model.cfg.num_layers
    assert [(g, c) for g, c, _ in layer_groups(model.cfg)] == \
        [("layers0", n)]
    return {k: (v[:n] if k == "layers0" else v) for k, v in params.items()
            if not k.startswith("layers") or k == "layers0"}


def check_prefill_vs_cpu(torch, dev, params, cfg, quant):
    """A full-width prefill with depth cut to 2 layers: the card (matmul
    and flash kernels) against the plain path on the CPU, same weights,
    a ragged 100-token sequence."""
    import dataclasses
    from repro_torch.models.api import build_model
    model = build_model(dataclasses.replace(cfg, num_layers=2))
    cut = _cut_to(params, model)
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


def check_step_vs_cpu(torch, dev, params, cfg, quant, kv_quant="none",
                      layers=2):
    """One full-width decode step with depth cut to ``layers`` (2) under
    recipe ``quant`` (on int8 KV pages with ``kv_quant="int8"``): the
    kernels on the card against the plain path on the CPU, same weights.
    Returns (max_abs_err, bound)."""
    import dataclasses
    from repro_torch.models.api import build_model
    small = dataclasses.replace(cfg, num_layers=layers)
    model = build_model(small)
    cut = _cut_to(params, model)
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
    print(f"step check: full-width {cfg.name} {quant} kv={kv_quant}, "
          f"{layers} layers, card kernels "
          f"vs CPU plain: logits {tuple(a.shape)} finite, max_abs_err "
          f"{worst:.3e} (bound {rel:g} x max|logit| = {rel * scale:.3e})",
          flush=True)
    return worst, rel * scale


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


def profile_prefill(torch, model, params, batch, cfg) -> None:
    """Where a prefill's time goes: one more ``model.prefill`` under
    torch.profiler, device busy against its wall time and the heaviest
    kernels (after the timed prefills and their launch check)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import ssm
    ssd0 = ssm.ssd_chunked

    def ssd(*a, **kw):                  # the SSD's device time, as a range
        with record_function("ssd_chunked"):
            return ssd0(*a, **kw)
    ssm.ssd_chunked = ssd
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.prefill(params, batch, quant="q8_0")
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        ssm.ssd_chunked = ssd0
    events, dev_us = _device_events(torch, prof)
    # The range's device-side copy spans its kernels: not a kernel itself.
    ranges = [e for e in events if e.key == "ssd_chunked"]
    events = [e for e in events if e.key != "ssd_chunked"]
    tag = f"profile prefill {cfg.name}:"
    if not events:
        print(f"{tag} the profiler recorded no device time (not measured)",
              flush=True)
        return
    if cfg.ssm is not None:
        host = [e for e in prof.key_averages() if e.key == "ssd_chunked"
                and e.device_type == torch.autograd.DeviceType.CPU]
        span = sum(dev_us(e) for e in ranges) / 1e3
        inside = sum(getattr(e, "device_time_total",
                             getattr(e, "cuda_time_total", 0.0))
                     for e in host) / 1e3
        print(f"{tag} ssd_chunked: {sum(e.count for e in host)} calls, "
              f"device time of its kernels {inside:.2f} ms (device span "
              f"of the range {span:.2f} ms)", flush=True)
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


def _shapes(tree):
    """The shape tuples of a nested dict of tensors (a cache's layout)."""
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def check_launches(tag, launches, per_step, steps, per_admit=None,
                   admits=0):
    """Fail unless ``launches`` is exactly ``per_step`` x ``steps`` (plus
    ``per_admit`` x ``admits``: an enc-dec admission's encoder pass) for
    every kernel (0 for a kernel neither names)."""
    per_admit = per_admit or {}
    want = {name: per_step.get(name, 0) * steps
            + per_admit.get(name, 0) * admits for name in launches}
    if launches != want:
        fail(f"{tag}: launches {launches} != {want} for {steps} steps"
             + (f" and {admits} admissions" if per_admit else ""))
    print(f"{tag}: kernels launched {launches} over {steps} "
          f"({per_step} per step)" + (
              f" and {admits} admissions ({per_admit} each)"
              if per_admit else ""), flush=True)
    return {name: n for name, n in launches.items() if n}


def serve_recipe(torch, dev, serve, quant, extra=(), per_step=None,
                 tag=None, argv=SERVE_ARGS, setup=None, per_admit=None):
    """Serve the stream ``argv`` at full width under recipe ``quant``
    (plus the flags ``extra``) and assert the exact kernel launches per
    step (and ``per_admit`` per admission) and every request complete;
    ``setup``: the ``recipe_setup`` of ``argv`` to reuse (its weights are
    kept), else one is made and dropped. Returns {kernel: launches in the
    serve}."""
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
                         steps, per_admit, report.sched.admitted)
    del params, engine
    torch.cuda.empty_cache()
    return out


def serve_batch(torch, dev, serve, arch="qwen3-0.6b", layers=None,
                per_step=BATCH_LAUNCHES, tag="serve batch", per_admit=None,
                dense=None):
    """``serve --mode batch --prompt-len 128 --gen 32 --batch 8`` at full
    width (q8_0; the lockstep Engine quantizes the dense weights; depth
    cut to ``layers`` if given): every token in vocab, exact launches per
    step (and ``per_admit`` for each of the 8 admissions), no paged
    attention kernel (the contiguous arena attends in plain PyTorch, as
    the JAX package's XLA does). ``dense``: the (cfg, model, dense
    params) to serve, else they are made (and dropped after)."""
    argv = ["--arch", arch, "--mode", "batch", "--prompt-len", "128",
            "--gen", "32", "--batch", "8"]
    if dense is None:
        args, cfg, model, dense = recipe_setup(torch, dev, serve, "q8_0",
                                               argv=argv, quantize=False,
                                               layers=layers)
    else:
        cfg, model, dense = dense
        args = serve.build_parser().parse_args(argv + ["--quant", "q8_0"])
    serve.reset_launches()
    t0 = time.perf_counter()
    out, stats = serve.run_batch(cfg, model, dense, args, dev)
    wall = time.perf_counter() - t0
    launches = serve.launch_counts()
    for line in serve.batch_lines(stats, args):
        print(f"{tag}: {line}", flush=True)
    print(f"{tag}: {stats.steps} steps in {wall:.2f} s (quantization "
          f"stage included), p50 step {1e3 * sorted(stats.step_s)[len(stats.step_s) // 2]:.2f} ms",
          flush=True)
    if out.shape != (args.batch, args.gen) or not (
            (out >= 0) & (out < cfg.vocab_size)).all():
        fail(f"{tag}: tokens {out.shape} not all in vocab")
    res = check_launches(tag, launches, per_step, stats.steps, per_admit,
                         args.batch)
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


def _prefill_batch(torch, dev, cfg, shape=PREFILL_SHAPE):
    """The seeded prefill batch of ``run_prefill``: (B, S) tokens, and
    the frontend inputs of a conditioned model, seeded random bf16:
    whisper's (B, 1500, d) frames, qwen2-vl's (B, 256, d) vision
    embeddings."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, shape,
                                     generator=gen, device=dev,
                                     dtype=torch.int32)}
    extra = {"encdec": ("frames", cfg.encoder_seq_len),
             "vlm": ("vision_embeds", min(cfg.vision_tokens, shape[1]))}
    if cfg.family in extra:
        key, n = extra[cfg.family]
        batch[key] = torch.randn((shape[0], n, cfg.d_model), generator=gen,
                                 device=dev).to(torch.bfloat16)
    return batch


def run_prefill(torch, dev, serve, repeats: int = 3, setup=None,
                per_prefill=PREFILL_LAUNCHES, profile=True,
                shape=PREFILL_SHAPE):
    """``model.prefill`` of ``shape`` (8 x 512) seeded tokens at full
    width (q8_0; a conditioned model's frames or vision embeddings too),
    ``repeats`` times: finite last-token logits and caches of the
    expected shapes, exact launches per prefill, prefill tokens/s; then
    one more under the profiler unless ``profile`` is False (a profiler
    session slows the process's later launches). ``setup``: a
    ``recipe_setup`` to reuse (default: qwen3-0.6b's)."""
    _, cfg, model, params = setup or recipe_setup(torch, dev, serve, "q8_0")
    b, s = shape
    batch = _prefill_batch(torch, dev, cfg, shape)
    serve.reset_launches()
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch, quant="q8_0")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = serve.launch_counts()
    want = model.cache_shapes(b, s)
    got = _shapes(cache)
    if logits.shape != (b, 1, cfg.vocab_size) or not bool(
            torch.isfinite(logits.float()).all()) or got != want or not all(
            bool(torch.isfinite(v.float()).all()) for v in _leaves(cache)):
        fail(f"prefill {cfg.name}: logits {tuple(logits.shape)} / caches "
             f"{got} (want {want}) wrong or not finite")
    best = min(times)
    print(f"prefill: full-width {cfg.name} ({cfg.num_layers} layers) q8_0, "
          f"{b} x {s} tokens: {[round(t * 1e3, 2) for t in times]} ms per "
          f"prefill, best {b * s / best:.0f} prefill tokens/s (first call "
          f"included in the list); caches {got}", flush=True)
    res = check_launches(f"prefill {cfg.name}", launches, per_prefill,
                         repeats)
    if profile:
        profile_prefill(torch, model, params, batch, cfg)
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


def check_moe_vs_cpu(torch, dev, cfg, params, lp=None,
                     label="deepseek-v3 layer 3") -> None:
    """deepseek-v3's full-width MoE layer (layer 3: 256 experts, top-8,
    capacity 4 per expert at 64 rows, so assignments drop), or the MoE
    FFN ``lp`` of another model, on the card against the CPU plain path,
    same weights and the same 8 x 8 rows as ``time_moe_layer``: which
    token fills every (expert, capacity) slot and which slots every token
    reads must be identical (a changed drop is another function), and the
    outputs agree within two bf16 ulps of the largest |out| (one for each
    rounding that another summation order can move across a boundary:
    the combine's and the shared expert's add)."""
    from repro_torch.models import moe
    if lp is None:
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
        fail(f"{label} MoE: the card's dispatch differs from the "
             f"CPU's in {int((d_a != d_r).sum())} expert slots and "
             f"{int((s_a != s_r).sum())} token slots")
    scale = float(o_r.abs().max())
    # One bf16 ulp of m * 2^e (m in [0.5, 1)) is 2^(e - 8).
    ulp = 2.0 ** (int(torch.frexp(o_r.abs().max()).exponent) - 8)
    err = float((o_a - o_r).abs().max())
    if not bool(torch.isfinite(o_a).all()) or err > 2 * ulp:
        fail(f"{label} MoE card vs CPU: max_abs_err {err:.3e} vs "
             f"2 bf16 ulps of max|out| {scale:.3e}: {2 * ulp:.3e}")
    print(f"moe check: {label} on 64 rows, card vs CPU plain: "
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


def serve_recurrent(torch, dev, serve):
    """The recurrent phase's timed runs, before any profiler session: for
    mamba2 (48 layers) and jamba (8 layers), ``--mode batch`` (dense
    weights, quantized by the lockstep Engine), then the stream and the
    8 x 512 prefill (not profiled here) on one setup, each with its exact
    launches; each model's weights are dropped before the next.
    Returns {run: launches}."""
    t0 = time.perf_counter()
    runs = {}
    for label, argv, layers, per_step, per_prefill in RECURRENT:
        runs[f"{label} batch"] = serve_batch(
            torch, dev, serve, arch=argv[1], layers=layers,
            per_step={"matmul_q8_0": per_step["matmul_q8_0"]},
            tag=f"serve {label} batch")
        setup = recipe_setup(torch, dev, serve, "q8_0", argv=argv,
                             layers=layers)
        runs[label] = serve_recipe(torch, dev, serve, "q8_0",
                                   per_step=per_step,
                                   tag=f"serve {label} q8_0", argv=argv,
                                   setup=setup)
        runs[f"{label} prefill"] = run_prefill(
            torch, dev, serve, repeats=2, setup=setup,
            per_prefill=per_prefill, profile=False)
        del setup
        torch.cuda.empty_cache()
    print(f"chip_smoke: recurrent serves took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return runs


def _paged_arena(model, d):
    """A 2-slot paged arena of ``model`` on device ``d`` (16-key blocks,
    64 positions; SSM state per slot in the arena's dtypes), both slots
    admitted with their whole reservation."""
    from repro_torch.runtime.kvcache import PagedKVArena
    arena = PagedKVArena(model, 2, 64, block_size=16, device=d)
    for _ in range(2):
        arena.alloc_slot(arena.blocks_needed(64))
    return arena


def _close(a, r, rel=1e-2):
    """max |a - r| and whether it is within ``rel`` of max |r|."""
    err = float((a - r).abs().max())
    return err, err <= rel * float(r.abs().max())


def check_mamba_steps_vs_cpu(torch, dev, params, cfg) -> None:
    """mamba2 at full width cut to 2 layers: two consecutive chunked
    decode steps (lengths 8/3, then 8/1: the second reads the state the
    first left) on a paged arena (the state per slot, conv window bf16,
    SSM state f32), the card's kernels against the plain CPU path, same
    weights: valid rows' logits of both steps within 1e-2 x max|logit|
    (check_step_vs_cpu's bound: bf16 activations, another summation
    order), and the first layer's state within 1e-2 of its largest
    magnitude. The second layer's state is held through the second
    step's logits, which read it: its inputs already differ by bf16
    ulps, and each token's decay exp(-dt) compounds the dt's rounding
    over the chunk, so alone it has no tighter bound than the logits'
    (its error is printed)."""
    import dataclasses
    from repro_torch.models.api import build_model
    model = build_model(dataclasses.replace(cfg, num_layers=2))
    cut = _cut_to(params, model)
    rng = torch.Generator().manual_seed(14)
    i32 = torch.int32
    steps = [(torch.randint(0, cfg.vocab_size, (2, 8), generator=rng,
                            dtype=i32), torch.tensor([0, 0], dtype=i32),
              torch.tensor([8, 3], dtype=i32)),
             (torch.randint(0, cfg.vocab_size, (2, 8), generator=rng,
                            dtype=i32), torch.tensor([8, 3], dtype=i32),
              torch.tensor([8, 1], dtype=i32))]
    from repro_torch.models import layers

    def run(d, nudge=False):
        """Both steps on device ``d``: (logits, {leaf: (dtype, state)});
        ``nudge``: every in_proj output moved one bf16 ulp up or down in
        a seeded two thirds of its nonzero elements (the CPU run)."""
        arena = _paged_arena(model, d)
        tables, _ = arena.device_tables()
        w = _to(cut, d)
        in_proj = {id(lp["ssm"]["in_proj"]) for lp in w["layers0"]}
        lin0, g = layers.linear_apply, torch.Generator().manual_seed(17)

        def nudged(p, x, fmt="none"):
            y = lin0(p, x, fmt)
            if id(p) not in in_proj:
                return y
            step = torch.randint(-1, 2, y.shape, generator=g,
                                 dtype=torch.int16)
            step = torch.where(y == 0, torch.zeros_like(step), step)
            return (y.view(torch.int16) + step).view(torch.bfloat16)
        if nudge:
            layers.linear_apply = nudged
        try:
            logits = []
            for tok, pos, lens in steps:
                lg, _ = model.decode_step(w, tok.to(d), pos.to(d),
                                          arena.buffers, quant="q8_0",
                                          block_tables=tables,
                                          lengths=lens.to(d))
                logits.append(lg.float().cpu())
        finally:
            layers.linear_apply = lin0
        return logits, {k: (v.dtype, v.float().cpu())
                        for k, v in arena.buffers["layers0"].items()}
    out = {str(d): run(d) for d in ("cpu", dev)}
    (la, sa), (lr, sr) = out[str(dev)], out["cpu"]
    parts = []
    for i, (a, r) in enumerate(zip(la, lr)):
        lens = steps[i][2]
        errs = [_close(a[b, :int(n)], r[b, :int(n)]) for b, n in
                enumerate(lens)]
        err = max(e for e, _ in errs)
        if a.shape != (2, 8, cfg.vocab_size) or not bool(
                torch.isfinite(a).all()) or not all(ok for _, ok in errs):
            fail(f"mamba2 2-layer step {i} card vs CPU: logits "
                 f"max_abs_err {err:.3e} vs max|logit| "
                 f"{float(r.abs().max()):.3e}")
        parts.append(f"step {i} logits {err:.3e} (max|logit| "
                     f"{float(r.abs().max()):.3e})")
    for k in ("conv", "ssm"):
        (dt_a, a), (dt_r, r) = sa[k], sr[k]
        err, ok = _close(a[0], r[0])
        want = torch.float32 if k == "ssm" else torch.bfloat16
        if not ok or dt_a != dt_r or dt_a != want:
            fail(f"mamba2 2-layer steps: layer 0 {k} state {dt_a} "
                 f"max_abs_err {err:.3e} vs max|state| "
                 f"{float(r[0].abs().max()):.3e}")
        parts.append(f"{k} state ({str(dt_a).split('.')[-1]}) layer 0 "
                     f"{err:.3e} (max {float(r[0].abs().max()):.3e}), "
                     f"layer 1 {float((a[1] - r[1]).abs().max()):.3e} (max "
                     f"{float(r[1].abs().max()):.3e}, not bounded)")
    print(f"step check: full-width mamba2 q8_0, 2 layers, two chunked steps "
          f"on per-slot state, card kernels vs CPU plain: "
          f"{', '.join(parts)} (bound 1e-2 x max|.|)", flush=True)
    # Does a rounding difference of the size the card makes spread the
    # second layer's state as far on the CPU alone? The CPU path again,
    # every in_proj output moved by one bf16 ulp.
    _, sn = run("cpu", nudge=True)
    gap = lambda x, k, i: float(  # noqa: E731
        (x[k][1][i] - sr[k][1][i]).abs().max())
    spread = [f"{k} layer {i} {gap(sn, k, i):.3e} (card vs CPU "
              f"{gap(sa, k, i):.3e})" for k in ("conv", "ssm")
              for i in range(2)]
    print(f"state spread: full-width mamba2 q8_0, 2 layers, the CPU path "
          f"with each in_proj output moved one bf16 ulp (up or down, a "
          f"seeded 2/3 of its nonzero elements) vs the CPU path, after the "
          f"same two steps: {', '.join(spread)}", flush=True)


def check_padding_on_card(torch, dev, params, cfg) -> None:
    """On the card, mamba2's first mixer over a chunk whose rows end
    early (lengths 8, 3, 0): the idle row's state stays bit-equal to the
    state before the step, and the short row's state is bit-equal to a
    3-wide chunk of the same in_proj rows (the recurrence reads no
    padding)."""
    from repro_torch.models import layers, ssm
    lp = params["layers0"][0]["ssm"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    sh = ssm.ssm_cache_shape(cfg, 3)
    state = {"conv": torch.randn(sh["conv"], generator=gen,
                                 device=dev).to(torch.bfloat16),
             "ssm": torch.randn(sh["ssm"], generator=gen, device=dev) * 0.1}
    u = torch.randn((3, 8, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    lens = torch.tensor([8, 3, 0], device=dev)
    clone = lambda: {k: v.clone() for k, v in state.items()}  # noqa: E731
    full, gated, short = clone(), clone(), clone()
    ssm.ssm_decode(lp, cfg, u, full, fmt="q8_0", lengths=lens)
    rows = layers.linear_apply(lp["in_proj"], u, "q8_0")
    ssm._recur(lp, cfg, rows, gated, lens)
    ssm._recur(lp, cfg, rows[:, :3], short, None)
    torch.cuda.synchronize()
    for k in ("conv", "ssm"):
        if not torch.equal(full[k][2], state[k][2]):
            fail(f"mamba2 padded chunk on the card: the idle row's {k} "
                 "state moved")
        if not torch.equal(gated[k][1], short[k][1]) or \
                not torch.equal(full[k], gated[k]):
            fail(f"mamba2 padded chunk on the card: the short row's {k} "
                 "state is not the 3-wide chunk's")
    print("padding check: mamba2 layer 0 on the card, lengths 8/3/0: the "
          "idle row's conv and SSM state bit-equal to before the step, the "
          "short row's bit-equal to a 3-wide chunk's", flush=True)


def check_jamba_layers_vs_cpu(torch, dev, cfg, params) -> None:
    """jamba at full width, layer by layer (a 2-layer cut holds no
    attention layer: it sits at offset 4): block 0's sub0 (mamba mixer,
    dense FFN) on per-slot state and sub4 (GQA, dense FFN) on bf16 pages
    — B1's tensor-core kernel at G = 4, D = 128, one launch — each one
    chunked decode step (lengths 8/3) on the card against the plain CPU
    path, same weights and inputs: valid rows within 1e-2 x max|out| and
    the state / pages written within 1e-2 of their scale (bf16
    activations in another summation order); then sub1's MoE FFN by
    ``check_moe_vs_cpu``."""
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.models import lm, ssm
    t0 = time.perf_counter()
    blk = params["blocks"][0]
    gen = torch.Generator().manual_seed(16)
    B, C, bf16 = 2, 8, torch.bfloat16
    h = torch.randn((B, C, cfg.d_model), generator=gen).to(bf16)
    pos = torch.tensor([0, 5], dtype=torch.int32)
    lens = torch.tensor([8, 3], dtype=torch.int32)
    tables = torch.tensor([[3, 1, 8, 8], [0, 2, 8, 8]], dtype=torch.int32)
    sh = ssm.ssm_cache_shape(cfg, B)
    state = {"conv": torch.randn(sh["conv"], generator=gen).to(bf16),
             "ssm": torch.randn(sh["ssm"], generator=gen) * 0.1}
    page = (9, 16, cfg.num_kv_heads, cfg.resolved_head_dim())
    pages = {k: torch.randn(page, generator=gen).to(bf16) for k in "kv"}
    for sub, mixer, cache in (("sub0", "ssm", state), ("sub4", "gqa", pages)):
        got = {}
        for d in ("cpu", dev):
            c = {k: v.clone().to(d) for k, v in cache.items()}
            lp = _to(blk[sub], "cpu") if d == "cpu" else blk[sub]
            n0 = paged_decode_attention.launches
            y = lm.layer_decode(
                lp, cfg, h.to(d), pos.to(d), c, mixer=mixer, ffn="dense",
                fmt="q8_0", lengths=lens.to(d),
                block_tables=tables.to(d) if mixer == "gqa" else None)
            launched = paged_decode_attention.launches - n0
            got[str(d)] = (y.float().cpu(), {k: v.float().cpu()
                                             for k, v in c.items()})
            del lp
        if mixer == "gqa" and launched != 1:
            fail(f"jamba attention layer: {launched} paged attention "
                 "launches on the card, not 1")
        (a, ca), (r, cr) = got[str(dev)], got["cpu"]
        errs = [_close(a[b, :int(n)], r[b, :int(n)]) for b, n in
                enumerate(lens)]
        err = max(e for e, _ in errs)
        parts = [f"output {err:.3e} (max|out| {float(r.abs().max()):.3e})"]
        ok = all(o for _, o in errs) and bool(torch.isfinite(a).all())
        for k in ca:
            e, o = _close(ca[k], cr[k])
            ok = ok and o
            parts.append(f"{k} {e:.3e} (max {float(cr[k].abs().max()):.3e})")
        if not ok:
            fail(f"jamba block 0 {sub} ({mixer}) card vs CPU: "
                 f"{', '.join(parts)}")
        print(f"layer check: full-width jamba block 0 {sub} ({mixer}, "
              f"dense FFN) q8_0, one chunked step (lengths 8/3), card vs "
              f"CPU plain: {', '.join(parts)} (bound 1e-2 x max|.| each)"
              + (f" | B1 at G = {cfg.num_heads // cfg.num_kv_heads}, D = "
                 f"{cfg.resolved_head_dim()}: 1 launch" if mixer == "gqa"
                 else ""), flush=True)
    check_moe_vs_cpu(torch, dev, cfg, params, lp=blk["sub1"]["ffn"],
                     label="jamba block 0 sub1")
    print(f"layer checks: jamba took {time.perf_counter() - t0:.1f} s with "
          "the CPU copies", flush=True)


def check_recurrent(torch, dev, serve) -> None:
    """The recurrent phase's checks, after every timed serve, on the same
    seeded weights made again (mamba2 at ``RECURRENT_CHECK_LAYERS``): the
    profiled prefill of each model (the SSD's device ms), mamba2's
    2-layer steps against the CPU path and its padded chunk on the card,
    jamba's layers against the CPU path, and a profiled serve of each."""
    t0 = time.perf_counter()
    for label, argv, layers, _, _ in RECURRENT:
        layers = RECURRENT_CHECK_LAYERS.get(label, layers)
        _, cfg, model, params = recipe_setup(torch, dev, serve, "q8_0",
                                             argv=argv, layers=layers)
        profile_prefill(torch, model, params,
                        _prefill_batch(torch, dev, cfg), cfg)
        if label == "mamba2":
            check_mamba_steps_vs_cpu(torch, dev, params, cfg)
            check_padding_on_card(torch, dev, params, cfg)
        else:
            check_jamba_layers_vs_cpu(torch, dev, cfg, params)
        profile_serve(torch, serve, cfg, model, params, dev, "q8_0",
                      arena=argv[:-8],
                      label=f"{label} ({cfg.num_layers} layers) q8_0")
        del params, model
        torch.cuda.empty_cache()
    print(f"chip_smoke: recurrent checks took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def serve_conditioned(torch, dev, serve):
    """The conditioned phase's timed runs, before any profiler session:
    for whisper (12 + 12 layers) and qwen2-vl (28 layers), ``--mode
    batch`` (the lockstep Engine on the contiguous arena), then the
    stream and a prefill (8 x 128 decoder tokens over 1,500 frames; 8 x
    512 tokens behind the vision prefix) on one setup, each with its
    exact launches per step, per admission (whisper's encoder pass) and
    per prefill. Returns {run: launches}."""
    t0 = time.perf_counter()
    runs = {}
    for label, argv, per_step, per_admit, per_prefill, shape in CONDITIONED:
        runs[f"{label} batch"] = serve_batch(
            torch, dev, serve, arch=argv[1],
            per_step={"matmul_q8_0": per_step["matmul_q8_0"]},
            per_admit=per_admit, tag=f"serve {label} batch")
        setup = recipe_setup(torch, dev, serve, "q8_0", argv=argv)
        runs[label] = serve_recipe(torch, dev, serve, "q8_0",
                                   per_step=per_step, per_admit=per_admit,
                                   tag=f"serve {label} q8_0", argv=argv,
                                   setup=setup)
        runs[f"{label} prefill"] = run_prefill(
            torch, dev, serve, repeats=2, setup=setup,
            per_prefill=per_prefill, profile=False, shape=shape)
        del setup
        torch.cuda.empty_cache()
    print(f"chip_smoke: conditioned serves took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return runs


def _cut_conditioned(params, cfg):
    """(2-layer config, its weights from the full model's ``params``):
    whisper keeps 2 encoder and 2 decoder layers, qwen2-vl 2 layers."""
    import dataclasses
    if cfg.family == "encdec":
        cut = {k: v[:2] if k.endswith("_layers") else v
               for k, v in params.items()}
        return dataclasses.replace(cfg, num_layers=2, encoder_layers=2), cut
    from repro_torch.models.api import build_model
    small = dataclasses.replace(cfg, num_layers=2)
    return small, _cut_to(params, build_model(small))


def check_conditioned_step_vs_cpu(torch, dev, params, cfg) -> None:
    """One full-width step with depth cut to 2 layers (whisper: 2 + 2),
    q8_0, on bf16 pages: whisper's admission pass writes the cross K/V of
    seeded frames into both slots first; qwen2-vl's second slot starts at
    250, its chunk straddling the vision/text boundary (vision rows at
    positions below 256). The card's kernels against the plain CPU path,
    same weights: valid rows' logits within 1e-2 x max|logit|
    (check_step_vs_cpu's bound)."""
    from repro_torch.models.api import build_model
    from repro_torch.runtime.kvcache import PagedKVArena
    small, cut = _cut_conditioned(params, cfg)
    model = build_model(small)
    vlm = cfg.family == "vlm"
    rng = torch.Generator().manual_seed(16)
    tok = torch.randint(0, cfg.vocab_size, (2, 8), generator=rng,
                        dtype=torch.int32)
    pos = torch.tensor([0, 250 if vlm else 5], dtype=torch.int32)
    lens = torch.tensor([8, 3], dtype=torch.int32)
    frames = torch.randn((1, cfg.encoder_seq_len, cfg.d_model),
                         generator=rng).to(torch.bfloat16)
    vis = torch.randn((2, 8, cfg.d_model), generator=rng).to(torch.bfloat16)
    mask = (pos[:, None] + torch.arange(8)) < cfg.vision_tokens
    out = {}
    for d in ("cpu", dev):
        arena = PagedKVArena(model, 2, 272, block_size=16, device=d)
        for _ in range(2):
            arena.alloc_slot(arena.blocks_needed(272))
        w = _to(cut, d)
        if not vlm:
            for slot in range(2):
                arena.write_prefill(model.encode_cross(
                    w, frames.to(d), quant="q8_0"), slot)
        extra = dict(embeds=vis.to(d), embeds_mask=mask.to(d)) if vlm \
            else {}
        tables, _ = arena.device_tables()
        logits, _ = model.decode_step(w, tok.to(d), pos.to(d), arena.buffers,
                                      quant="q8_0", block_tables=tables,
                                      lengths=lens.to(d), **extra)
        out[str(d)] = logits.float().cpu()
        del w, arena
    a, r = out[str(dev)], out["cpu"]
    worst = max(float((a[b, :int(n)] - r[b, :int(n)]).abs().max())
                for b, n in enumerate(lens))
    scale = float(r.abs().max())
    if a.shape != (2, 8, cfg.vocab_size) or not bool(
            torch.isfinite(a).all()) or worst > 1e-2 * scale:
        fail(f"{cfg.name} 2-layer step card vs CPU: max_abs_err "
             f"{worst:.3e} vs max|logit| {scale:.3e}")
    what = " (a chunk across the vision/text boundary)" if vlm else \
        " (+ 2 encoder layers, cross K/V written by the admission pass)"
    print(f"step check: full-width {cfg.name} q8_0, 2 layers{what}, card "
          f"kernels vs CPU plain: logits {tuple(a.shape)} finite, "
          f"max_abs_err {worst:.3e} (bound 1e-2 x max|logit| = "
          f"{1e-2 * scale:.3e})", flush=True)


def check_conditioned(torch, dev, serve) -> None:
    """The conditioned phase's checks, after every timed serve, on the
    same seeded weights made again: each model's 2-layer step against
    the CPU path and a profiled serve of each."""
    t0 = time.perf_counter()
    for label, argv, _, _, _, _ in CONDITIONED:
        _, cfg, model, params = recipe_setup(torch, dev, serve, "q8_0",
                                             argv=argv)
        check_conditioned_step_vs_cpu(torch, dev, params, cfg)
        profile_serve(torch, serve, cfg, model, params, dev, "q8_0",
                      arena=argv[:-8],
                      label=f"{label} ({cfg.num_layers} layers) q8_0")
        del params, model
        torch.cuda.empty_cache()
    print(f"chip_smoke: conditioned checks took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def _event_ms(torch, fn, iters: int) -> float:
    """Device ms per call of ``fn`` (which allocates, so it is not
    captured in a graph): CUDA events around ``iters`` calls after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_flash_backward(torch, dev):
    """B7 under autograd (``FlashAttention``: the kernel's forward, counted
    once; the plain f32 backward) at qwen3-0.6b's G = 2 and llama3-405b's
    G = 16, 8 x 512 causal, bf16: dq, dk and dv against torch.autograd of
    the plain version on the same inputs, within 1e-2 of each gradient's
    max |value| plus 1e-4 (both are f32 sums in other orders, rounded once
    to bf16: a one-ulp flip is 2^-8 of an element). Times the plain
    backward per call (CUDA events) beside SDPA's forward + backward, with
    the bound of a backward (read q, k, v, dO, write dq, dk, dv; 10
    products of D per visible (i, j) pair and head, at the bf16 peak).
    Returns {label: numbers}."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import attention_ref
    out = {}
    b, s, d = 8, 512, 128
    for label, h, hkv, per_step in (("qwen3-0.6b", 16, 8, 28),
                                    ("llama3-405b", 128, 8, 4)):
        gen = torch.Generator(device=dev)
        gen.manual_seed(h)
        mk = lambda *shape: torch.randn(  # noqa: E731
            shape, generator=gen, device=dev).to(torch.bfloat16)
        q, k, v = (x.requires_grad_(True) for x in
                   (mk(b, s, h, d), mk(b, s, hkv, d), mk(b, s, hkv, d)))
        do = mk(b, s, h, d)
        launches0 = fa.flash_attention.launches
        o = fa.flash_attention(q, k, v, causal=True)
        got = torch.autograd.grad(o, (q, k, v), do)
        if fa.flash_attention.launches != launches0 + 1:
            fail(f"flash_attention backward {label}: the forward launched "
                 f"{fa.flash_attention.launches - launches0} kernels, not 1")
        fa.flash_attention.launches = launches0   # check launches do not count
        want = torch.autograd.grad(attention_ref(q, k, v, causal=True),
                                   (q, k, v), do)
        torch.cuda.synchronize()
        errs = []
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            err = float((g.float() - w.float()).abs().max())
            lim = 1e-4 + 1e-2 * float(w.float().abs().max())
            if g.dtype != torch.bfloat16 or not bool(
                    torch.isfinite(g.float()).all()) or err > lim:
                fail(f"flash_attention backward {label} {name}: max_abs_err "
                     f"{err:.3e} > {lim:.3e}")
            errs.append(f"{name} {err:.3e} (bound {lim:.3e})")
        del got, want, o
        qd, kd, vd = q.detach(), k.detach(), v.detach()
        t_b = _event_ms(torch, lambda: fa.attention_backward(
            qd, kd, vd, do, causal=True, sm_scale=d ** -0.5), 3)
        qh, kh, vh = (x.detach().transpose(1, 2).contiguous().requires_grad_(
            True) for x in (q, k, v))
        doh = do.transpose(1, 2).contiguous()
        t_l = _event_ms(torch, lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                           enable_gqa=True),
            (qh, kh, vh), doh), 3)
        pairs = s * (s + 1) // 2
        b_ms, b_by = bound(2 * (2 * q.numel() + 2 * k.numel()
                                + 2 * v.numel() + do.numel()),
                           10.0 * b * h * d * pairs)
        print(f"kernel flash_attention backward {label} bf16 B={b} S={s} "
              f"H={h} Hkv={hkv} D={d} causal: vs autograd of the plain "
              f"version {', '.join(errs)} | plain backward {t_b:.3f} ms | "
              f"library(SDPA forward + backward) {t_l:.3f} ms | bound "
              f"{b_ms:.4f} ms ({b_by}) | per step x{per_step}: plain "
              f"backward {per_step * t_b:.2f} ms", flush=True)
        out[label] = dict(plain_backward_ms=t_b, library_ms=t_l,
                          bound_ms=b_ms, bound_by=b_by, per_step=per_step)
        del q, k, v, do, qd, kd, vd, qh, kh, vh, doh
        torch.cuda.empty_cache()
    return out


def time_flash_dense(torch, dev):
    """flash_attention at the dense configs' 8 x 512 causal prefills (G =
    3, 8, 16; D 128): {label: numbers}."""
    return {label: time_flash_at(torch, dev, f"{label} prefill", 8, 512,
                                 512, h, hkv, 128, True, n, seed=h)
            for label, h, hkv, n in DENSE_HEADS}


def _dense_argv(label):
    return ["--arch", label] + SERVE_ARGS[2:]


def serve_dense(torch, dev, serve):
    """The dense phase's timed runs, before any profiler session: for
    llama3.2-3b (28 layers), qwen2-72b (8) and llama3-405b (4), the dense
    weights made once on the card serve ``--mode batch`` (the lockstep
    Engine quantizes them), then their q8_0 planes serve the stream (and
    llama3-405b's on int8 pages) and the 8 x 512 prefill, each with its
    exact launches; the peak device memory of each. Returns {run:
    launches}."""
    from repro_torch.core.convert import quantize_params
    t0 = time.perf_counter()
    runs = {}
    for label, layers, _, per_step, per_prefill, per_int8 in DENSE:
        argv = _dense_argv(label)
        args, cfg, model, dense = recipe_setup(
            torch, dev, serve, "q8_0", argv=argv, quantize=False,
            layers=layers)
        peak_made = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        runs[f"{label} batch"] = serve_batch(
            torch, dev, serve, per_step={"matmul_q8_0":
                                         per_step["matmul_q8_0"]},
            tag=f"serve {label} batch", dense=(cfg, model, dense))
        peak_batch = torch.cuda.max_memory_allocated()
        params = quantize_params(dense, "q8_0")
        del dense
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        setup = (args, cfg, model, params)
        runs[label] = serve_recipe(torch, dev, serve, "q8_0",
                                   per_step=per_step,
                                   tag=f"serve {label} q8_0", argv=argv,
                                   setup=setup)
        if per_int8:
            runs[f"{label} kv-int8"] = serve_recipe(
                torch, dev, serve, "q8_0", extra=["--kv-quant", "int8"],
                per_step=per_int8, tag=f"serve {label} q8_0 kv-int8",
                argv=argv, setup=setup)
        runs[f"{label} prefill"] = run_prefill(
            torch, dev, serve, repeats=2, setup=setup,
            per_prefill=per_prefill, profile=False)
        qbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
        print(f"memory {label} ({cfg.num_layers} layers): q8_0 planes "
              f"{qbytes / 1e9:.2f} GB; peak device memory: making the bf16 "
              f"weights {peak_made / 1e9:.1f} GB, --mode batch (bf16 + the "
              f"Engine's q8_0) {peak_batch / 1e9:.1f} GB, the serves and "
              f"the prefill on q8_0 {torch.cuda.max_memory_allocated() / 1e9:.1f}"
              f" GB", flush=True)
        del setup, params
        torch.cuda.empty_cache()
    print(f"chip_smoke: dense serves took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return runs


def check_dense(torch, dev, serve) -> None:
    """The dense phase's checks, after every timed serve, on the same
    seeded weights made again: each config's full-width step cut to 2
    layers (llama3-405b: 1; its lm_head whole, 128,256 rows: the host's
    f32 dequantization of it is 8.4 GB) against the CPU path, and a
    profiled serve of each."""
    t0 = time.perf_counter()
    for label, layers, check_layers, _, _, _ in DENSE:
        argv = _dense_argv(label)
        _, cfg, model, params = recipe_setup(torch, dev, serve, "q8_0",
                                             argv=argv, layers=layers)
        check_step_vs_cpu(torch, dev, params, cfg, "q8_0",
                          layers=check_layers)
        profile_serve(torch, serve, cfg, model, params, dev, "q8_0",
                      arena=argv[:-8],
                      label=f"{label} ({cfg.num_layers} layers) q8_0")
        del params, model
        torch.cuda.empty_cache()
    print(f"chip_smoke: dense checks took {time.perf_counter() - t0:.1f} s",
          flush=True)


def train_phase(torch, dev, serve, card):
    """The paper's train -> quantize -> serve flow on the card: the port's
    trainer on full-width, full-depth qwen3-0.6b (bf16, copy task over a
    pool of 2 batches of 8 x 512, lr 3e-3) for TRAIN_STEPS steps through
    ``ElasticRunner`` (the last loss below 0.9x the first; step ms, train
    tokens/s, peak memory), exactly 28 B7 a step and no matmul or paged
    kernel; --remat full and --microbatches 2 at 56, --grad-compression
    int8 at 28, --remat dots_saveable printed (two steps each, the second
    timed); a 2-layer cut's step on the card against the CPU path (loss within 1e-3 of its value, grad norm
    within 1 %, every parameter within 2 lr (1 + weight decay) plus one
    bf16 ulp of the CPU's, at most 2 % of them beyond that ulp: a first
    AdamW step moves an element by about ±lr, so an element whose
    gradient is within rounding of 0 may move the other way); a failure
    injected at step 5 of the 2-layer cut restored from the step-4
    checkpoint (restarts == 1); then the trained weights quantized to q8_0 serve the stream with
    197 B2 + 28 B1 a step and a 2-layer step checked against the CPU path.
    Returns {run: launches}."""
    import dataclasses
    import shutil
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.convert import quantize_params
    from repro_torch.models.api import build_model
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt
    from repro_torch.train.data import SyntheticDataset
    from repro_torch.train.elastic import ElasticRunner
    from repro_torch.train.trainer import make_train_step
    t_phase = time.perf_counter()
    cfg = serve.get_config("qwen3-0.6b")
    model = build_model(cfg)
    b, s = TRAIN_SHAPE
    data = SyntheticDataset(cfg.vocab_size, s, b, task="copy", pool=2,
                            device=dev)
    ckdir = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(ckdir, ignore_errors=True)

    def init_fn():
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = model.init(gen)
        return params, opt.adamw_init(params)

    tc = TrainConfig(learning_rate=3e-3, total_steps=TRAIN_STEPS,
                     warmup_steps=1, checkpoint_every=1000,
                     checkpoint_dir=str(ckdir / "run"))
    raw = make_train_step(model, tc)
    last = {}

    def step_fn(params, opt_state, batch):
        out = raw(params, opt_state, batch)
        last["params"], last["opt"] = out[0], out[1]
        return out
    losses, secs = [], []
    runner = ElasticRunner(tc, step_fn, init_fn, data, on_step=lambda
                           step, m, dt: (losses.append(float(m["loss"])),
                                         secs.append(dt)))
    serve.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = runner.run()
    wall = time.perf_counter() - t0
    runs = {"train": check_launches("train qwen3-0.6b", serve.launch_counts(),
                                    TRAIN_LAUNCHES, result["step"])}
    med = sorted(secs[1:])[len(secs[1:]) // 2]
    print(f"train qwen3-0.6b ({cfg.num_layers} layers, bf16) {b} x {s} "
          f"copy task on {card}: {result['step']} steps in {wall:.1f} s (checkpoint "
          f"included), loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({[round(x, 3) for x in losses]}), step ms first "
          f"{1e3 * secs[0]:.1f}, median {1e3 * med:.1f}, train tokens/s "
          f"{b * s / med:.0f}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB; stragglers "
          f"{result['stragglers']}, restarts {result['restarts']}",
          flush=True)
    if result["step"] != TRAIN_STEPS or result["restarts"] or \
            not losses[-1] < 0.9 * losses[0] or \
            not all(math.isfinite(x) for x in losses):
        fail(f"train: the loss did not fall below 0.9x its first value "
             f"over {TRAIN_STEPS} steps: {losses}")
    params, state = last["params"], last["opt"]
    # The other step forms, a step or two each, with their launches.
    # Two steps each, the second timed (a remat policy's first step also
    # pays torch.utils.checkpoint's one-time set-up).
    b7 = TRAIN_LAUNCHES["flash_attention"]
    for label, kw, per in (
            ("--remat full", dict(remat_policy="full"), 2 * b7),
            ("--microbatches 2", dict(microbatches=2), 2 * b7),
            ("--grad-compression int8", dict(grad_compression="int8"), b7),
            ("--remat dots_saveable", dict(remat_policy="dots_saveable"),
             None)):
        step = make_train_step(model, dataclasses.replace(tc, **kw))
        serve.reset_launches()
        p, o = params, state
        steps = 2
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, o, m = step(p, o, data.batch_at(i))
            loss = float(m["loss"])
            ms = 1e3 * (time.perf_counter() - t0)
        launches = serve.launch_counts()
        if not math.isfinite(loss):
            fail(f"train {label}: loss {loss}")
        if per is None:
            got = launches["flash_attention"]
            if got < b7 * steps or any(n for k, n in launches.items()
                                       if k != "flash_attention"):
                fail(f"train {label}: launches {launches}")
            print(f"train {label}: {got // steps} B7 a step (the remat "
                  f"recomputes the forward's attention), no other kernel; "
                  f"{ms:.1f} ms a step, loss {loss:.4f}", flush=True)
            runs[f"train {label}"] = {"flash_attention": got}
        else:
            runs[f"train {label}"] = check_launches(
                f"train {label}", launches, {"flash_attention": per}, steps)
            print(f"train {label}: {ms:.1f} ms a step, loss {loss:.4f}",
                  flush=True)
        del p, o
    check_train_step_vs_cpu(torch, dev, model, cfg, init_fn)
    # Failure and restore: a node failure at step 5, after the step-4
    # checkpoint; full width cut to 2 layers (the full depth's 6 GB of
    # parameters and moments would take ~10 s a checkpoint).
    small = build_model(dataclasses.replace(cfg, num_layers=2))

    def init_small():
        p = _cut_to(init_fn()[0], small)
        return p, opt.adamw_init(p)
    tcf = dataclasses.replace(tc, total_steps=6, checkpoint_every=4,
                              checkpoint_dir=str(ckdir / "fail"),
                              async_checkpoint=False)
    rawf = make_train_step(small, tcf)
    failed = []

    def flaky(params, opt_state, batch):
        if not failed and int(opt_state["step"]) + 1 == 5:
            failed.append(True)
            raise RuntimeError("injected node failure")
        return rawf(params, opt_state, batch)
    t0 = time.perf_counter()
    res = ElasticRunner(tcf, flaky, init_small, data).run(6)
    latest = ckpt.latest_checkpoint(tcf.checkpoint_dir)
    if res["step"] != 6 or res["restarts"] != 1 or not failed or \
            not latest.endswith("ckpt_00000006.pt"):
        fail(f"train failure injection: {res}, latest {latest}")
    nbytes = Path(latest).stat().st_size
    print(f"train failure at step 5 (full width, 2 layers): restored from "
          f"the step-4 checkpoint and finished 6 steps (restarts "
          f"{res['restarts']}, latest {Path(latest).name}, "
          f"{time.perf_counter() - t0:.1f} s with checkpoints of "
          f"{nbytes / 1e9:.2f} GB)", flush=True)
    shutil.rmtree(ckdir, ignore_errors=True)
    # Train -> quantize -> serve.
    del state, last
    qparams = quantize_params(params, "q8_0")
    del params
    torch.cuda.empty_cache()
    setup = (None, cfg, model, qparams)
    runs["trained q8_0"] = serve_recipe(
        torch, dev, serve, "q8_0", tag="serve trained qwen3-0.6b q8_0",
        setup=setup)
    check_step_vs_cpu(torch, dev, qparams, cfg, "q8_0")
    del setup, qparams
    torch.cuda.empty_cache()
    print(f"chip_smoke: train phase took {time.perf_counter() - t_phase:.1f}"
          " s", flush=True)
    return runs


def check_train_step_vs_cpu(torch, dev, model, cfg, init_fn) -> None:
    """One train step of the full-width model cut to 2 layers, on the card
    (B7 forward, bf16 products) and on the CPU (the plain path), same
    weights and batch (2 x 128 tokens): loss, grad norm and the
    parameters after the step (the bounds of ``train_phase``)."""
    import dataclasses
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models.api import build_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train.data import SyntheticDataset
    from repro_torch.train.trainer import make_train_step
    small = build_model(dataclasses.replace(cfg, num_layers=2))
    cut = _to(_cut_to(init_fn()[0], small), "cpu")
    batch = SyntheticDataset(cfg.vocab_size, 128, 2, seed=1).batch_at(0)
    tc = TrainConfig(learning_rate=3e-3, total_steps=TRAIN_STEPS,
                     warmup_steps=1)
    out = {}
    for d in ("cpu", dev):
        p = _to(cut, d)
        p1, _, m = make_train_step(small, tc)(
            p, opt.adamw_init(p), {k: v.to(d) for k, v in batch.items()})
        out[str(d)] = (float(m["loss"]), float(m["grad_norm"]),
                       float(m["lr"]), _to(p1, "cpu"))
        del p, p1
    (lc, gc, lr, pc), (lg, gg, _, pg) = out["cpu"], out[str(dev)]
    flips = total = 0
    worst = 0.0
    wd = tc.weight_decay
    for a, w in zip(opt.tree_leaves(pg), opt.tree_leaves(pc)):
        w = w.double()
        ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - 8)
        d = (a.double() - w).abs()
        worst = max(worst, float((d - ulp).max()))
        flips += int((d > ulp).sum())
        total += d.numel()
    if abs(lg - lc) > 1e-3 * abs(lc) or abs(gg / gc - 1) > 1e-2 or \
            worst > 2 * lr * (1 + wd) or flips > 2e-2 * total:
        fail(f"train step (2 layers) card vs CPU: loss {lg:.6f} / {lc:.6f}, "
             f"grad norm {gg:.6f} / {gc:.6f}, parameters {flips} of {total} "
             f"beyond one ulp, worst {worst:.3e} past it")
    print(f"train step check: full-width qwen3-0.6b cut to 2 layers, 2 x 128 "
          f"tokens, card vs CPU: loss {lg:.6f} vs {lc:.6f} (bound 1e-3 of "
          f"it), grad norm {gg:.6f} vs {gc:.6f} (1 %), parameters after the "
          f"step: {flips} of {total} ({100 * flips / total:.3f} %, bound 2 %)"
          f" beyond one bf16 ulp, the farthest {worst:.3e} past it (bound "
          f"2 lr (1 + wd) = {2 * lr * (1 + wd):.3e})", flush=True)


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


def check_shard_plans(torch, dev) -> None:
    """B2 (q8_0, and fp16/q6_k/q3_k through the shared ``plan``) on
    column blocks of 2 and 4 and row blocks of 2, B1/B8 on kv-head and
    slot blocks, each launched with ``plan_parts``, and B9 on head
    blocks and 'data' slot blocks, each launched with the whole call's
    ``MlaPlan``: bit for bit the whole call's rows, columns, heads and
    slots (the card tests' helpers, tests/test_torch_cuda.py)."""
    sys.path.insert(0, str(ROOT / "tests"))
    import test_torch_cuda as tc
    n = 0
    for fmt in ("q8_0", "fp16", "q6_k", "q3_k"):
        for mnk in tc.SHARD_MNK:
            whole, shards = tc._matmul_shards(dev, fmt, *mnk)
            torch.cuda.synchronize()
            for rows, cols, y in shards:
                if not torch.equal(y, whole[rows, cols]):
                    fail(f"{fmt} shard of {mnk} differs from the whole call")
                n += 1
    for dtype, kv in ((torch.bfloat16, "bfloat16"), (torch.bfloat16, "int8"),
                      (torch.float32, "bfloat16")):
        whole, shards = tc._paged_shards(dev, dtype, kv)
        torch.cuda.synchronize()
        for rows, heads, y in shards:
            if not torch.equal(y, whole[rows][:, :, heads]):
                fail(f"paged attention {dtype} q on {kv} pages: a shard "
                     "differs from the whole call")
            n += 1
    for pages in ("bfloat16", "int8"):
        for slots, chunk, parts, data in tc.MLA_SHARD_CASES:
            whole, lens, shards = tc._mla_shards(dev, pages, slots, chunk,
                                                 parts, data)
            torch.cuda.synchronize()
            for rows, heads, y in shards:
                if not all(torch.equal(y[b, :m], whole[rows][b, :m, heads])
                           for b, m in enumerate(lens[rows])):
                    fail(f"MLA paged attention on {pages} pages, {slots} "
                         f"slots of chunk {chunk}: a shard of {data} slot "
                         f"x {parts} head blocks differs from the whole "
                         "call")
                n += 1
            print(f"B9 shards on {pages} pages: {slots} slots x chunk "
                  f"{chunk} in {data} slot x {parts} head blocks bit-equal "
                  "to the whole call", flush=True)
    print(f"shard plans: {n} matmul and paged-attention shards bit-equal to "
          "their whole calls (plan_parts, MlaPlan)", flush=True)


# --- serve_mesh: serving meshes over torch.distributed ------------------
# Ranks that share cuda:0 over gloo (--ranks-per-device), one world for
# the whole phase; every mesh run is held against a 1x1 run of its flags.
MESH_RANKS = 4
MESH_QWEN = ((1, 2), (2, 1), (2, 2))
# The mesh cells' stream: the serve's with 8 requests (one admission
# wave, ~48 steps: every step's logits are still held), but for the
# prefix cache and n-gram cells, which need the 16-request stream's
# later admissions and repeats; keeps the script inside its time.
MESH_REQUESTS = ["--requests", "8"]
# Collectives a step a rank, from the layer structure: over 'model' four
# all-gathers a qwen3 layer (attention's output: q/k/v keep their heads;
# o; the SwiGLU's h: gate and up stay columnwise; down; qwen3-0.6b's
# lm_head is the tied embedding, replicated), over 'data' the sampled
# tokens, the page-pool sync and one per MoE layer (its tokens).
QWEN_LAYERS = 28
GRANITE_MOE_LAYERS = 32


def mesh_collectives(dp, tp, layers=None, moe_layers=0):
    layers = QWEN_LAYERS if layers is None else layers
    return (4 * layers if tp > 1 else 0) + (2 + moe_layers if dp > 1 else 0)


def _mesh_args(serve, argv, dp, tp):
    ap = serve.build_parser()
    args = ap.parse_args(list(argv) + ["--quant", "q8_0", "--dp", str(dp),
                                       "--tp", str(tp), "--ranks-per-device",
                                       str(MESH_RANKS)])
    serve.validate_args(ap, args)
    return args


def _mesh_run(torch, serve, ctx, tag, argv, setup, mesh, per_step,
              collectives=None, record=True):
    """One serve of ``argv`` on ``mesh`` (None: this rank alone, 1x1)
    with its logit rows recorded: launches exactly ``per_step`` a step,
    ``collectives`` a step (when given), every request complete.
    Returns the rank's summary and (report, rows, index)."""
    cfg, model, params = setup
    dp, tp = (1, 1) if mesh is None else (mesh.shape["data"],
                                          mesh.shape["model"])
    args = _mesh_args(serve, argv, dp, tp)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    serve.reset_launches()
    ctxm = recorded_logits(torch, serve) if record else \
        contextlib.nullcontext(([], {}))
    with ctxm as (rows, index):
        engine, report, _ = serve.run_stream(cfg, model, params, args,
                                             ctx.device, mesh=mesh)
    launches = serve.launch_counts()
    st = report.stats
    vocab = cfg.vocab_size
    if len(report.sequences) != args.requests or any(
            len(q.generated) != args.gen
            or not all(0 <= t < vocab for t in q.generated)
            for q in report.sequences):
        fail(f"{tag}: not every request completed with in-vocab tokens")
    check_launches(f"{tag} rank {ctx.rank}", launches, per_step, st.steps)
    col = report.collectives or {"collectives": 0, "bytes": 0, "staged": 0}
    if collectives is not None and col["collectives"] != \
            collectives * st.steps:
        fail(f"{tag} rank {ctx.rank}: {col['collectives']} collectives in "
             f"{st.steps} steps, the layer structure gives {collectives} a "
             "step")
    summary = {
        "tag": tag, "rank": ctx.rank, "mesh": f"{dp}x{tp}",
        "backend": mesh.describe() if mesh is not None else "1x1",
        "steps": st.steps, "tok_s": report.throughput_tok_s,
        "p50_ms": report.step_ms_percentile(50),
        "peak_gb": torch.cuda.max_memory_allocated(ctx.device) / 1e9,
        "collectives_per_step": col["collectives"] / max(st.steps, 1),
        "mb_per_step": col["bytes"] / max(st.steps, 1) / 1e6,
        "staged": col["staged"], "launches": launches,
        "tokens": [list(q.generated) for q in report.sequences],
        "prefix_hits": st.prefix_hits,
        "spec": (st.spec_proposed, st.spec_accepted, st.spec_rolled_back),
        "steps_per_token": st.steps_per_token,
        "plan_note": engine.plan_note}
    del engine
    return summary, (report, rows, index)


def _hold_mesh(torch, tag, ref, got, rows_ref, rows_got, lo, hi,
               bitwise=True):
    """A mesh run against its 1x1 run on one rank: tokens (every slot's,
    gathered) equal; every step's logit rows of this rank's slots
    [lo, hi) compared with the 1x1 run's bit for bit — required with
    ``bitwise``, else recorded (``got["logits_equal"]``)."""
    if got["tokens"] != ref["tokens"]:
        fail(f"{tag}: tokens differ from the 1x1 run")
    if got["steps"] != ref["steps"] or len(rows_got) != len(rows_ref):
        fail(f"{tag}: {got['steps']} steps vs the 1x1 run's "
             f"{ref['steps']}")
    worst = 0.0
    for i, (a, b) in enumerate(zip(rows_ref, rows_got)):
        if not torch.equal(a[lo:hi], b):
            d = float((a[lo:hi] - b).abs().max())
            worst = max(worst, d)
            if bitwise:
                fail(f"{tag}: step {i}'s logits differ from the 1x1 run's "
                     f"(max |diff| {d:.3e})")
    got["logits_equal"] = worst == 0.0
    got["logit_diff"] = worst


def _mesh_world(ctx, card):
    """The ranks of ``serve_mesh``: every run, each rank's summaries."""
    import dataclasses
    import torch
    from repro_torch.launch import mesh as meshes
    from repro_torch.launch import serve
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    m11 = meshes.make_host_mesh(1, 1, [0], device=ctx.device,
                                ranks_per_device=MESH_RANKS)
    m12 = meshes.make_host_mesh(1, 2, [0, 1], device=ctx.device,
                                ranks_per_device=MESH_RANKS)
    # 2x1 over ranks 0 and 2: the ranks whose 1x1 runs hold the logit
    # rows of the two 'data' replicas (slots 0-3 and 4-7) of the 2x2 mesh.
    m21 = meshes.make_host_mesh(2, 1, [0, 2], device=ctx.device,
                                ranks_per_device=MESH_RANKS)
    # Rank 2 alone: it builds its copy of deepseek-v3 while rank 0 keeps
    # the 1x1 run's.
    m2 = meshes.make_host_mesh(1, 1, [2], device=ctx.device,
                               ranks_per_device=MESH_RANKS)
    m22 = meshes.make_host_mesh(2, 2, device=ctx.device,
                                ranks_per_device=MESH_RANKS)
    by_shape = {(1, 2): m12, (2, 1): m21, (2, 2): m22}

    def build(argv, turns, layers=None, mesh=None):
        """Weights on the ranks of ``turns`` (whole, or this rank's
        shards of ``mesh``), built in turn: one build's transient on the
        card at a time."""
        args = _mesh_args(serve, argv, 1, 1)
        cfg = serve.get_config(args.arch)
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        model = serve.build_model(cfg)

        def make():
            p = serve.build_params(model, args, ctx.device, mesh=mesh)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            return p
        return cfg, model, turns.serialized(make) if turns.member else None

    def rows_of(mesh):
        rep = int(SERVE_ARGS[SERVE_ARGS.index("--slots") + 1]) \
            // mesh.shape["data"]
        lo = mesh.coords["data"] * rep
        return lo, lo + rep

    # qwen3-0.6b, full width and depth: 1x1 on ranks 0 and 2 (in turn),
    # then 1x2, 2x1 and 2x2, each bit for bit on ranks 0 and 2 (a rank
    # of 'model' coordinate 1 holds the same gathered rows as its
    # coordinate-0 peer, and compares the tokens of the peer's 1x1 run).
    cfg, model, params = build(SERVE_ARGS, m22)
    q = (cfg, model, params)
    qargs = SERVE_ARGS + MESH_REQUESTS
    ref = rrows = None
    if m21.member:
        ref, (_, rrows, _) = m21.serialized(
            _mesh_run, torch, serve, ctx, "mesh qwen3 1x1", qargs, q,
            None, RECIPE_LAUNCHES["q8_0"])
        out.append(ref)
    torch.distributed.barrier()
    for dp, tp in MESH_QWEN:
        mesh = by_shape[(dp, tp)]
        if mesh.member:
            tag = f"mesh qwen3 {dp}x{tp}"
            peer = mesh.all_gather_objects(ref, "model")[0]
            got, (_, grows, _) = _mesh_run(
                torch, serve, ctx, tag, qargs, q, mesh,
                RECIPE_LAUNCHES["q8_0"], mesh_collectives(dp, tp))
            if rrows is not None:
                _hold_mesh(torch, tag, ref, got, rrows, grows,
                           *rows_of(mesh))
            elif got["tokens"] != peer["tokens"]:
                fail(f"{tag}: tokens differ from the 1x1 run")
            out.append(got)
            del grows
        torch.distributed.barrier()
    del rrows
    # int8 pages at 1x2, the prefix cache at 2x1, n-gram speculation at
    # 1x2: each against its 1x1 run on rank 0 (a 1x2 rank's logit rows
    # are every slot's, so rank 0 compares them all; rank 1 compares the
    # tokens, prefix hits and speculation counts rank 0's run sends).
    for name, flags, shape, per_step, bitwise in (
            ("int8", ["--kv-quant", "int8"] + MESH_REQUESTS, (1, 2),
             INT8_LAUNCHES, True),
            ("prefix", PREFIX_FLAGS + ["--prefix-cache"], (2, 1),
             RECIPE_LAUNCHES["q8_0"], False),
            ("ngram", SPEC_FLAGS, (1, 2), RECIPE_LAUNCHES["q8_0"], False)):
        mesh = by_shape[shape]
        axis = "model" if shape[1] > 1 else "data"
        argv = SERVE_ARGS + flags
        if mesh.member:
            ref = rrows = None
            if ctx.rank == 0:
                ref, (_, rrows, _) = _mesh_run(
                    torch, serve, ctx, f"mesh qwen3 {name} 1x1", argv, q,
                    None, per_step)
                out.append(ref)
            ref = mesh.all_gather_objects(ref, axis)[0]
            tag = f"mesh qwen3 {name} {shape[0]}x{shape[1]}"
            got, (_, grows, _) = _mesh_run(
                torch, serve, ctx, tag, argv, q, mesh, per_step,
                mesh_collectives(*shape))
            if ctx.rank == 0:
                _hold_mesh(torch, tag, ref, got, rrows, grows,
                           *rows_of(mesh), bitwise=bitwise)
            elif got["tokens"] != ref["tokens"]:
                fail(f"{tag}: tokens differ from the 1x1 run")
            if got["prefix_hits"] != ref["prefix_hits"] \
                    or got["spec"] != ref["spec"]:
                fail(f"{tag}: prefix hits {got['prefix_hits']} / spec "
                     f"{got['spec']} vs the 1x1 run's {ref['prefix_hits']}"
                     f" / {ref['spec']}")
            if name == "prefix" and not got["prefix_hits"]:
                fail(f"{tag}: no prefix hit")
            if name == "ngram" and not got["spec"][0]:
                fail(f"{tag}: nothing proposed")
            out.append(got)
            del rrows, grows
        torch.distributed.barrier()
    del q, params
    torch.cuda.empty_cache()

    # deepseek-v3, full width cut to 4 layers (MLA + MoE): 1x1 on rank 0;
    # then 2x1 ('data' replicas: rank 0 keeps its whole weights, rank 2
    # builds its own), bit for bit -- B9 plans from the whole step
    # (MlaPlan) and the MoE layer routes the whole step's tokens, so every
    # step's logit rows of both replicas are the 1x1 run's (rank 2 sends
    # its rows to rank 0); then 1x2, tokens under the near-tie rule (the
    # MoE expert products of a column block).
    dargs = DEEPSEEK_ARGS + MESH_REQUESTS
    ds = build(DEEPSEEK_ARGS, m11, DEEPSEEK_LAYERS)
    if ctx.rank == 0:
        dref, dref_rec = _mesh_run(torch, serve, ctx, "mesh deepseek-v3 "
                                   "1x1", dargs, ds, None, DEEPSEEK_LAUNCHES)
        out.append(dref)
    torch.distributed.barrier()
    ds2 = build(DEEPSEEK_ARGS, m2, DEEPSEEK_LAYERS)
    if m21.member:
        tag = "mesh deepseek-v3 2x1"
        got, (_, grows, _) = _mesh_run(torch, serve, ctx, tag, dargs,
                                       ds if ctx.rank == 0 else ds2, m21,
                                       DEEPSEEK_LAUNCHES)
        if got["plan_note"] is not None:
            fail(f"{tag}: a plan is not the whole call's: "
                 f"{got['plan_note']}")
        peer = m21.all_gather_objects(
            [r.cpu() for r in grows] if ctx.rank else None, "data")[1]
        dref_all = m21.all_gather_objects(dref if ctx.rank == 0 else None,
                                          "data")[0]
        if got["tokens"] != dref_all["tokens"]:
            fail(f"{tag}: tokens differ from the 1x1 run")
        if ctx.rank == 0:
            rep = len(grows[0]) if grows else 0
            _hold_mesh(torch, tag, dref, got, dref_rec[1], grows, 0, rep)
            _hold_mesh(torch, tag, dref, got,
                       [r.cpu() for r in dref_rec[1]], peer, rep, 2 * rep)
            print(f"{tag}: every step's logit rows of both replicas "
                  "bit-equal to the 1x1 run's", flush=True)
        out.append(got)
        del grows, peer
    ds = ds2 = None
    torch.cuda.empty_cache()
    torch.distributed.barrier()
    ds = build(DEEPSEEK_ARGS, m12, DEEPSEEK_LAYERS, mesh=m12)
    if m12.member:
        tag = "mesh deepseek-v3 1x2"
        got, rec = _mesh_run(torch, serve, ctx, tag, dargs, ds, m12,
                             DEEPSEEK_LAUNCHES)
        if got["plan_note"] is not None:
            fail(f"{tag}: B9's split is not the whole call's: "
                 f"{got['plan_note']}")
        if ctx.rank == 0:
            got["near_tie_exempt"] = check_near_ties(
                torch, tag, dref_rec, rec, strict=False)
            d = max(float((a - b).abs().max())
                    for a, b in zip(dref_rec[1], rec[1]))
            scale = max(float(a.abs().max()) for a in dref_rec[1])
            got["logit_gap"] = d / scale
            print(f"{tag}: logit rows differ from the 1x1 run's by at most "
                  f"{d:.4g} ({d / scale:.3e} of max|logit|); held by the "
                  "near-tie rule: the MoE expert products (cuBLAS bmm on "
                  "a column block of the bank) have no plan of ours to "
                  "keep invariant", flush=True)
            del dref_rec
        out.append(got)
        del rec
    ds = None
    torch.cuda.empty_cache()
    torch.distributed.barrier()

    # granite-moe, full width and depth (its vocab 49,155 refuses any
    # tp): 1x1 on rank 0, then 2x1 -- the MoE 'data' gather.
    gr = build(GRANITE_ARGS, m21)
    if m21.member:
        if ctx.rank == 0:
            gref, (_, grrows, _) = _mesh_run(
                torch, serve, ctx, "mesh granite-moe 1x1",
                GRANITE_ARGS + MESH_REQUESTS, gr, None, GRANITE_LAUNCHES)
            out.append(gref)
        gref = m21.all_gather_objects(gref if ctx.rank == 0 else None,
                                      "data")[0]
        tag = "mesh granite-moe 2x1"
        got, (_, grows, _) = _mesh_run(
            torch, serve, ctx, tag, GRANITE_ARGS + MESH_REQUESTS, gr, m21,
            GRANITE_LAUNCHES,
            mesh_collectives(2, 1, layers=0, moe_layers=GRANITE_MOE_LAYERS))
        if ctx.rank == 0:
            # Tokens exactly; the logits are compared and reported (the
            # expert products are cuBLAS bmm, at the same shapes as 1x1).
            _hold_mesh(torch, tag, gref, got, grrows, grows, *rows_of(m21),
                       bitwise=False)
        elif got["tokens"] != gref["tokens"]:
            fail(f"{tag}: tokens differ from the 1x1 run")
        out.append(got)
    gr = None
    torch.cuda.empty_cache()
    torch.distributed.barrier()
    return out


def _mesh_refusal(serve, extra, want) -> None:
    """The launcher refuses ``SERVE_ARGS + extra`` naming ``want``."""
    import io
    ap = serve.build_parser()
    args = ap.parse_args(SERVE_ARGS + ["--quant", "q8_0"] + extra)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        try:
            serve.validate_args(ap, args)
        except SystemExit:
            pass
        else:
            fail(f"serve_mesh: {extra} was not refused")
    if want not in err.getvalue():
        fail(f"serve_mesh: {extra} refused without {want!r}: "
             f"{err.getvalue()}")
    print(f"serve_mesh: {' '.join(extra)} refused: "
          f"{err.getvalue().strip().splitlines()[-1]}", flush=True)


def serve_mesh(torch, dev, serve, card):
    """The serving meshes on the one card: the refusals, then a world of
    MESH_RANKS ranks sharing cuda:0 over gloo (``_mesh_world``); each
    run's tokens/s, p50 step, peak memory a rank, collectives a step
    and bytes a rank, and backend. Returns {run: {kernel: launches}} of
    every rank's mesh runs (the kernel JSON's launch totals)."""
    from repro_torch.launch import mesh as meshes
    t0 = time.perf_counter()
    _mesh_refusal(serve, ["--tp", "3", "--ranks-per-device",
                          str(MESH_RANKS)], "does not divide")
    _mesh_refusal(serve, ["--dp", "2", "--tp", "4", "--ranks-per-device",
                          str(MESH_RANKS)],
                  f"needs 8 devices but only {MESH_RANKS}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ranks = meshes.spawn(_mesh_world, MESH_RANKS, (card,),
                         device_type="cuda", ranks_per_device=MESH_RANKS)
    out = {}
    for summaries in ranks:
        for r in summaries:
            name = f"{r['tag']} rank {r['rank']}"
            print(f"{name} on {card}: {r['backend']}: {r['tok_s']:.1f} "
                  f"tokens/s, p50 step {r['p50_ms']:.2f} ms, {r['steps']} "
                  f"steps, peak memory {r['peak_gb']:.2f} GB, collectives "
                  f"{r['collectives_per_step']:.1f}/step "
                  f"({r['mb_per_step']:.4f} MB/step sent, {r['staged']} "
                  f"staged through host), launches/step "
                  f"{sum(r['launches'].values()) / max(r['steps'], 1):.1f}"
                  + (f", logits bitwise equal to 1x1: "
                     f"{r['logits_equal']} (max |diff| {r['logit_diff']:.3e})"
                     if "logits_equal" in r else "")
                  + (f", near-tie exemptions {r['near_tie_exempt']}, logit "
                     f"gap {r['logit_gap']:.3e} of max|logit|"
                     if "logit_gap" in r else ""), flush=True)
            if r["mesh"] != "1x1":
                out[name] = {k: n for k, n in r["launches"].items() if n}
    print(f"chip_smoke: serve_mesh took {time.perf_counter() - t0:.1f} s "
          f"({MESH_RANKS} ranks on {card})", flush=True)
    return out


# --- dryrun: the port's dry-run of the production meshes ---------------
# qwen3-0.6b's train and decode cells on 16x16 fake ranks, counted on
# the CPU by a child process that sees no card (CUDA_VISIBLE_DEVICES is
# empty) while the card phases run; its JSON comes back on stdout.
DRYRUN_CELLS = (("qwen3-0.6b", "train_4k"), ("qwen3-0.6b", "decode_32k"))
DRYRUN_TIMEOUT = 900


def start_dryrun():
    """The dry-run child, started (see ``dryrun_child``)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.dryrun_child()"],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def dryrun_child() -> None:
    """Run ``DRYRUN_CELLS`` through ``launch.dryrun.run_cell`` (16x16,
    per-group extrapolation) and print one JSON line: the cells, the
    torch version, whether CUDA was ever initialized, and the ops that
    ran on whole inputs."""
    import logging
    import torch
    logging.getLogger("torch._subclasses.fake_tensor").setLevel(
        logging.CRITICAL)
    from repro_torch.launch import dryrun
    out = {"torch": torch.__version__, "cells": []}
    for arch, shape in DRYRUN_CELLS:
        t = time.perf_counter()
        cell = dryrun.run_cell(arch, shape, verbose=False)
        cell["wall_s"] = time.perf_counter() - t
        out["cells"].append(cell)
    out["cuda_initialized"] = torch.cuda.is_initialized()
    print(json.dumps(out), flush=True)


def finish_dryrun(proc, card) -> None:
    """Wait for the dry-run child and print its cells' per-device counts
    and roofline terms (H100 peaks) beside the card; fail if it failed,
    or touched a device."""
    try:
        stdout, stderr = proc.communicate(timeout=DRYRUN_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"dryrun: no result in {DRYRUN_TIMEOUT} s")
    if proc.returncode != 0:
        fail(f"dryrun: the child exited {proc.returncode}: "
             f"{stderr.strip()[-2000:]}")
    res = json.loads(stdout.strip().splitlines()[-1])
    if res["cuda_initialized"]:
        fail("dryrun: the child initialized CUDA (the dry-run allocates "
             "nothing on any device)")
    for c in res["cells"]:
        print(f"dryrun {c['arch']} x {c['shape']} on 16x16 fake ranks "
              f"(torch {res['torch']}, counted on the CPU in "
              f"{c['wall_s']:.1f} s; roofline terms at one {card}'s "
              f"published peaks): flops/device "
              f"{c['flops_per_device']:.4g}, bytes/device "
              f"{c['bytes_per_device']:.4g}, collectives/device "
              f"{json.dumps(c['collectives'])} "
              f"({c['collective_bytes_per_device']:.4g} B) | compute "
              f"{c['compute_s'] * 1e3:.4f} ms, memory "
              f"{c['memory_s'] * 1e3:.4f} ms, collective "
              f"{c['collective_s'] * 1e3:.4f} ms -> {c['bottleneck']} | "
              f"argument {c['argument_bytes']} B, output "
              f"{c['output_bytes']} B, temp {c['temp_bytes']} B | "
              f"model flops {c['model_flops']:.4g}, mfu {c['mfu']:.4g}",
              flush=True)
        if not c["flops_per_device"] > 0 or not c["collectives"].get(
                "all-gather"):
            fail(f"dryrun {c['arch']} x {c['shape']}: no work or no FSDP "
                 "all-gather counted")


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
    child = start_dryrun()
    try:
        _phases(torch, np, dev, card, child)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()


def _phases(torch, np, dev, card, child) -> None:
    """Every card phase, then the dry-run child's cells, the kernel JSON
    line and the device line."""

    kernels = [check_matmul(torch, dev, name) for name in MATMULS]
    q8 = kernels[list(MATMULS).index("matmul_q8_0")]
    q8["recurrent"] = time_matmul_recurrent(torch, dev)
    q8["dense"] = time_matmul_recurrent(torch, dev, DENSE_LINEARS)
    kernels.append(check_paged_attention(torch, np, dev))
    kernels.append(check_paged_int8(torch, np, dev))
    kernels.append(check_flash(torch, dev))
    kernels += check_paged_mla(torch, np, dev)
    check_shard_plans(torch, dev)
    print(f"chip_smoke: kernel phase done at {time.perf_counter() - T0:.1f} "
          "s", flush=True)

    from repro_torch.launch import serve
    routes = record_routes(torch)
    by_serve = {}
    # The recurrent phase's timed runs come first: its mamba2 step makes
    # ~6,800 launches, the most exposed to a profiler session's slowdown.
    t_rec = time.perf_counter()
    by_serve.update(serve_recurrent(torch, dev, serve))
    t_rec = time.perf_counter() - t_rec
    t_cond = time.perf_counter()
    by_serve.update(serve_conditioned(torch, dev, serve))
    t_cond = time.perf_counter() - t_cond
    t_dense = time.perf_counter()
    by_serve.update(serve_dense(torch, dev, serve))
    t_dense = time.perf_counter() - t_dense
    by_serve.update(train_phase(torch, dev, serve, card))
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
    # The mesh ranks are processes of their own (no profiler session in
    # them); the card is handed to them without this process's weights.
    by_serve.update(serve_mesh(torch, dev, serve, card))
    t0 = time.perf_counter()
    check_recurrent(torch, dev, serve)
    print(f"chip_smoke: recurrent phase took "
          f"{t_rec + time.perf_counter() - t0:.1f} s (serves and checks)",
          flush=True)
    t0 = time.perf_counter()
    check_conditioned(torch, dev, serve)
    print(f"chip_smoke: conditioned phase took "
          f"{t_cond + time.perf_counter() - t0:.1f} s (serves and checks)",
          flush=True)
    t0 = time.perf_counter()
    check_dense(torch, dev, serve)
    print(f"chip_smoke: dense phase took "
          f"{t_dense + time.perf_counter() - t0:.1f} s (serves and checks)",
          flush=True)

    check_routes({k: v for k, v in routes.items() if "matmul" not in k},
                 "the model paths' attention (serves, prefills, checks)",
                 ("flash", "paged GQA", "paged MLA"))
    finish_dryrun(child, card)
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
