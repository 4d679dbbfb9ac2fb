"""Synthetic data pipeline — deterministic, stateless, resumable; ported
from ``repro.train.data``.

Every batch is a pure function of (seed, step): after a failure/restart the
trainer resumes at step k and the pipeline regenerates exactly the batches
it would have produced — data-state checkpointing is just the step counter
(recorded in the checkpoint's ``extra``). Each batch is drawn from a
``torch.Generator`` seeded from (seed, step); the tokens are not
``jax.random``'s, the distributions and layout are.

Two task distributions:
  * "lm": uniform random tokens (throughput workloads)
  * "copy": copy-task with learnable structure (loss provably decreases —
    used by the trainer tests and ``chip_smoke.py``'s train phase)
"""
from __future__ import annotations

from typing import Dict, Iterator

import torch

# Odd multiplier that spreads (seed, step) over the generator's seeds.
_SEED_STRIDE = 1_000_003


class SyntheticDataset:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, task: str = "copy", pool: int = 0,
                 device="cpu"):
        """``pool``: cycle over a fixed pool of distinct batches (0 = fresh
        batch every step). Tests use a small pool so convergence is
        measurable in tens of steps; production uses pool=0. Batches are
        made on ``device``."""
        if task not in ("copy", "lm"):
            raise ValueError(f"unknown task {task!r}: copy or lm")
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = global_batch
        self.seed = seed
        self.task = task
        self.pool = pool
        self.device = torch.device(device)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        eff = step % self.pool if self.pool else step
        gen = torch.Generator(device="cpu")
        gen.manual_seed(self.seed * _SEED_STRIDE + eff)
        if self.task == "copy":
            # First half random, second half copies the first: the model
            # can learn to predict the second half.
            half = self.seq // 2
            first = torch.randint(0, self.vocab, (self.batch, half),
                                  generator=gen, dtype=torch.int32)
            tokens = torch.cat([first, first], dim=1)
            if tokens.shape[1] < self.seq:
                tokens = torch.nn.functional.pad(
                    tokens, (0, self.seq - tokens.shape[1]))
        else:
            tokens = torch.randint(0, self.vocab, (self.batch, self.seq),
                                   generator=gen, dtype=torch.int32)
        labels = torch.cat([tokens[:, 1:],
                            torch.full((self.batch, 1), -1,
                                       dtype=torch.int32)], dim=1)
        return {"tokens": tokens.to(self.device),
                "labels": labels.to(self.device)}

    def iterate(self, start_step: int = 0) -> Iterator[Dict]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1
