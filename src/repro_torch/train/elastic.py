"""Elasticity, straggler mitigation, failure handling; ported from
``repro.train.elastic``.

  * ``StepMonitor`` — per-step deadline tracking; steps slower than
    ``straggler_factor`` x the rolling median are flagged (the response is
    to checkpoint, which ``ElasticRunner`` does).
  * ``ElasticRunner.run`` — the fault-tolerant outer loop: restore-or-init,
    periodic (async) checkpoints, retry-on-exception with restore (a thrown
    step is indistinguishable from a preempted node), prune at the end.

A step's time ends when its loss is read back to the host (the JAX
package's ``block_until_ready``): on the card that waits for the step's
kernels.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Dict, List, Optional

from repro_torch.configs.base import TrainConfig
from repro_torch.train import checkpoint as ckpt_lib


@dataclasses.dataclass
class StepMonitor:
    straggler_factor: float = 3.0
    window: int = 32
    durations: List[float] = dataclasses.field(default_factory=list)
    stragglers: int = 0

    def record(self, seconds: float) -> bool:
        """Returns True if this step is a straggler."""
        self.durations.append(seconds)
        hist = self.durations[-self.window:]
        if len(hist) < 5:
            return False
        med = statistics.median(hist[:-1])
        is_straggler = seconds > self.straggler_factor * med
        if is_straggler:
            self.stragglers += 1
        return is_straggler


class ElasticRunner:
    """Fault-tolerant training outer loop. A restore places the
    checkpoint's tensors where ``init_fn`` makes the parameters."""

    def __init__(self, train_cfg: TrainConfig, train_step: Callable,
                 init_fn: Callable, data, *, max_restarts: int = 3,
                 on_step: Optional[Callable] = None):
        self.cfg = train_cfg
        self.train_step = train_step
        self.init_fn = init_fn
        self.data = data
        self.max_restarts = max_restarts
        self.on_step = on_step
        self.monitor = StepMonitor()
        self.writer = ckpt_lib.AsyncWriter()
        self.restarts = 0

    def _resume(self):
        step, params, opt_state, _ = ckpt_lib.restore_or_init(
            self.cfg.checkpoint_dir, lambda: (0,) + self.init_fn())
        return step, params, opt_state

    def run(self, total_steps: Optional[int] = None) -> Dict:
        total = total_steps or self.cfg.total_steps
        step, params, opt_state = self._resume()
        metrics = {}
        while step < total:
            try:
                batch = self.data.batch_at(step)
                t0 = time.perf_counter()
                params, opt_state, metrics = self.train_step(
                    params, opt_state, batch)
                float(metrics["loss"])           # waits for the step
                dt = time.perf_counter() - t0
                if self.monitor.record(dt):
                    # Straggler response: force a checkpoint so an evict /
                    # re-mesh loses no work.
                    self._checkpoint(step + 1, params, opt_state)
                step += 1
                if self.on_step:
                    self.on_step(step, metrics, dt)
                if step % self.cfg.checkpoint_every == 0:
                    self._checkpoint(step, params, opt_state)
            except Exception:
                # Node-failure path: restore from the last durable state.
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                self.writer.wait()
                step, params, opt_state = self._resume()
        self._checkpoint(step, params, opt_state)
        self.writer.wait()
        ckpt_lib.prune(self.cfg.checkpoint_dir, self.cfg.keep_checkpoints)
        return {"step": step, "metrics": metrics,
                "restarts": self.restarts,
                "stragglers": self.monitor.stragglers}

    def _checkpoint(self, step, params, opt_state):
        extra = {"data_step": step}
        if self.cfg.async_checkpoint:
            self.writer.submit(self.cfg.checkpoint_dir, step, params,
                               opt_state, extra)
        else:
            ckpt_lib.save(self.cfg.checkpoint_dir, step, params, opt_state,
                          extra)
        ckpt_lib.prune(self.cfg.checkpoint_dir, self.cfg.keep_checkpoints)
