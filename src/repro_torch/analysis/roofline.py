"""Roofline analysis of the dry-run's per-device counts.

Three terms per (arch x shape x mesh) cell, in seconds:

  compute    = flops_per_device / peak bf16 FLOP/s
  memory     = bytes_per_device / HBM bandwidth
  collective = collective_bytes_per_device / link bandwidth

The port of ``repro.analysis.roofline``: the same ``Roofline`` fields,
``to_dict`` keys and ``model_flops_for``. The JAX package reads its
counts from a compiled XLA executable (``cost_analysis``, the
partitioned HLO text, ``memory_analysis``); the port runs the step once
under ``FakeTensorMode`` on a mesh of fake ranks and counts what rank 0
dispatches on its *local shards*, below DTensor (``DeviceCounter``):

* flops: the matrix products' (``torch.utils.flop_counter``'s rules:
  mm, bmm, addmm, baddbmm, the attention ops), 2 a multiply-add; XLA
  also counts one flop an element of every elementwise op, the port
  does not;
* bytes: each dispatched op's local input and output bytes (views and
  allocations move none). The port runs eagerly and unfused, so an
  intermediate is written by one op and read by the next: not
  comparable to XLA's fused count, and larger;
* collectives: by kind (all-gather, all-reduce, reduce-scatter,
  all-to-all, collective-permute), the result bytes of each
  ``_c10d_functional`` collective, JAX's rule (result-shape bytes);
* argument bytes (the step's inputs' local bytes: parameters, optimizer
  state, batch or cache), output bytes (its outputs'), and temporary
  bytes: the peak of the live local storage the step's ops allocate.

Hardware constants: one NVIDIA H100 80GB HBM3 at its 700 W limit
(NVIDIA's data sheet, SXM part, dense): 989 TFLOP/s bf16, 3.35 TB/s
HBM; the link term is the published NVLink 4 figure, 900 GB/s a GPU
both ways over 18 links, 450 GB/s one way (no NVLink was measured:
the port's mesh ranks have so far shared one card).
"""
from __future__ import annotations

import dataclasses
import os
import sys
import weakref
from typing import Dict

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.parallel.sharding import ShardedRun

PEAK_FLOPS = 989e12          # bf16 dense per H100 (700 W)
HBM_BW = 3.35e12             # bytes/s per H100
LINK_BW = 450e9              # bytes/s one way per H100 (NVLink 4, published)

# _c10d_functional op name -> the JAX package's collective kind.
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "permute_tensor": "collective-permute",
}
# Ops that move no bytes: allocations (and the views, by schema).
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "lift_fresh"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


_PROPAGATION = os.path.join("distributed", "tensor", "_sharding_prop.py")


def _propagating() -> bool:
    """Whether DTensor's sharding propagation is on the call stack: it
    runs an op on whole-shape fake tensors to learn its output's shape,
    which is no rank's work."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith(_PROPAGATION):
            return True
        f = f.f_back
    return False


class DeviceCounter(ShardedRun):
    """Counts what rank 0 runs in a step on DTensors (see ``ShardedRun``
    for how a step's ops reach the local tensors): each op on local
    tensors, its flops, bytes and collectives, and the live bytes of the
    storage it allocates. What a failed attempt of an op counted is
    dropped; the ops DTensor's sharding propagation runs on whole-shape
    fake tensors are not counted. Use inside the ``FakeTensorMode`` the
    step runs under."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_rules = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: Dict[str, int] = {}
        # (kind, process group name) -> bytes
        self.by_group: Dict[tuple, int] = {}
        self.live = 0
        self.peak = 0
        self._seen = weakref.WeakValueDictionary()

    def _snapshot(self):
        return (self.flops, self.bytes, dict(self.collectives),
                dict(self.by_group))

    def _restore(self, state) -> None:
        self.flops, self.bytes, self.collectives, self.by_group = state

    def _local_op(self, func, ins, args, kwargs, out) -> None:
        if not _propagating():
            self._count(func, ins, args, kwargs, out)

    def _count(self, func, ins, args, kwargs, out) -> None:
        name = func.__name__.split(".")[0]
        ns = func.namespace
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if ns.startswith("_c10d_functional") or ns == "c10d":
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                n = sum(_nbytes(t) for t in outs)
                self.collectives[kind] = self.collectives.get(kind, 0) + n
                group = [a for a in args if isinstance(a, str)][-1:]
                key = (kind, group[0] if group else "")
                self.by_group[key] = self.by_group.get(key, 0) + n
        else:
            rule = self._flop_rules.get(func._overloadpacket)
            if rule is not None:
                self.flops += rule(*args, **kwargs, out_val=out)
            if not func.is_view and name not in _FREE \
                    and ns not in ("prim",):
                self.bytes += sum(_nbytes(t) for t in ins) + \
                    sum(_nbytes(t) for t in outs)
        if func.is_view:
            return
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if self._seen.get(key) is st:
                continue
            n = st.nbytes()
            self._seen[key] = st
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def measure(self) -> Dict:
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "collective_bytes": float(sum(self.collectives.values())),
                "collectives": dict(self.collectives)}


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collectives: Dict[str, int]
    n_devices: int
    model_flops: float = 0.0           # 6*N*D or 2*N*tokens
    # memory (per device)
    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline-model step latency = max of the three terms (perfectly
        overlapped execution model)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / counted global FLOPs (catches remat/redundancy)."""
        total = self.flops_per_device * self.n_devices
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model FLOPs utilization at the roofline step time."""
        denom = self.step_time_s * PEAK_FLOPS * self.n_devices
        return self.model_flops / denom if denom else 0.0

    def to_dict(self) -> Dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "collectives": self.collectives,
            "n_devices": self.n_devices,
            "model_flops": self.model_flops,
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "temp_bytes": self.temp_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "step_time_s": self.step_time_s,
            "useful_flops_fraction": self.useful_flops_fraction,
            "mfu": self.mfu,
        }


def analyze(lowered, n_devices: int, model_flops: float = 0.0) -> Roofline:
    """The ``Roofline`` of a lowered cell (``launch.dryrun.lower_cell``:
    its ``counts``, a ``DeviceCounter.measure()``, and its memory
    terms)."""
    c = lowered.counts
    return Roofline(
        flops_per_device=c["flops"],
        bytes_per_device=c["bytes"],
        collective_bytes_per_device=c["collective_bytes"],
        collectives=c["collectives"],
        n_devices=n_devices,
        model_flops=model_flops,
        argument_bytes=lowered.argument_bytes,
        output_bytes=lowered.output_bytes,
        temp_bytes=lowered.temp_bytes,
    )


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N*D (train), 2*N*tokens (prefill), 2*N*B (decode);
    N = active parameters (MoE-aware)."""
    counts = cfg.param_counts()
    n_active = counts["active"]
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch
