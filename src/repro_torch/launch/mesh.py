"""Meshes over ``torch.distributed``: the serving meshes (one process per
mesh device) and the dry-run's production meshes (``make_production_mesh``,
256 or 512 fake ranks in one process).

The port's counterpart of ``repro.launch.mesh.make_host_mesh`` and of
the JAX package's SPMD partitioning. A ``--dp D --tp T`` serve runs D*T
ranks; rank (d, m) of a ('data', 'model') mesh holds the 'model' shard
m of every weight the rules cut (``parallel/sharding.py``) and data
replica d's slots.

Devices and backend: a rank's device is card ``local_rank //
ranks_per_device`` (the CPU for a CPU run). ``ranks_per_device`` K > 1
lets K ranks share one card — the counterpart of XLA's forced host
devices, and how one card holds a mesh: the device check is
``D*T <= devices * K`` (the CPU counts as one device). NCCL is the
backend when every rank has a card of its own, gloo when ranks share
one or run on the CPU. Gloo's collectives take host tensors, so a
collective of card tensors under gloo is staged through host copies
here, explicitly, and counted (``ServingMesh.stats``); the kernels stay
on the card.

``spawn`` starts the ranks (``torch.multiprocessing``, the spawn
method) and returns each rank's result (on the card, rank 0 loads — and
if need be builds — the kernel libraries before the others load them,
``load_kernels``); under ``torchrun`` the launcher
joins the ranks it is given instead (``joined_from_env``). Every rank
must build every mesh (``make_host_mesh``) in the same order: process
groups are created collectively over the world.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import queue
import socket
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# A collective that waits this long has lost a peer: fail, never hang.
TIMEOUT = datetime.timedelta(seconds=600)


class ProductionMesh:
    """A production mesh for the dry-run: ``device_mesh`` a
    ``torch.distributed`` ``DeviceMesh`` of fake ranks, with the axis
    names and sizes the sharding rules read (``shape`` a dict, as the
    JAX package's ``Mesh.shape``) and ``devices`` its rank count."""

    def __init__(self, device_mesh, axis_names: Sequence[str],
                 sizes: Sequence[int]):
        self.device_mesh = device_mesh
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, sizes))
        self.devices = 1
        for n in sizes:
            self.devices *= n

    def __repr__(self) -> str:
        dims = "x".join(str(n) for n in self.shape.values())
        return f"ProductionMesh({dims} {self.axis_names})"


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 ('data', 'model') = 256 ranks single-pod, or 2x16x16 ('pod',
    'data', 'model') = 512 ranks across two pods, as a ``ProductionMesh``
    over a *fake* process group in which this process is rank 0
    (``make_fake_mesh``): the counterpart of the JAX dry-run's 512 forced
    host devices. A context manager."""
    if multi_pod:
        return make_fake_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_fake_mesh((16, 16), ("data", "model"))


@contextlib.contextmanager
def make_fake_mesh(sizes: Sequence[int], axes: Sequence[str]):
    """A ``ProductionMesh`` of ``sizes`` over a fake process group of as
    many ranks, this process rank 0. Its collectives move nothing and
    return at once; with ``FakeTensorMode`` tensors nothing is allocated
    either. The fake group is the process's default group only inside
    the context (it refuses to start in a process that already has one,
    and destroys its own on exit), so it never outlives the dry-run."""
    from torch.distributed.device_mesh import init_device_mesh
    # Importing the module registers the "fake" backend.
    from torch.testing._internal.distributed.fake_pg import FakeStore
    sizes, axes = tuple(sizes), tuple(axes)
    if dist.is_initialized():
        raise RuntimeError("make_production_mesh needs a process without a "
                           "process group: its fake group of "
                           f"{sizes} ranks would replace the default one")
    world = 1
    for n in sizes:
        world *= n
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield ProductionMesh(init_device_mesh("cpu", sizes,
                                              mesh_dim_names=axes),
                             axes, sizes)
    finally:
        dist.destroy_process_group()


def backend_for(device_type: str, ranks_per_device: int) -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    return "nccl" if device_type == "cuda" and ranks_per_device == 1 \
        else "gloo"


def device_capacity(device_type: str, ranks_per_device: int) -> int:
    """Mesh devices the ranks may occupy: cards (the CPU counts as one)
    times ``ranks_per_device``."""
    n = torch.cuda.device_count() if device_type == "cuda" else 1
    return n * ranks_per_device


def rank_device(device_type: str, local_rank: int,
                ranks_per_device: int) -> torch.device:
    """Card ``local_rank // ranks_per_device``, or the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", local_rank // ranks_per_device)


class ServingMesh:
    """A (data, model) mesh over world ranks ``ranks`` (row-major: rank
    ``ranks[d * model + m]`` is mesh coordinate (d, m)). Built on every
    world rank (its groups are created collectively); ``member`` says
    whether this rank is in it; its 'data' and 'model' process groups
    are the mesh's axes."""

    axis_names = ("data", "model")

    def __init__(self, data: int, model: int, ranks: Sequence[int], *,
                 device: torch.device, backend: str, devices: int,
                 shared: bool):
        self.shape = {"data": data, "model": model}
        self.ranks = list(ranks)
        self.device = device
        self.backend = backend
        self.devices = devices
        self.shared = shared            # the ranks share one device
        me = dist.get_rank()
        grid = [self.ranks[d * model:(d + 1) * model] for d in range(data)]
        self._groups: Dict[str, object] = {}
        # Every world rank creates every group, in the same order.
        for m in range(model):
            g = dist.new_group([row[m] for row in grid], timeout=TIMEOUT,
                               backend=backend)
            if me in [row[m] for row in grid]:
                self._groups["data"] = g
        for row in grid:
            g = dist.new_group(row, timeout=TIMEOUT, backend=backend)
            if me in row:
                self._groups["model"] = g
        self._all = dist.new_group(self.ranks, timeout=TIMEOUT,
                                   backend=backend)
        self.member = me in self.ranks
        self.coords = {}
        if self.member:
            i = self.ranks.index(me)
            self.coords = {"data": i // model, "model": i % model}
        self.reset_stats()

    def __repr__(self) -> str:
        return self.describe()

    def describe(self) -> str:
        """``mesh dp=2 tp=2 backend=gloo devices=cuda:0\u00d74``."""
        dev = str(self.device)
        n = len(self.ranks)
        return (f"mesh dp={self.shape['data']} tp={self.shape['model']} "
                f"backend={self.backend} devices={dev}\u00d7{n}")

    def reset_stats(self) -> None:
        """Zero the collective counters."""
        self.stats = {"collectives": 0, "bytes": 0, "staged": 0,
                      "by_axis": {"data": 0, "model": 0}}

    def all_gather(self, x: torch.Tensor, axis: str,
                   dim: int) -> torch.Tensor:
        """Concatenate the ``axis`` group's tensors along ``dim`` (group
        order = mesh order). Bytes move as bytes (no arithmetic), so any
        dtype gathers bit-exactly. Card tensors under gloo go through
        pinned host buffers (counted as staged): one copy down, which
        waits for this rank's queued work, and one asynchronous copy of
        the gathered bytes back up."""
        n = self.shape[axis]
        if n == 1:
            return x
        x = x.contiguous()
        staged = self.backend == "gloo" and x.device.type == "cuda"
        flat = x.reshape(-1).view(torch.uint8)
        src = flat
        if staged:
            src = torch.empty(flat.shape, dtype=torch.uint8, pin_memory=True)
            src.copy_(flat)
        out = torch.empty((n * flat.numel(),), dtype=torch.uint8,
                          device=src.device, pin_memory=staged)
        dist.all_gather_into_tensor(out, src, group=self._groups[axis])
        if staged:
            out = out.to(x.device, non_blocking=True)
        parts = out.view(x.dtype).view((n,) + tuple(x.shape)).unbind(0)
        self.stats["collectives"] += 1
        self.stats["by_axis"][axis] += 1
        self.stats["bytes"] += flat.numel()
        self.stats["staged"] += int(staged)
        return torch.cat(parts, dim=dim)

    def serialized(self, fn: Callable, *args):
        """Run ``fn(*args)`` on the mesh's ranks one at a time, in mesh
        order (a barrier of the mesh's ranks between turns) when they
        share a device, so only one build's transient memory is on it at
        a time; at once otherwise. Members only."""
        if not self.shared:
            return fn(*args)
        out = None
        for r in self.ranks:
            if r == dist.get_rank():
                out = fn(*args)
            dist.barrier(group=self._all)
        return out

    def all_gather_objects(self, obj, axis: str) -> list:
        """The ``axis`` group's picklable objects, in mesh order (host
        bookkeeping, not counted as a step's collective)."""
        out = [None] * self.shape[axis]
        dist.all_gather_object(out, obj, group=self._groups[axis])
        return out


def make_host_mesh(data: int = 1, model: int = 1,
                   ranks: Optional[Sequence[int]] = None, *,
                   device: Optional[torch.device] = None,
                   ranks_per_device: int = 1) -> ServingMesh:
    """A (data, model) ``ServingMesh`` over ``ranks`` (the first
    ``data * model`` world ranks by default). Collective: every world
    rank calls it with the same arguments."""
    ranks = list(range(data * model)) if ranks is None else list(ranks)
    if len(ranks) != data * model:
        raise ValueError(f"a {data}x{model} mesh takes {data * model} ranks,"
                         f" got {len(ranks)}")
    if max(ranks) >= dist.get_world_size():
        raise ValueError(f"mesh ranks {ranks} exceed the world of "
                         f"{dist.get_world_size()}")
    dev = device or torch.device("cpu")
    return ServingMesh(data, model, ranks, device=dev,
                       backend=dist.get_backend(),
                       devices=device_capacity(dev.type, ranks_per_device),
                       shared=ranks_per_device > 1)


class Rank:
    """What a spawned rank knows: its rank, the world size, its device
    and the backend."""

    def __init__(self, rank: int, world: int, device: torch.device,
                 backend: str, ranks_per_device: int):
        self.rank, self.world = rank, world
        self.device, self.backend = device, backend
        self.ranks_per_device = ranks_per_device


def init_rank(rank: int, world: int, *, device_type: str,
              ranks_per_device: int, init_method: str) -> Rank:
    """Join the process group as ``rank`` of ``world`` and pick the
    rank's device (``rank_device``) and backend (``backend_for``)."""
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = rank_device(device_type, local, ranks_per_device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend_for(device_type, ranks_per_device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, timeout=TIMEOUT,
                            **({"device_id": dev} if backend == "nccl"
                               else {}))
    return Rank(rank, world, dev, backend, ranks_per_device)


def load_kernels(ctx: Rank) -> None:
    """Rank 0 loads (and if need be builds, into ``build/``) every kernel
    library before a barrier; the other ranks load them after it, so
    ranks on a fresh tree never run nvcc side by side."""
    from repro_torch.kernels import _build
    if ctx.rank == 0:
        _build.build_all()
        for name in _build.sources():
            _build.load(name)
    dist.barrier()
    if ctx.rank:
        for name in _build.sources():
            _build.load(name)


def teardown() -> None:
    """Leave the process group."""
    if dist.is_initialized():
        dist.destroy_process_group()


def joined_from_env() -> bool:
    """Whether the process runs under ``torchrun`` (its environment
    names this rank and the world)."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                         "MASTER_ADDR", "MASTER_PORT"))


def free_port() -> int:
    """A free TCP port on localhost for the ranks' rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank, fn, world, init_method, device_type, ranks_per_device,
           threads, results, args):
    if threads:
        torch.set_num_threads(threads)
    ctx = init_rank(rank, world, device_type=device_type,
                    ranks_per_device=ranks_per_device,
                    init_method=init_method)
    try:
        if device_type == "cuda":
            load_kernels(ctx)
        out = fn(ctx, *args)
        results.put((rank, out))
        dist.barrier()
    finally:
        teardown()


def spawn(fn: Callable, world: int, args: tuple = (), *,
          device_type: str = "cuda", ranks_per_device: int = 1,
          threads: int = 0) -> List:
    """Run ``fn(Rank, *args)`` on ``world`` new processes joined over
    ``tcp://localhost`` and return their results in rank order. ``fn``
    must be importable (a module-level function); ``threads``: torch
    threads per rank (0 leaves torch's default). A rank that raises
    fails the call (the others are terminated): no rank's failure is
    swallowed."""
    mctx = mp.get_context("spawn")
    results = mctx.Queue()
    init = f"tcp://localhost:{free_port()}"
    procs = mp.start_processes(
        _entry, args=(fn, world, init, device_type, ranks_per_device,
                      threads, results, args),
        nprocs=world, join=False, start_method="spawn")
    got: Dict[int, object] = {}
    done = False
    while len(got) < world:
        try:
            r, out = results.get(timeout=0.2)
            got[r] = out
        except queue.Empty:
            if done:
                raise RuntimeError(f"ranks {sorted(set(range(world)) - set(got))}"
                                   " exited without a result")
            done = procs.join(timeout=0)       # raises if a rank failed
    while not procs.join():
        pass
    return [got[r] for r in range(world)]
