"""Sharding rules, ported from ``repro.parallel.sharding``: the training
half (the production meshes' FSDP x TP rules, which the dry-run reads)
and the serving half (``serving_*``, ``slot_sharding``,
``activation_mesh``/``constrain_replicated``).

Training half. Mesh axes: ('data', 'model') single-pod 16x16; ('pod',
'data', 'model') multi-pod 2x16x16. Batch shards over ('pod', 'data')
(the DP/FSDP axes); weights shard 2D over ('data', 'model') (FSDP x
TP); KV caches shard batch over the DP axes and *sequence* over
'model'. Every rule checks divisibility and leaves an indivisible dim
whole, exactly as the JAX package's. A spec entry that names two axes,
``('pod', 'data')``, shards its dim over both, the first the major one
(``placements``: ``Shard(d)`` on both mesh dims, which DTensor splits in
mesh-dim order, 'pod' before 'data'). ``placements`` maps a spec onto
a ``torch.distributed`` ``DeviceMesh`` (the counterpart of
``NamedSharding``); ``param_specs`` walks the port's tree of per-layer
dicts, each leaf taking the spec its stacked layer-group leaf takes in
the JAX package less the layer axis (a group whose layer axis the rule
would cut over 'model' keeps its layers whole over 'model' here: the
port holds them as separate tensors).

Serving half.

The serving engine demands *token-identical* outputs versus a
single-device run, so the rules only ever shard axes that no reduction
contracts over: weight out-features over ``'model'`` (each shard
computes its output slice with a full-extent contraction, then the
slices are all-gathered — pure data movement) and the slot axis over
``'data'`` (slots are independent). Partial-sum collectives never
appear: a float reassociation on a near-tie would flip sampled tokens.

Deliberately replicated: embedding tables, MoE router gates, norm
gains, and MLA latent pages (their trailing axes are contraction axes,
not heads).

Specs are tuples of axis names or ``None``, spelled as the JAX
package's ``PartitionSpec``s (trailing ``None``s dropped, no size-one
axis named). The rules read only ``mesh.shape`` and
``mesh.axis_names``; ``launch/mesh.py``'s ``ServingMesh`` also carries
this rank's coordinates and the collectives.

The port runs eagerly, one process per mesh device, so GSPMD's implicit
data movement is explicit here:

* ``ModelShard`` marks a linear's (or an expert bank's) plane dict whose
  out-feature axis was cut over ``'model'``; ``layers.linear_apply``
  all-gathers its output (``gather_model``) unless the caller keeps the
  rank's heads (attention's q/k/v);
* ``activation_mesh`` is the scope of a serving step;
  ``constrain_replicated`` (the MoE token path) all-gathers the step's
  data-local rows over ``'data'``, so every replica routes the whole
  step's tokens, and ``data_rows`` keeps this replica's rows after;
* ``plan_parts`` tells a kernel wrapper how many shards the call is one
  of, so it plans its launch from the unsharded shape; ``whole_step``
  gives the paged MLA kernel the whole step's depths, which it plans
  its page walk from.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

AXES = ("data", "model")

# An entry: None, an axis name, or a tuple of axis names (major first).
Spec = Tuple[object, ...]

_SERVING_REPLICATED_PARAM_KEYS = {"embed", "router"}
_GQA_CACHE_KEYS = {"k", "v"}                        # head axis shardable
_QUANT_SCALE_KEY = "s"                              # head axis is last


def _axis_size(mesh, name) -> int:
    if isinstance(name, tuple):
        out = 1
        for n in name:
            out *= mesh.shape.get(n, 1)
        return out
    return mesh.shape.get(name, 1)


def _fits(dim: int, mesh, axis) -> bool:
    return dim > 0 and dim % _axis_size(mesh, axis) == 0


# ----------------------------------------------------------------------
# Training rules (the production meshes)
# ----------------------------------------------------------------------
_CACHE_SEQ_KEYS = {"k", "v", "ckv", "krope"}       # (..., B, S, ...) leaves


def dp_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _dp_entry(mesh):
    dp = dp_axes(mesh)
    return dp if len(dp) > 1 else dp[0]


def weight_spec(shape: Tuple[int, ...], mesh) -> Spec:
    """Generic 2D TP x FSDP rule: last dim -> 'data', the first suitable
    of (-2, -3) -> 'model'; 0/1-D params replicate."""
    if len(shape) < 2:
        return ()
    spec: List = [None] * len(shape)
    if _fits(shape[-1], mesh, "data"):
        spec[-1] = "data"
    for cand in (-2, -3):
        if len(shape) >= -cand and _fits(shape[cand], mesh, "model"):
            spec[cand] = "model"
            break
    return tuple(spec)


def _group_counts(tree) -> Dict[str, int]:
    """{group key: layers} of the port's tree: the keys whose value is a
    list of per-layer dicts (the JAX package's stacked groups)."""
    return {k: len(v) for k, v in tree.items() if isinstance(v, list)}


def param_specs(params, mesh):
    """The tree of specs matching the port's parameter tree (tensors,
    fake tensors or anything with ``.shape``): a leaf of layer group
    ``g`` takes the spec of its stacked leaf ``(layers,) + shape`` less
    the layer axis; any other leaf its own."""
    def leaf(x, layers=None):
        if layers is None:
            return weight_spec(tuple(x.shape), mesh)
        return weight_spec((layers,) + tuple(x.shape), mesh)[1:]

    def walk(node, layers=None):
        if isinstance(node, dict):
            return {k: walk(v, layers) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, len(node) if layers is None else layers)
                    for v in node]
        return leaf(node, layers)
    return walk(params)


def param_shardings(params, mesh):
    """``placements`` of every leaf of ``param_specs`` on ``mesh``."""
    return _map_specs(param_specs(params, mesh), mesh)


def _map_specs(specs, mesh):
    if isinstance(specs, dict):
        return {k: _map_specs(v, mesh) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_map_specs(v, mesh) for v in specs]
    return placements(specs, mesh)


def batch_spec(shape: Tuple[int, ...], mesh) -> Spec:
    """Leading (batch) dim over the DP axes when it divides."""
    spec: List = [None] * len(shape)
    if len(shape) >= 1 and _fits(shape[0], mesh, dp_axes(mesh)):
        spec[0] = _dp_entry(mesh)
    return tuple(spec)


def batch_shardings(batch, mesh):
    return {k: placements(batch_spec(tuple(v.shape), mesh), mesh)
            for k, v in batch.items()}


def cache_spec(path_key: str, shape: Tuple[int, ...], mesh) -> Spec:
    """Caches are stacked (L, B, S, ...) or (L, B, ...): batch over DP,
    sequence over 'model' (flash-decoding)."""
    spec: List = [None] * len(shape)
    if len(shape) >= 2 and _fits(shape[1], mesh, dp_axes(mesh)):
        spec[1] = _dp_entry(mesh)
    if path_key in _CACHE_SEQ_KEYS and len(shape) >= 3 and \
            _fits(shape[2], mesh, "model"):
        spec[2] = "model"
    return tuple(spec)


def cache_shardings(cache, mesh):
    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return placements(cache_spec(key, tuple(node.shape), mesh), mesh)
    return walk(cache)


def activation_spec(mesh, seq_parallel: bool = True) -> Spec:
    """(B, S, D) residual: batch over DP, seq over 'model' with sequence
    parallelism (per-device activation memory, and remat checkpoints,
    1/model of the full sequence)."""
    return (_dp_entry(mesh), "model" if seq_parallel else None, None)


def activation_sharding(mesh, seq_parallel: bool = True):
    """``activation_spec`` as ``placements`` on ``mesh`` (what the train
    step and prefill redistribute the residual to)."""
    return placements(activation_spec(mesh, seq_parallel), mesh)


def replicated(mesh):
    return placements((), mesh)


def sequence_whole(act_sharding):
    """``act_sharding`` with the sequence dim (1) whole: the placements a
    layer's input takes on a training mesh, so that its linears see
    (batch, sequence) rows whose only cut is the batch's (Megatron's
    sequence parallelism: all-gather the sequence at a layer's entry,
    cut it again at its exit)."""
    if act_sharding is None:
        return None
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p
                 for p in act_sharding)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (a training mesh's tensor), without
    importing ``torch.distributed.tensor`` on the serving path."""
    return type(x) is not torch.Tensor and type(x).__name__ == "DTensor"


def iota_like(x, dim: int):
    """``arange(x.shape[dim])`` as a DTensor on ``x``'s mesh, cut as
    ``x``'s ``dim`` is (replicated over every other mesh dim): each rank
    builds its own block, no collective."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dim = dim % x.ndim
    mesh = x.device_mesh
    n = x.shape[dim]
    lo, size, pl = 0, n, []
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            size //= mesh.size(i)
            lo += mesh.get_local_rank(i) * size
            pl.append(Shard(0))
        else:
            pl.append(Replicate())
    local = torch.arange(lo, lo + size, device=x.to_local().device)
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=(n,), stride=(1,))


def feature_whole(x):
    """A DTensor with its last axis made whole (an all-gather over the
    mesh dims cutting it: FSDP's gather of a weight's in-features); any
    other tensor as it is."""
    from torch.distributed.tensor import Replicate, Shard
    if not is_dtensor(x):
        return x
    last = x.ndim - 1
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == last else p
               for p in x.placements)
    return x if pl == tuple(x.placements) else \
        x.redistribute(x.device_mesh, pl)


def heads_whole(x, heads: int):
    """A DTensor whose last dim packs ``heads`` heads, made whole over
    the mesh dims cutting that dim unless they divide ``heads`` (a view
    into heads cannot cut a head); any other tensor as it is."""
    from torch.distributed.tensor import Replicate, Shard
    if not is_dtensor(x):
        return x
    last, parts = x.ndim - 1, 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == last:
            parts *= x.device_mesh.size(i)
    if heads % parts == 0:
        return x
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if isinstance(p, Shard) and p.dim == last else p
        for p in x.placements))


def evenly(x):
    """A DTensor with every cut that does not divide its dim evenly made
    whole (``local_map`` takes a local block's shape times the cut as the
    whole's); any other tensor as it is."""
    from torch.distributed.tensor import Replicate, Shard
    if not is_dtensor(x):
        return x
    pl, parts = [], {}
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard):
            parts[p.dim] = parts.get(p.dim, 1) * x.device_mesh.size(i)
    bad = {d for d, n in parts.items() if x.shape[d] % n}
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim in bad else p
               for p in x.placements)
    return x if not bad else x.redistribute(x.device_mesh, pl)


def batch_only(x):
    """A DTensor cut on its batch dim (0) only: every other cut made
    whole, pending sums reduced; any other tensor as it is."""
    from torch.distributed.tensor import Replicate, Shard
    if not is_dtensor(x):
        return x
    pl = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
               for p in x.placements)
    return x if pl == tuple(x.placements) else \
        x.redistribute(x.device_mesh, pl)


def reduced(x):
    """A DTensor's pending (``Partial``) reductions done, each of those
    mesh dims made ``Replicate()`` (an all-reduce; DTensor would
    otherwise pick a reduce-scatter onto any dim it likes)."""
    from torch.distributed.tensor import Partial, Replicate
    if not is_dtensor(x) or not any(isinstance(p, Partial)
                                    for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if isinstance(p, Partial) else p for p in x.placements))


class ShardedRun(TorchDispatchMode):
    """The mode a step on a training mesh's DTensors runs under (with
    ``implicit_replication``, so that the step's plain tensors count as
    replicated). An op on DTensors is run by DTensor with this mode on
    the stack again, so the local ops it runs, and the collectives its
    redistributions need, reach ``_local_op`` (a subclass's hook). An
    op DTensor has no sharding rule for, or cannot shard these inputs
    for (an indivisible view, a gather it cannot reduce), runs on inputs
    made whole over the last mesh dim, then over the last two, ..., then
    over all (``_whole``); an op without a rule even on replicated
    inputs, on the whole local tensors, its result replicated. Its name
    is kept in ``replicated_ops``."""

    def __init__(self):
        super().__init__()
        from torch.distributed.tensor import DTensor
        self._dtensor = DTensor
        self._inside = False
        self.replicated_ops: Dict[str, int] = {}

    def _snapshot(self):
        return None

    def _restore(self, state) -> None:
        pass

    def _local_op(self, func, ins, args, kwargs, out) -> None:
        pass

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils._pytree import tree_leaves
        kwargs = kwargs or {}
        ins = tree_leaves((args, kwargs))
        dts = [a for a in ins if isinstance(a, self._dtensor)]
        if dts:
            if self._inside:            # this mode's own call below
                return NotImplemented
            self._inside = True
            before = self._snapshot()
            try:
                with self:
                    try:
                        return func(*args, **kwargs)
                    except Exception:       # DTensor could not shard it
                        pass
                    self._restore(before)
                    self._inside = False
                    return self._whole(func, dts[0].device_mesh, args,
                                       kwargs)
            finally:
                self._inside = False
        out = func(*args, **kwargs)
        self._local_op(func, ins, args, kwargs, out)
        return out

    def _whole(self, func, mesh, args, kwargs):
        """``func`` with its DTensor inputs made whole over as few mesh
        dims as it takes (the last first, so a batch cut over the DP
        axes is kept where it can be)."""
        from torch.distributed.tensor import Replicate
        from torch.utils._pytree import tree_map
        name = str(func)
        self.replicated_ops[name] = self.replicated_ops.get(name, 0) + 1
        for k in range(mesh.ndim - 1, -1, -1):
            def whole(a, k=k):
                if not isinstance(a, self._dtensor):
                    return a
                pl = [Replicate() if i >= k else p
                      for i, p in enumerate(a.placements)]
                return a.redistribute(mesh, pl)
            self._inside = True
            before = self._snapshot()
            try:
                with self:
                    try:
                        return func(*tree_map(whole, args),
                                    **tree_map(whole, kwargs))
                    except Exception:
                        pass
                self._restore(before)
            finally:
                self._inside = False
        rep = [Replicate()] * mesh.ndim

        def local(a):
            if not isinstance(a, self._dtensor):
                return a
            return a.redistribute(mesh, rep).to_local()
        out = func(*tree_map(local, args), **tree_map(local, kwargs))
        return tree_map(lambda o: self._dtensor.from_local(
            o, mesh, rep, run_check=False)
            if isinstance(o, torch.Tensor) else o, out)


def constrain(x: torch.Tensor, act_sharding) -> torch.Tensor:
    """``x`` redistributed to the placements ``act_sharding`` on its mesh
    when it is a DTensor (a training mesh's activation); else ``x`` as
    it is (off a mesh a constraint changes no value)."""
    if act_sharding is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, tuple(act_sharding))


def placements(spec: Spec, mesh) -> tuple:
    """``spec`` as DTensor placements on ``mesh`` (a production mesh,
    ``launch.mesh.ProductionMesh``): mesh dim i takes ``Shard(d)`` where
    spec entry d names axis i (alone or in a tuple), else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.axis_names:
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


# ----------------------------------------------------------------------
# Serving rules
# ----------------------------------------------------------------------
def _trimmed(spec: List) -> Spec:
    """Spec with trailing Nones dropped (the JAX package's normal
    spelling, which its rule tests pin)."""
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _serving_fits(dim: int, mesh, axis: str) -> bool:
    """Whether a serving rule may put ``axis`` on a ``dim``-sized array
    axis: divisible AND the mesh axis is real (size > 1)."""
    return _axis_size(mesh, axis) > 1 and _fits(dim, mesh, axis)


def serving_degrees(mesh) -> Tuple[int, int]:
    """(dp, tp) axis sizes of a ('data', 'model') serving mesh (1, 1 if
    None)."""
    if mesh is None:
        return 1, 1
    return mesh.shape.get("data", 1), mesh.shape.get("model", 1)


def validate_serving_mesh(mesh, *, num_heads: int, num_kv_heads: int,
                          vocab_size: int, num_slots: int,
                          devices: Optional[int] = None) -> None:
    """Fail fast on meshes the exact serving rules cannot honor: axes
    other than ('data', 'model'), more mesh devices than ``devices``
    (the mesh's own count when None), and head/vocab/slot counts the
    axes do not divide (replication would silently defeat the sharding
    the caller asked for, so refuse instead)."""
    extra = [a for a in mesh.axis_names if a not in AXES]
    if extra:
        raise ValueError(f"serving mesh axes must be ('data','model'); "
                         f"got unknown axes {extra}")
    dp, tp = serving_degrees(mesh)
    avail = getattr(mesh, "devices", dp * tp) if devices is None \
        else devices
    if dp * tp > avail:
        raise ValueError(f"mesh {dp}x{tp} needs {dp * tp} devices but only "
                         f"{avail} are available")
    if tp > 1:
        if num_heads % tp:
            raise ValueError(f"num_heads={num_heads} not divisible by "
                             f"tp={tp}")
        if num_kv_heads % tp:
            raise ValueError(f"num_kv_heads={num_kv_heads} not divisible "
                             f"by tp={tp}")
        if vocab_size % tp:
            raise ValueError(f"vocab_size={vocab_size} not divisible by "
                             f"tp={tp}")
    if dp > 1 and num_slots % dp:
        raise ValueError(f"num_slots={num_slots} not divisible by dp={dp}")


def serving_weight_spec(path_keys: Tuple[str, ...], shape: Tuple[int, ...],
                        mesh) -> Spec:
    """TP spec for one weight leaf: out-features (axis -2) over 'model'.
    Weights are stored ``(..., out, in)`` (quant planes keep the same
    leading out axis), so axis -2 is never contracted. Leaves under the
    embedding or an MoE router, 1-D leaves and indivisible out axes
    replicate."""
    if len(shape) < 2 or any(k in _SERVING_REPLICATED_PARAM_KEYS
                             for k in path_keys):
        return ()
    if _serving_fits(shape[-2], mesh, "model"):
        spec = [None] * len(shape)
        spec[-2] = "model"
        return _trimmed(spec)
    return ()


def serving_cache_spec(path_keys: Tuple[str, ...], shape: Tuple[int, ...],
                       mesh) -> Spec:
    """Spec for one paged-arena leaf ``(L, pages, block, [heads], dim)``:
    physical pages over 'data'; GQA K/V leaves also shard the kv-head
    axis over 'model' (axis -2 for value planes, -1 for the int8 scale
    plane ``s``). MLA latents (``ckv``/``krope``) page-shard only."""
    spec = [None] * len(shape)
    if len(shape) >= 2 and _serving_fits(shape[1], mesh, "data"):
        spec[1] = "data"
    if any(k in _GQA_CACHE_KEYS for k in path_keys):
        head_ax = len(shape) - (1 if path_keys[-1] == _QUANT_SCALE_KEY else 2)
        if head_ax >= 2 and _serving_fits(shape[head_ax], mesh, "model"):
            spec[head_ax] = "model"
    return _trimmed(spec)


def slot_sharding(mesh, ndim: int) -> Spec:
    """Per-slot operand spec: the leading slot axis over 'data' in
    contiguous blocks (replica r holds slots [r*ns/dp, (r+1)*ns/dp)),
    replicated on a dp=1 mesh."""
    del ndim  # trailing Nones are dropped (see _trimmed)
    return () if _axis_size(mesh, "data") == 1 else ("data",)


def local_slice(size: int, mesh, axis: str) -> slice:
    """This rank's block of a ``size``-long axis cut over ``axis``."""
    n = _axis_size(mesh, axis)
    part = size // n
    i = mesh.coords[axis]
    return slice(i * part, (i + 1) * part)


def apply_spec(t: torch.Tensor, spec: Spec, mesh,
               skip: Sequence[str] = ()) -> torch.Tensor:
    """This rank's slice of ``t`` under ``spec``: every named axis (but
    those in ``skip``) cut into equal contiguous blocks, the block at
    this rank's coordinate kept (a contiguous copy when cut, ``t``
    itself when nothing is)."""
    out = t
    for ax, name in enumerate(spec):
        if name is None or name in skip:
            continue
        out = out[(slice(None),) * ax + (local_slice(t.shape[ax], mesh,
                                                     name),)]
    return out if out is t else out.contiguous()


class ModelShard(dict):
    """A linear's (or an MoE expert bank's) plane dict whose out-feature
    axis (-2 of every plane) holds this rank's block of ``parts`` over
    'model'; 1-D leaves (a bias) stay whole."""

    def __init__(self, planes: Dict, parts: int, index: int):
        super().__init__(planes)
        self.parts = parts
        self.index = index


def is_model_shard(p) -> bool:
    return isinstance(p, ModelShard)


# ----------------------------------------------------------------------
# The step scope and its collectives
# ----------------------------------------------------------------------
# (mesh, data_local, whole step) frames: the mesh whose collectives the
# step uses, whether its activation rows are this replica's slots only,
# and then the whole step's (positions, lengths).
_ACTIVATION_CTX: List[Tuple[object, bool, Optional[tuple]]] = []


@contextlib.contextmanager
def activation_mesh(mesh, data_local: bool = False,
                    whole_step: Optional[tuple] = None):
    """Scope of a serving pass over ``mesh``: ``data_local`` when the
    pass's rows are this 'data' replica's slots (the unified step), not
    replicated ones (an admission's encoder pass, the draft model's
    rounds); ``whole_step``: then the whole step's (positions, lengths),
    one per slot of every replica (the scheduler is replicated, so every
    rank holds them), from which a kernel plans as one device would.
    Without a scope — everywhere outside a serving mesh — every helper
    below is the identity."""
    if mesh is None:
        yield
        return
    _ACTIVATION_CTX.append((mesh, data_local, whole_step))
    try:
        yield
    finally:
        _ACTIVATION_CTX.pop()


def current_mesh():
    return _ACTIVATION_CTX[-1][0] if _ACTIVATION_CTX else None


def _data_split() -> int:
    """dp when the scope's rows are data-local, else 1."""
    if not _ACTIVATION_CTX:
        return 1
    mesh, local, _ = _ACTIVATION_CTX[-1]
    return _axis_size(mesh, "data") if local else 1


def whole_step(rows: int):
    """(positions, lengths, first slot) of the whole step a data-local
    pass of ``rows`` slots is this replica's block of; None when the
    pass's rows are the whole step's."""
    if _data_split() == 1:
        return None
    mesh, _, step = _ACTIVATION_CTX[-1]
    if step is None:
        raise RuntimeError("a data-local pass needs the whole step's "
                           "positions and lengths (activation_mesh's "
                           "whole_step)")
    return step[0], step[1], mesh.coords["data"] * rows


def gather_model(y: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """All-gather a shard's output slices over 'model' along ``dim``."""
    mesh = current_mesh()
    if mesh is None or _axis_size(mesh, "model") == 1:
        return y
    return mesh.all_gather(y, "model", dim)


def constrain_replicated(x: torch.Tensor) -> torch.Tensor:
    """The MoE token path's replication pin: the step's (t, d) rows
    all-gathered over 'data' (replica order is slot order), so every
    replica routes — and fills expert capacity from — the whole step's
    tokens, as one device does."""
    if _data_split() == 1:
        return x
    return current_mesh().all_gather(x, "data", 0)


def data_rows(x: torch.Tensor) -> torch.Tensor:
    """This replica's rows of a ``constrain_replicated`` (t, ...)
    result."""
    if _data_split() == 1:
        return x
    return x[local_slice(x.shape[0], current_mesh(), "data")]


def plan_parts(col_sharded: bool = False) -> Tuple[int, int]:
    """(row parts, column parts) of a kernel call in the current scope:
    the call computes one of that many blocks of an unsharded call's
    rows (data-local activations) and columns (an out-feature shard)."""
    mesh = current_mesh()
    cols = _axis_size(mesh, "model") if (mesh is not None
                                         and col_sharded) else 1
    return _data_split(), cols
