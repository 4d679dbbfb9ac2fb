"""Serving-mesh sharding rules, ported from the serving half of
``repro.parallel.sharding`` (``serving_*``, ``slot_sharding``,
``activation_mesh``/``constrain_replicated``).

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
  of, so it plans its launch from the unsharded shape.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch

AXES = ("data", "model")

Spec = Tuple[Optional[str], ...]

_SERVING_REPLICATED_PARAM_KEYS = {"embed", "router"}
_GQA_CACHE_KEYS = {"k", "v"}                        # head axis shardable
_QUANT_SCALE_KEY = "s"                              # head axis is last


def _axis_size(mesh, name) -> int:
    return mesh.shape.get(name, 1)


def _fits(dim: int, mesh, axis) -> bool:
    return dim > 0 and dim % _axis_size(mesh, axis) == 0


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
# (mesh, data_local) frames: the mesh whose collectives the step uses,
# and whether its activation rows are this replica's slots only.
_ACTIVATION_CTX: List[Tuple[object, bool]] = []


@contextlib.contextmanager
def activation_mesh(mesh, data_local: bool = False):
    """Scope of a serving pass over ``mesh``: ``data_local`` when the
    pass's rows are this 'data' replica's slots (the unified step), not
    replicated ones (an admission's encoder pass, the draft model's
    rounds). Without a scope — everywhere outside a serving mesh —
    every helper below is the identity."""
    if mesh is None:
        yield
        return
    _ACTIVATION_CTX.append((mesh, data_local))
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
    mesh, local = _ACTIVATION_CTX[-1]
    return _axis_size(mesh, "data") if local else 1


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
