"""Multi-pod dry-run: every (architecture x input-shape) cell on the
production meshes, without a device.

The port of ``repro.launch.dryrun``. The JAX package lowers and compiles
each cell against the 16x16 single-pod and 2x16x16 multi-pod meshes of
forced host devices, on ``ShapeDtypeStruct`` stand-ins, and reads the
roofline terms from the executable. Here the mesh is a
``torch.distributed`` ``DeviceMesh`` over a fake process group of 256
or 512 ranks (``launch.mesh.make_production_mesh``), every parameter,
optimizer moment, batch and cache is a DTensor whose local shard is a
``FakeTensorMode`` tensor (no storage: nothing is allocated on any
device), and the step runs once, eagerly, while
``analysis.roofline.DeviceCounter`` counts rank 0's local work and
collectives. The train step is forward, backward and AdamW
(``train.trainer.make_train_step``) with parameters and moments placed
per ``sharding.param_specs``, the batch per ``batch_spec`` and the
residual per ``activation_sharding``; prefill and decode as the JAX
dry-run's. The step runs the plain PyTorch path, as the JAX dry-run
lowers ``impl="ref"``: a fake tensor has no pointer for a kernel to
read. This is not a fallback of the serving path, which launches the
kernels or raises.

An op DTensor cannot shard runs on inputs made whole over as few mesh
axes as it takes (``sharding.ShardedRun``): the all-gathers are counted
and the op's name is printed with the cell.

Results are JSON cells under ``--out-dir`` with the JAX cell's keys.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
      --shape decode_32k [--multi-pod] [--quant q8_0] [--out-dir out/dryrun_torch]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import pathlib
import time
import traceback
from typing import Dict

import torch

from repro_torch.analysis import extrapolate, roofline
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import ASSIGNED, get_config
from repro_torch.configs.shapes import SHAPES, shape_applicable
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.api import build_model
from repro_torch.parallel import sharding
from repro_torch.train.optimizer import adamw_init, tree_map
from repro_torch.train.trainer import make_train_step

@dataclasses.dataclass
class Lowered:
    """One counted step: ``counts`` (``DeviceCounter.measure()``), its
    per-device argument, output and temporary bytes, the ops that ran on
    whole inputs (with counts) and the collectives' bytes by mesh
    axis."""
    counts: Dict
    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    replicated_ops: Dict[str, int]
    by_axis: Dict[str, Dict[str, int]]


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves as leaves
    n = 0
    for t in leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            n += t.numel() * t.element_size()
    return n


def _distribute(tree, placements, mesh):
    """Meta leaves -> DTensors on ``mesh`` whose local shards are fake
    tensors of the shard's shape (call under ``FakeTensorMode``)."""
    from torch.distributed.tensor import DTensor, Shard
    dm = mesh.device_mesh

    def leaf(t, pl):
        shape = list(t.shape)
        for i, p in enumerate(pl):
            if isinstance(p, Shard):
                shape[p.dim] //= dm.size(i)
        local = torch.empty(shape, dtype=t.dtype)
        return DTensor.from_local(local, dm, pl, run_check=False,
                                  shape=t.shape,
                                  stride=torch.empty(t.shape,
                                                     device="meta").stride())
    return tree_map(leaf, tree, placements)


def lower_cell(cfg, shape, mesh, *, quant="none", seq_parallel=True,
               remat="full", microbatches=1, mixed=False) -> Lowered:
    """Run one (cfg x shape) cell's step on ``mesh`` under fake tensors
    and count it. Shared by the full-config count and the extrapolation
    variants."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models import flags as mflags
    model = build_model(cfg)
    params_abs = model.abstract_params(quant=quant)
    p_pl = sharding.param_shardings(params_abs, mesh)
    specs = model.input_specs(shape)
    mixed_ctx = mflags.use_mixed_intermediates(True) if mixed \
        else contextlib.nullcontext()
    fake = FakeTensorMode()
    with fake, implicit_replication(), mixed_ctx:
        params = _distribute(params_abs, p_pl, mesh)
        counter = roofline.DeviceCounter()
        if shape.kind == "train":
            tc = TrainConfig(remat_policy=remat, microbatches=microbatches)
            act = sharding.activation_sharding(mesh, seq_parallel)
            step = make_train_step(model, tc, quant=quant, act_sharding=act)
            opt = adamw_init(params)
            batch = _distribute(specs["batch"],
                                sharding.batch_shardings(specs["batch"],
                                                         mesh), mesh)
            args = (params, opt, batch)
            with counter:
                out = step(params, opt, batch)
        elif shape.kind == "prefill":
            act = sharding.activation_sharding(mesh, seq_parallel)
            batch = _distribute(specs["batch"],
                                sharding.batch_shardings(specs["batch"],
                                                         mesh), mesh)
            args = (params, batch)
            with counter, torch.no_grad():
                out = model.prefill(params, batch, quant=quant,
                                    act_sharding=act)
        else:
            cache = _distribute(specs["cache"],
                                sharding.cache_shardings(specs["cache"],
                                                         mesh), mesh)
            token = _distribute(
                specs["token"],
                sharding.placements(sharding.batch_spec(
                    tuple(specs["token"].shape), mesh), mesh), mesh)
            position = _distribute(specs["position"],
                                   sharding.replicated(mesh), mesh)
            args = (params, token, position, cache)
            with counter, torch.no_grad():
                out = model.decode_step(params, token, position, cache,
                                        quant=quant)
        arg_bytes = _local_bytes(args)
        out_bytes = _local_bytes(out)
    return Lowered(counts=counter.measure(), argument_bytes=arg_bytes,
                   output_bytes=out_bytes, temp_bytes=counter.peak,
                   replicated_ops=dict(counter.replicated_ops),
                   by_axis=_by_axis(counter.by_group, mesh))


def _by_axis(by_group, mesh) -> Dict[str, Dict[str, int]]:
    """{mesh axis: {collective kind: bytes}} of a count's collectives (a
    collective over several mesh dims at once is keyed by their names
    joined with '+')."""
    dm = mesh.device_mesh
    names = {dm.get_group(i).group_name: n
             for i, n in enumerate(mesh.axis_names)}
    out: Dict[str, Dict[str, int]] = {}
    for (kind, group), n in by_group.items():
        axis = names.get(group, group)
        out.setdefault(axis, {})
        out[axis][kind] = out[axis].get(kind, 0) + n
    return out


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             quant: str = "none", seq_parallel: bool = True,
             remat: str = "full", microbatches: int = 1, mixed: bool = False,
             verbose: bool = True, extrapolate_costs: bool = True) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    cell = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "quant": quant, "seq_parallel": seq_parallel, "remat": remat,
        "mixed": mixed,
    }
    if not shape_applicable(cfg.subquadratic, shape):
        cell["skipped"] = ("long_500k requires sub-quadratic token mixing; "
                           f"{arch} is full-attention (see DESIGN.md)")
        return cell

    opts = dict(quant=quant, seq_parallel=seq_parallel, remat=remat,
                microbatches=microbatches, mixed=mixed)
    with make_production_mesh(multi_pod=multi_pod) as mesh:
        n_dev = mesh.devices
        # 1. The full config's count: the sharding proof and the
        # per-device memory terms.
        t0 = time.time()
        lowered = lower_cell(cfg, shape, mesh, **opts)
        t_compile = time.time() - t0
        mf = roofline.model_flops_for(cfg, shape)
        rf = roofline.analyze(lowered, n_dev, model_flops=mf)
        cell["raw"] = rf.to_dict()

        # 2. The per-group L/L+1 differencing (equal to the full count
        # here: an eager count sees every layer).
        if extrapolate_costs:
            t1 = time.time()
            corr = extrapolate.extrapolate(
                cfg, lambda c: lower_cell(c, shape, mesh, **opts))
            rf = roofline.Roofline(
                flops_per_device=corr["flops"],
                bytes_per_device=corr["bytes"],
                collective_bytes_per_device=corr["collective_bytes"],
                collectives=corr["collectives"],
                n_devices=n_dev,
                model_flops=mf,
                argument_bytes=rf.argument_bytes,
                output_bytes=rf.output_bytes,
                temp_bytes=rf.temp_bytes,
            )
            cell["extrapolate_s"] = round(time.time() - t1, 2)
        dims = tuple(mesh.shape.values())
    cell.update(rf.to_dict())
    cell["compile_s"] = round(t_compile, 2)
    counts = cfg.param_counts()
    cell["params_total"] = counts["total"]
    cell["params_active"] = counts["active"]
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} mesh={dims} "
              f"quant={quant}: compute={rf.compute_s*1e3:.2f}ms "
              f"memory={rf.memory_s*1e3:.2f}ms "
              f"collective={rf.collective_s*1e3:.2f}ms "
              f"bottleneck={rf.bottleneck} mfu={rf.mfu:.3f} "
              f"(count {t_compile:.1f}s)", flush=True)
        print(f"  memory: argument {rf.argument_bytes} B, output "
              f"{rf.output_bytes} B, temp {rf.temp_bytes} B a device; "
              f"collectives by axis {lowered.by_axis}; ops on whole "
              f"inputs {lowered.replicated_ops}", flush=True)
    return cell


def cell_filename(arch, shape, multi_pod, quant, **kw) -> str:
    mesh = "2x16x16" if multi_pod else "16x16"
    extra = "".join(f"_{k}-{v}" for k, v in sorted(kw.items()) if v)
    return f"{arch}_{shape}_{mesh}_{quant}{extra}.json"


def main(argv=None) -> None:
    # A fake tensor that DTensor cannot shard for an op logs the failed
    # attempt before ``DeviceCounter`` runs the op on whole inputs.
    logging.getLogger("torch._subclasses.fake_tensor").setLevel(
        logging.CRITICAL)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--quant", default="none",
                    choices=["none", "fp16", "q8_0", "q6_k", "q3_k_s"])
    ap.add_argument("--no-seq-parallel", action="store_true")
    ap.add_argument("--remat", default="full",
                    choices=["none", "full", "dots_saveable"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mixed", action="store_true",
                    help="bf16 attention/SSD intermediates (perf lever)")
    ap.add_argument("--no-extrapolate", action="store_true",
                    help="raw costs only (multi-pod compile-proof cells)")
    ap.add_argument("--all", action="store_true",
                    help="run every (assigned arch x shape) on this mesh")
    ap.add_argument("--out-dir", default="out/dryrun_torch")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    outdir = pathlib.Path(args.out_dir)
    outdir.mkdir(parents=True, exist_ok=True)

    cells = []
    if args.all:
        for arch in ASSIGNED:
            for shape in SHAPES:
                cells.append((arch, shape))
    elif args.arch and not args.shape:
        for shape in SHAPES:
            cells.append((args.arch, shape))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        cells.append((args.arch, args.shape))

    failures = 0
    for arch, shape in cells:
        fname = cell_filename(arch, shape, args.multi_pod, args.quant,
                              tag=args.tag, sp=("0" if args.no_seq_parallel
                                                else ""),
                              remat=(args.remat if args.remat != "full"
                                     else ""),
                              mixed=("1" if args.mixed else ""),
                              mb=(args.microbatches
                                  if args.microbatches > 1 else ""))
        fpath = outdir / fname
        if fpath.exists():
            print(f"[dryrun] cached: {fname}")
            continue
        try:
            cell = run_cell(arch, shape, multi_pod=args.multi_pod,
                            quant=args.quant,
                            seq_parallel=not args.no_seq_parallel,
                            remat=args.remat, mixed=args.mixed,
                            microbatches=args.microbatches,
                            extrapolate_costs=not args.no_extrapolate)
        except Exception as e:
            traceback.print_exc()
            cell = {"arch": arch, "shape": shape,
                    "multi_pod": args.multi_pod, "quant": args.quant,
                    "error": f"{type(e).__name__}: {e}"}
            failures += 1
        fpath.write_text(json.dumps(cell, indent=2))
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
