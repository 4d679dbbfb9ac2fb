"""Training step factory; ported from ``repro.train.trainer``.

``make_train_step`` builds the (params, opt_state, batch) -> (params,
opt_state, metrics) function the launcher and ``ElasticRunner`` call.
Supports gradient-accumulation microbatching (f32 accumulation, the
loss the mean of the microbatch losses), the remat policies of
``layers.remat``, and optional int8 gradient compression (each gradient
of two or more dimensions quantized and dequantized before the
optimizer: what a cross-replica reduction would move). The gradient is
``torch.autograd`` of ``model.loss`` (the JAX package's
``jax.value_and_grad``); on the card the attention's forward is the
flash kernel and its backward ``kernels.flash_attention``'s plain f32
backward; every linear of an unquantized model is a bf16 product, as in
JAX. On a training mesh (DTensor parameters placed per
``sharding.param_specs``, ``act_sharding`` the residual's placements,
the step run under ``sharding.ShardedRun``) each gradient is placed as
its parameter before AdamW, whose moments are placed the same way.

Only float parameters train: with quantized parameters (integer code
planes) the step raises ``TypeError`` naming those leaves before any
work, as ``jax.grad`` refuses integer inputs.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models.api import ModelAPI
from repro_torch.parallel import sharding
from repro_torch.train import optimizer as opt


def make_loss_fn(model: ModelAPI, quant: str, train_cfg: TrainConfig,
                 act_sharding=None) -> Callable:
    def loss_fn(params, batch):
        return model.loss(params, batch, quant=quant,
                          remat=train_cfg.remat_policy,
                          act_sharding=act_sharding)
    return loss_fn


def _value_and_grad(loss_fn: Callable, params, batch):
    """(loss, grads): the gradient of every float leaf, zeros for a leaf
    the loss does not reach (as ``jax.grad`` gives)."""
    flat = opt.flatten(params)
    ints = sorted(k for k, v in flat.items() if not v.is_floating_point())
    if ints:
        raise TypeError(
            "grad requires real-valued inputs, but the parameters hold "
            f"integer leaves {ints[:4]}{' ...' if len(ints) > 4 else ''}: "
            "train with quant='none', then quantize_params")
    leaves = opt.tree_map(lambda p: p.detach().requires_grad_(True), params)
    order = opt.tree_leaves(leaves)
    loss = loss_fn(leaves, batch)
    grads = torch.autograd.grad(loss, order, allow_unused=True)
    it = iter(_placed(g, p) if g is not None else torch.zeros_like(p)
              for g, p in zip(grads, order))
    return loss.detach(), opt.tree_map(lambda _: next(it), params)


def _placed(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor parameter's gradient placed as the parameter (its
    pending sums reduce-scattered onto the parameter's shards: FSDP's
    gradient reduction); any other gradient as it is."""
    if not sharding.is_dtensor(p) or tuple(g.placements) == \
            tuple(p.placements):
        return g
    return g.redistribute(p.device_mesh, p.placements)


def make_train_step(model: ModelAPI, train_cfg: TrainConfig,
                    quant: str = "none", act_sharding=None) -> Callable:
    loss_fn = make_loss_fn(model, quant, train_cfg, act_sharding)

    def train_step(params, opt_state, batch):
        nm = train_cfg.microbatches
        if nm > 1:
            # Gradient accumulation: the global batch split into nm
            # microbatches along dim 0, summed in f32.
            acc_loss, acc_g = None, None
            for i in range(nm):
                mb = {k: v.reshape(nm, v.shape[0] // nm, *v.shape[1:])[i]
                      for k, v in batch.items()}
                loss, g = _value_and_grad(loss_fn, params, mb)
                g = opt.tree_map(lambda x: x.to(torch.float32), g)
                if acc_g is None:
                    acc_loss, acc_g = loss.to(torch.float32), g
                else:
                    acc_loss = acc_loss + loss
                    acc_g = opt.tree_map(torch.add, acc_g, g)
            loss = acc_loss / nm
            grads = opt.tree_map(lambda g: g / nm, acc_g)
        else:
            loss, grads = _value_and_grad(loss_fn, params, batch)

        if train_cfg.grad_compression == "int8":
            def comp(g):
                if not g.is_floating_point() or g.ndim < 2:
                    return g
                q, scale = opt.compress_int8(g)
                return opt.decompress_int8(q, scale).to(g.dtype)
            grads = opt.tree_map(comp, grads)

        params, opt_state, metrics = opt.adamw_update(
            params, grads, opt_state, train_cfg)
        metrics = dict(metrics, loss=loss)
        return params, opt_state, metrics

    return train_step
