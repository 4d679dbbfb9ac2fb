"""The training rules on a real mesh: the reduced qwen3 train step on a
2x2 ('data', 'model') mesh of 4 gloo ranks on the CPU, parameters and
AdamW moments placed per ``sharding.param_specs``, the batch per
``batch_spec`` and the residual per ``activation_sharding`` (sequence
parallelism), run under ``sharding.ShardedRun``, against the port's
unsharded step on the same weights and batch: the loss within
``LOSS_TOL`` and the gradient norm within ``GRAD_TOL`` of its norm, the
tolerances ``tests/test_torch_train.py`` holds the port to against JAX
(the mesh sums the same products in other orders and rounds bf16
activations at other points).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import mesh as meshes  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.trainer import make_train_step  # noqa: E402

LOSS_TOL = 1e-3
GRAD_TOL = 2e-2
TRAIN = TrainConfig(learning_rate=1e-3, total_steps=10, warmup_steps=2)


def _setup(seed=0):
    """(model, params, batch): reduced qwen3, weights from ``seed``, a
    4 x 16 batch from numpy."""
    cfg = get_config("qwen3-0.6b").reduced()
    model = build_model(cfg)
    gen = torch.Generator()
    gen.manual_seed(seed)
    params = model.init(gen)
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (4, 17)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
             "labels": torch.from_numpy(toks[:, 1:].copy())}
    return model, params, batch


def _mesh_step(ctx, seed):
    """One rank of the 2x2 mesh: the step on placed DTensors; returns
    (loss, grad norm) and whether the moments are placed as the
    parameters."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.parallel import sharding
    torch.set_num_threads(1)
    mesh = meshes.ProductionMesh(
        init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model")),
        ("data", "model"), (2, 2))
    model, params, batch = _setup(seed)
    dm = mesh.device_mesh
    params = opt.tree_map(lambda t, pl: distribute_tensor(t, dm, pl),
                          params, sharding.param_shardings(params, mesh))
    batch = {k: distribute_tensor(v, dm, pl) for (k, v), pl in zip(
        batch.items(), sharding.batch_shardings(batch, mesh).values())}
    step = make_train_step(model, TRAIN, act_sharding=sharding
                           .activation_sharding(mesh, True))
    with sharding.ShardedRun(), implicit_replication():
        state = opt.adamw_init(params)
        new, state, metrics = step(params, state, batch)
    placed = all(tuple(m.placements) == tuple(p.placements)
                 for m, p in zip(opt.tree_leaves(state["m"]),
                                 opt.tree_leaves(new)))
    return (float(metrics["loss"].full_tensor()),
            float(metrics["grad_norm"].full_tensor()), placed)


def test_mesh_train_step_matches_unsharded():
    model, params, batch = _setup()
    step = make_train_step(model, TRAIN)
    _, _, want = step(params, opt.adamw_init(params), batch)
    got = meshes.spawn(_mesh_step, 4, (0,), device_type="cpu", threads=1)
    loss, gn = float(want["loss"]), float(want["grad_norm"])
    for rl, rg, placed in got:
        assert abs(rl - loss) <= LOSS_TOL, (rl, loss)
        assert abs(rg - gn) <= GRAD_TOL * gn, (rg, gn)
        assert placed
    assert len({(rl, rg) for rl, rg, _ in got}) == 1   # every rank agrees
