"""Port vs JAX package: the IMAX CGLA model and ``--offload-policy``.

``repro_torch.core.imax_model`` is a copy of ``repro.core.imax_model``
(plain Python, imports renamed), so its floats must be the JAX module's
exactly: ``IMAXSystem.e2e`` (latency, energy, PDP, EDP and the phase
breakdown) of the 28 nm ASIC at the lane counts and LMM sizes of
tests/test_sharding_offload.py and of the FPGA prototype, over every
config of the port's registry, the four recipes and two [in:out]
workloads. The launcher's ``offload_decisions`` table is equal too, and a
reduced ``--offload-policy`` serve charges the JAX engine's ledger
exactly (the table routes host-resident kernels' bytes off the DMA).
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.core import convert as jconvert  # noqa: E402
from repro.core import imax_model as jimax  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models.api import build_model as jbuild  # noqa: E402
from repro.runtime.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.core import imax_model as timax  # noqa: E402
from repro_torch.core.convert import params_from_jax  # noqa: E402
from repro_torch.core.quant.formats import RECIPES  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.runtime.engine import ServingEngine  # noqa: E402

WORKLOADS = [(32, 16), (128, 32)]
# (system factory name, kwargs): the ASIC at the lane counts and LMM sizes
# the JAX package's own IMAX tests sweep, and the FPGA prototype.
SYSTEMS = ([("asic_28nm", dict(lanes=n)) for n in (1, 2, 4, 8)]
           + [("asic_28nm", dict(lmm_kb=kb)) for kb in (16, 256, 512)]
           + [("fpga_prototype", {})])


def test_recipes_and_registry_cover_the_sweep():
    assert sorted(RECIPES) == ["fp16", "q3_k_s", "q6_k", "q8_0"]
    assert set(ARCHS) <= set(JARCHS)


@pytest.mark.parametrize("system,kw", SYSTEMS, ids=[
    "-".join([s] + [f"{k}{v}" for k, v in kw.items()]) for s, kw in SYSTEMS])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_e2e_and_breakdown_exact(arch, system, kw):
    """Every float of ``e2e`` (its ``breakdown`` included) is the JAX
    module's, for every recipe and workload."""
    tsys = getattr(timax, system)(**kw)
    jsys = getattr(jimax, system)(**kw)
    for quant in sorted(RECIPES):
        for n_in, n_out in WORKLOADS:
            got = tsys.e2e(ARCHS[arch], quant, n_in, n_out)
            want = jsys.e2e(JARCHS[arch], quant, n_in, n_out)
            assert got == want, (arch, system, kw, quant, n_in, n_out)
            assert tsys.phase_breakdown(ARCHS[arch], quant, n_in, n_out) \
                == want["breakdown"]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_offload_decisions_equal(arch):
    for quant in ("none", *sorted(RECIPES)):
        for n_in, n_out in WORKLOADS:
            assert tserve.offload_decisions(ARCHS[arch], quant, n_in, n_out) \
                == jserve.offload_decisions(JARCHS[arch], quant, n_in,
                                            n_out)


def test_offload_policy_serve_ledger_exact():
    """A reduced ``--offload-policy`` stream: each engine gets its own
    package's decision table, and the two ledgers are equal as exact
    dicts (and differ from the same stream's ledger without the table,
    so the table reached the ledger)."""
    args = types.SimpleNamespace(prompt_len=16, gen=6, requests=5,
                                 temperature=0.0, shared_prefix=0,
                                 arrival="back2back", rate=8.0)
    cfg = JARCHS["qwen3-0.6b"].reduced()
    tcfg = ARCHS["qwen3-0.6b"].reduced()
    jmodel = jbuild(cfg)
    jparams = jax.jit(lambda key: jconvert.quantize_params(
        jmodel.init(key), "q8_0"))(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    engine = dict(num_slots=3, max_seq=24, chunk_size=4, block_size=4,
                  num_blocks=18)
    jdec = jserve.offload_decisions(cfg, "q8_0", args.prompt_len, args.gen)
    tdec = tserve.offload_decisions(tcfg, "q8_0", args.prompt_len, args.gen)
    assert tdec == jdec and not all(tdec.values())
    jrep = JaxEngine(jmodel, jparams, quant="q8_0", cache_dtype=jnp.float32,
                     offload_decisions=jdec, **engine).serve(
        jserve.build_stream(cfg, args, np.random.RandomState(0)), seed=0,
        realtime=False)
    tmodel = build_model(tcfg)
    trep, plain = (ServingEngine(
        tmodel, tparams, quant="q8_0", cache_dtype=torch.float32,
        device="cpu", offload_decisions=dec, **engine).serve(
        tserve.build_stream(tcfg, args, np.random.RandomState(0)), seed=0,
        realtime=False) for dec in (tdec, None))
    assert trep.ledger.breakdown() == jrep.ledger.breakdown()
    assert trep.ledger.tokens == jrep.ledger.tokens
    assert trep.ledger.breakdown() != plain.ledger.breakdown()
