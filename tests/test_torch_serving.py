"""Port vs JAX package: the serving engine end to end (CPU, reduced widths).

Reduced qwen3-0.6b with q8_0 weights, and again with the q3_k_s recipe
(q3_k linears, q6_k embedding and lm_head: both K-quant paths and the
ledger's recipe bytes), a paged arena with an fp32 cache,
and a back-to-back stream from ``build_stream`` (the JAX launcher's and
the port's copy, which must produce the same requests) go through the
port's ``ServingEngine`` on the CPU and the JAX ``ServingEngine`` (its
default fused paged attention, Pallas in interpret mode). The arena is
small enough that block reservation preempts. Three things must hold:

1. Greedy tokens are identical, except a request's tail from the first
   position where the two disagree *and* the JAX run's top-2 logit gap
   there is below the logit tolerance (activations are bf16 in both
   packages, so a near-tie may flip; see tests/test_torch_model.py for the
   tolerance), onto a token the JAX run scored within the tolerance of its
   best. Such exemptions must be rare.
2. The allocator and block-table traces (before every step) are equal.
3. ``TransferLedger.breakdown()`` is equal as an exact dict.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.registry import ASSIGNED  # noqa: E402
from repro.core import convert as jconvert  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models.api import build_model as jbuild  # noqa: E402
from repro.runtime import sampling as jsampling  # noqa: E402
from repro.runtime.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.convert import params_from_jax  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.runtime.engine import ServingEngine  # noqa: E402

LOGIT_TOL = 2.5e-2           # of max |logit|, as in test_torch_model.py
ARGS = types.SimpleNamespace(prompt_len=16, gen=8, requests=6,
                             temperature=0.0, shared_prefix=0,
                             arrival="back2back", rate=8.0)
ENGINE = dict(num_slots=4, max_seq=ARGS.prompt_len + ARGS.gen,
              chunk_size=4, block_size=4, num_blocks=14)


def _trace(eng, log):
    """Record the arena's allocation state before every step — (tables,
    free blocks, per-slot blocks) on the paged arena, (free slots, the
    occupied slots' request ids) on the contiguous one; returns the
    wrapped step so callers can chain after it."""
    orig = eng._step_once

    def step(*a, **kw):
        arena = eng.arena
        if hasattr(arena, "tables"):
            log.append((arena.tables.copy(), arena.allocator.free_blocks,
                        tuple(tuple(arena.slot_blocks(s))
                              for s in range(eng.num_slots))))
        else:
            log.append((arena.free_slots, tuple(sorted(
                (s, q.rid) for s, q in eng.sched.active.items()))))
        return orig(*a, **kw)
    eng._step_once = step
    return step


def jax_logit_rows(jeng, run):
    """Call ``run()``, which steps the JAX ``ServingEngine`` ``jeng``,
    while recording the logit row each sampled token was drawn from.
    Returns (run's result, {(rid, token index): row}, max |logit|)."""
    rows, scale, jrow = [], [0.0], {}

    def spy(logits, key, temperature, active, **kw):
        def record(lg):
            lf = np.asarray(lg, np.float32)
            rows.append(lf)
            scale[0] = max(scale[0], float(np.abs(lf).max()))
        jax.debug.callback(record, logits)
        return orig_sample(logits, key, temperature, active, **kw)

    orig_sample = jsampling.sample_slots
    inner = jeng._step_once

    def step_with_gaps(*a, **kw):
        before = {s: (q, q.tokens_out) for s, q in jeng.sched.active.items()}
        inner(*a, **kw)
        jax.effects_barrier()
        for s, (q, n0) in before.items():
            if q.tokens_out > n0:
                jrow[(q.rid, n0)] = rows[-1][s]
    jeng._step_once = step_with_gaps
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsampling, "sample_slots", spy)
        out = run()
    return out, jrow, scale[0]


def serve_both(quant, engine=ENGINE, arch="qwen3-0.6b", args=ARGS, **kw):
    """The same stream (``build_stream`` of ``args``) through the JAX
    engine and the port's on the CPU, with the same weights (reduced
    ``arch``) and engine arguments (``kw`` to both). The engines come back
    too (``jeng``, ``teng``), still traced, for a second serve."""
    cfg = ASSIGNED[arch].reduced()
    jmodel = jbuild(cfg)
    jparams = jax.jit(lambda key: jconvert.quantize_params(
        jmodel.init(key), quant))(jax.random.PRNGKey(0))
    tcfg = get_config(arch).reduced()
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")

    jreqs = jserve.build_stream(cfg, args, np.random.RandomState(0))
    treqs = tserve.build_stream(tcfg, args, np.random.RandomState(0))

    jtrace, ttrace = [], []
    jeng = JaxEngine(jmodel, jparams, quant=quant, cache_dtype=jnp.float32,
                     **engine, **kw)
    _trace(jeng, jtrace)
    jrep, jrow, scale = jax_logit_rows(
        jeng, lambda: jeng.serve(jreqs, seed=0, realtime=False))

    teng = ServingEngine(build_model(tcfg), tparams, quant=quant,
                         cache_dtype=torch.float32, device="cpu", **engine,
                         **kw)
    _trace(teng, ttrace)
    trep = teng.serve(treqs, seed=0, realtime=False)
    return dict(jreqs=jreqs, treqs=treqs, jrep=jrep, trep=trep,
                jtrace=jtrace, ttrace=ttrace, jrow=jrow, scale=scale,
                gen=args.gen, jeng=jeng, teng=teng)


@pytest.fixture(scope="module", params=["q8_0", "q3_k_s"])
def runs(request):
    return serve_both(request.param)


def test_build_stream_is_the_jax_launchers(runs):
    assert len(runs["jreqs"]) == len(runs["treqs"]) == ARGS.requests
    for a, b in zip(runs["jreqs"], runs["treqs"]):
        assert a.rid == b.rid and a.max_new_tokens == b.max_new_tokens
        assert a.arrival_s == b.arrival_s
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_greedy_tokens_identical_up_to_near_ties(runs):
    check_tokens_up_to_near_ties(runs)


def check_tokens_up_to_near_ties(runs):
    """A request may diverge only where the JAX run's top-2 gap is below
    the logit tolerance, and only onto a token the JAX run also scored
    within the tolerance of its best. Exemptions must be rare: at most
    one request in four, or one in eight of the stream's near-tie
    positions (the chances to flip) where those are more."""
    jrep, trep = runs["jrep"], runs["trep"]
    n_req, gen = len(jrep.sequences), runs["gen"]
    assert [s.rid for s in jrep.sequences] == [s.rid for s in trep.sequences]
    assert len(runs["jrow"]) == n_req * gen        # rows recorded
    tol = LOGIT_TOL * runs["scale"]
    gaps = {key: float(np.diff(np.sort(row)[-2:])[0])
            for key, row in runs["jrow"].items()}
    near_ties = sum(g < tol for g in gaps.values())
    exempt = 0
    for a, b in zip(jrep.sequences, trep.sequences):
        assert len(a.generated) == len(b.generated) == gen
        diff = [k for k, (x, y) in enumerate(zip(a.generated, b.generated))
                if x != y]
        if not diff:
            continue
        k = diff[0]
        gap = gaps[(a.rid, k)]
        assert gap < tol, (f"request {a.rid} diverged at token {k} where the "
                           f"JAX top-2 gap {gap:.4g} >= tolerance {tol:.4g}: "
                           f"{a.generated} vs {b.generated}")
        row = runs["jrow"][(a.rid, k)]
        assert row[b.generated[k]] >= row.max() - tol, (
            f"request {a.rid} token {k}: the port chose {b.generated[k]}, "
            "which the JAX run scored below its best by more than the "
            "tolerance")
        exempt += 1
    assert exempt <= max(n_req // 4, near_ties // 8), (
        f"{exempt} near-tie exemptions ({near_ties} near-tie positions)")


def test_allocator_and_table_traces_equal(runs):
    assert runs["jrep"].sched.preemptions > 0      # the arena was tight
    check_traces_equal(runs)


def check_traces_equal(runs):
    jt, tt = runs["jtrace"], runs["ttrace"]
    assert runs["trep"].sched.preemptions == runs["jrep"].sched.preemptions
    assert len(jt) == len(tt) == runs["trep"].stats.steps
    for step, (ja, ta) in enumerate(zip(jt, tt)):
        if len(ja) == 3:                           # paged: tables first
            np.testing.assert_array_equal(ja[0], ta[0],
                                          err_msg=f"step {step}")
            ja, ta = ja[1:], ta[1:]
        assert ja == ta, f"step {step}"


def test_ledger_breakdown_exact(runs):
    check_ledger_exact(runs)


def check_ledger_exact(runs):
    jl, tl = runs["jrep"].ledger, runs["trep"].ledger
    assert tl.breakdown() == jl.breakdown()
    assert tl.tokens == jl.tokens
    assert runs["trep"].stats.decode_tokens == runs["jrep"].stats.decode_tokens
    assert runs["trep"].stats.prefill_tokens == \
        runs["jrep"].stats.prefill_tokens
    assert runs["trep"].stats.paged_kv_read_bytes == \
        runs["jrep"].stats.paged_kv_read_bytes
