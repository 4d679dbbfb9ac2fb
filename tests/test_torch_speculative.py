"""Port vs JAX package: speculative decoding (CPU, reduced widths).

* ``NGramProposer`` and ``SpecController`` give the JAX package's
  proposals and depths on seeded contexts and update sequences.
* ``verify_slots``: greedy ``(next, accept_len)`` exactly equal to the JAX
  head's on seeded logits (accepted and rejected proposals, the bonus row,
  prefill rows with no proposals, ties, inactive slots); stochastic slots
  keep the target law, held against the port's ``sample_slots`` by the
  JAX test's TVD bound (tests/test_speculative.py).
* Rollback: feeding a verify chunk and rolling part of it back leaves the
  arena bit-identical to never inserting the rejected positions, on the
  contiguous arena and on bf16, int8 and MLA paged arenas (null page
  excluded: garbage by contract), with the same tail trim; on seeded
  pages the port's arena equals the JAX arena after the same rollbacks,
  and shared and cached pages are never zeroed
  (tests/test_prefix_cache.py).
* Greedy ``--spec ngram`` serves of reduced qwen3-0.6b (contiguous and
  paged, the paged one small enough to preempt) and deepseek-v3 (paged,
  MLA), and a ``--spec draft`` serve (qwen3-1.7b drafted by qwen3-0.6b):
  tokens equal to the JAX spec serve's and to the port's non-spec
  serve's up to near-ties (tests/test_torch_serving.py); where the tokens
  equal the JAX run's, the spec counters, the allocator and table
  traces, the ledger breakdown and the draft ledger's equal JAX's
  exactly. The JAX engine attends with ``paged_attn="ref"`` except in one
  small fused case (interpret-mode Pallas is slow).
* A self-draft accepts every proposal; a cross-model draft keeps the
  chain; ``DraftModelProposer`` catch-up and sync give the JAX
  proposer's depth, tail, proposals and draft-ledger breakdown.
* Preemption resets speculation state; the engine's and the launcher's
  refusals give the JAX messages.
"""
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.registry import ARCHS  # noqa: E402
from repro.core import convert as jconvert  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models.api import build_model as jbuild  # noqa: E402
from repro.runtime import kvcache as jkv  # noqa: E402
from repro.runtime import sampling as jsampling  # noqa: E402
from repro.runtime import speculative as jspec  # noqa: E402
from repro.runtime.engine import ServingEngine as JaxEngine  # noqa: E402
from repro.runtime.request import Request as JaxRequest  # noqa: E402
from repro.runtime.request import SeqState as JaxSeqState  # noqa: E402
from repro.runtime.request import Sequence as JaxSequence  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.convert import params_from_jax  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.runtime import kvcache as tkv  # noqa: E402
from repro_torch.runtime import sampling as tsampling  # noqa: E402
from repro_torch.runtime import speculative as tspec  # noqa: E402
from repro_torch.runtime.engine import ServingEngine  # noqa: E402
from repro_torch.runtime.request import (Request, SeqState,  # noqa: E402
                                         Sequence)
from repro_torch.runtime.telemetry import ROW_COUNTERS  # noqa: E402
from repro_torch.runtime.telemetry import TIMING_COUNTERS  # noqa: E402
from test_torch_serving import (_trace,  # noqa: E402
                                check_tokens_up_to_near_ties,
                                check_traces_equal)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This file's many small eager ops run on one torch thread: beside
    the other test workers, a full-width CPU thread pool per process
    oversubscribes the cores and slows them a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------------
# Proposers and the depth controller (host-only)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ngram_proposals_equal_jax(seed):
    rng = np.random.RandomState(seed)
    for max_n, min_n in ((3, 1), (2, 2), (4, 1)):
        jp = jspec.NGramProposer(max_n=max_n, min_n=min_n)
        tp = tspec.NGramProposer(max_n=max_n, min_n=min_n)
        for _ in range(40):
            n = rng.randint(1, 30)
            ctx = rng.randint(0, rng.randint(2, 9), n).astype(np.int64)
            for k in range(6):
                a, b = jp._propose_one(ctx, k), tp._propose_one(ctx, k)
                assert a.dtype == b.dtype and a.tolist() == b.tolist()
    with pytest.raises(ValueError, match="n-gram range"):
        tspec.NGramProposer(max_n=1, min_n=2)


@pytest.mark.parametrize("adaptive", [True, False])
def test_spec_controller_equal_jax(adaptive):
    rng = np.random.RandomState(4)
    jc = jspec.SpecController(k_max=4, adaptive=adaptive)
    tc = tspec.SpecController(k_max=4, adaptive=adaptive)
    for _ in range(300):
        slot, op = rng.randint(0, 3), rng.randint(0, 5)
        if op == 0:
            jc.reset(slot)
            tc.reset(slot)
        elif op < 4:
            p = rng.randint(0, 5)
            a = rng.randint(0, p + 1)
            jc.update(slot, p, a)
            tc.update(slot, p, a)
        assert jc.depth(slot) == tc.depth(slot)
        assert jc.ema == tc.ema


# ----------------------------------------------------------------------
# The verification head
# ----------------------------------------------------------------------
def _verify_case(seed, b=6, c=5, v=40):
    """Seeded logits with ties, and proposals that follow the argmax
    chain for a random prefix then break it (or propose nothing)."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, c, v).astype(np.float32)
    arg = logits.argmax(-1)
    for i in range(b):                       # an exact tie in some rows
        j = rng.randint(0, c)
        logits[i, j, (arg[i, j] + 3) % v] = logits[i, j, arg[i, j]]
    arg = logits.argmax(-1)                  # numpy: first index on ties
    tokens = rng.randint(0, v, (b, c)).astype(np.int32)
    prop_lens = np.zeros((b,), np.int32)
    lengths = np.zeros((b,), np.int32)
    for i in range(b):
        if i % 3 == 2:                       # prefill / plain-decode row
            lengths[i] = rng.randint(1, c + 1)
            continue
        k = rng.randint(1, c)
        acc = rng.randint(0, k + 1)
        for j in range(acc):
            tokens[i, j + 1] = arg[i, j]
        if acc < k:
            tokens[i, acc + 1] = (arg[i, acc] + 1) % v
        prop_lens[i], lengths[i] = k, k + 1
    active = np.ones((b,), bool)
    active[rng.randint(0, b)] = False
    return logits, tokens, prop_lens, lengths, active


@pytest.mark.parametrize("seed", range(6))
def test_verify_slots_greedy_exact(seed):
    logits, tokens, prop_lens, lengths, active = _verify_case(seed)
    b = logits.shape[0]
    jn, ja = jsampling.verify_slots(
        jnp.asarray(logits), jnp.asarray(tokens), jax.random.PRNGKey(0),
        jnp.zeros((b,)), jnp.asarray(active),
        prop_lens=jnp.asarray(prop_lens), lengths=jnp.asarray(lengths))
    t = torch.from_numpy
    for dtype in (torch.float32, torch.bfloat16):
        lg = t(logits).to(dtype)
        if dtype is torch.bfloat16:          # JAX over the same bf16 values
            jn, ja = jsampling.verify_slots(
                jnp.asarray(lg.float().numpy()), jnp.asarray(tokens),
                jax.random.PRNGKey(0), jnp.zeros((b,)), jnp.asarray(active),
                prop_lens=jnp.asarray(prop_lens),
                lengths=jnp.asarray(lengths))
        for stochastic in (False, True):
            tn, ta = tsampling.verify_slots(
                lg, t(tokens), torch.Generator().manual_seed(0),
                torch.zeros(b), t(active), prop_lens=t(prop_lens),
                lengths=t(lengths), top_k=torch.zeros(b, dtype=torch.int32),
                top_p=torch.ones(b), stochastic=stochastic)
            assert tn.dtype == ta.dtype == torch.int32
            assert tn.tolist() == np.asarray(jn).tolist()
            assert ta.tolist() == np.asarray(ja).tolist()


def _first_token_law(row, proposal, temp, top_k, top_p, n, seed):
    """Empirical law of the first emitted token under verification: one
    logit row over n slots, ``proposal`` in every lane."""
    v = row.shape[-1]
    logits = torch.from_numpy(row).expand(n, 2, v)
    tokens = torch.zeros((n, 2), dtype=torch.int32)
    tokens[:, 1] = proposal
    nxt, acc = tsampling.verify_slots(
        logits, tokens, torch.Generator().manual_seed(seed),
        torch.full((n,), temp), torch.ones(n, dtype=torch.bool),
        prop_lens=torch.ones(n, dtype=torch.int32),
        lengths=torch.full((n,), 2, dtype=torch.int32),
        top_k=torch.full((n,), top_k, dtype=torch.int32),
        top_p=torch.full((n,), top_p))
    emitted = torch.where(acc == 1, torch.tensor(proposal, dtype=torch.int32),
                          nxt)
    return np.bincount(emitted.numpy(), minlength=v) / n


@pytest.mark.parametrize("seed,temp,top_k,top_p,proposal", [
    (0, 0.8, 0, 1.0, 3),      # plain softmax, likely token proposed
    (1, 0.8, 0, 1.0, 17),     # unlikely token proposed (mostly rejected)
    (2, 1.3, 8, 1.0, 5),      # top-k filtered
    (3, 0.6, 0, 0.8, 2),      # nucleus filtered
])
def test_verify_slots_stochastic_keeps_the_law(seed, temp, top_k, top_p,
                                              proposal):
    n, v = 4000, 24
    row = (np.random.RandomState(seed).randn(v) * 2.0).astype(np.float32)
    spec = _first_token_law(row, proposal, temp, top_k, top_p, n, seed + 7)
    plain = tsampling.sample_slots(
        torch.from_numpy(row).expand(n, v),
        torch.Generator().manual_seed(seed + 8), torch.full((n,), temp),
        torch.ones(n, dtype=torch.bool),
        top_k=torch.full((n,), top_k, dtype=torch.int32),
        top_p=torch.full((n,), top_p))
    plain = np.bincount(plain.numpy(), minlength=v) / n
    tvd = 0.5 * np.abs(spec - plain).sum()
    assert tvd < 0.075, f"TVD {tvd:.4f}"


# ----------------------------------------------------------------------
# Rollback
# ----------------------------------------------------------------------
def _tmodel(arch):
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(0))


def _feed(model, params, arena, tokens, pos0, lengths, paged):
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.int32)  # noqa
    tables = arena.device_tables()[0] if paged else None
    model.decode_step(params, t(tokens), t(pos0), arena.buffers,
                      block_tables=tables, lengths=t(lengths))


@pytest.mark.parametrize("arch,kv_quant", [
    ("qwen3-0.6b", None), ("qwen3-0.6b", "none"), ("qwen3-0.6b", "int8"),
    ("deepseek-v3-671b", "none")])
def test_rollback_bit_identical_to_never_inserting(arch, kv_quant):
    """A verify chunk of m positions after a committed prefix, r of them
    kept: rolling back m - r leaves every leaf (and, paged, the tables,
    the slot's blocks and the free list) as a feed of only r would."""
    cfg, model, params = _tmodel(arch)
    C, bs, prefix, m, r = 8, 2, 3, 6, 1
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size,
                                            (2, prefix + m))
    paged = kv_quant is not None

    def arena_after(n):
        if paged:
            arena = tkv.PagedKVArena(model, 2, 24, block_size=bs,
                                     num_blocks=16, kv_quant=kv_quant,
                                     device="cpu")
            for _ in range(2):
                arena.alloc_slot(arena.blocks_needed(prefix))
        else:
            arena = tkv.KVArena(model, 2, 24, device="cpu")
            arena.alloc(), arena.alloc()
        t = np.zeros((2, C), np.int32)
        t[:, :prefix] = toks[:, :prefix]
        _feed(model, params, arena, t, [0, 0], [prefix, prefix], paged)
        if paged:
            assert arena.ensure(0, prefix + n) is not None
        t = np.zeros((2, C), np.int32)
        t[0, :n] = toks[0, prefix:prefix + n]
        _feed(model, params, arena, t, [prefix, 0], [n, 0], paged)
        return arena

    a = arena_after(m)
    held = len(a.slot_blocks(0)) if paged else 0
    dropped = a.rollback(0, prefix + r, m - r, C)
    b = arena_after(r)
    if paged:
        assert dropped == held - len(b.slot_blocks(0)) > 0
        assert a.allocator.free_blocks == b.allocator.free_blocks
        np.testing.assert_array_equal(a.tables, b.tables)
        assert a.slot_blocks(0) == b.slot_blocks(0)
        assert a._dev_tables is None
    for la, lb in zip(tkv._leaves(a.buffers), tkv._leaves(b.buffers)):
        if paged:
            la, lb = la[:, :a.null_block], lb[:, :b.null_block]
        assert torch.equal(la, lb)
    assert a.rollback(0, 5, 0, C) in (None, 0)      # nothing to erase


def _seeded_arenas(arch, kv_quant, prefix_cache):
    """The JAX and the port paged arena over the same reduced model, with
    the same seeded contents in every page leaf."""
    kw = dict(num_slots=3, max_seq=24, block_size=4, num_blocks=12,
              prefix_cache=prefix_cache, kv_quant=kv_quant)
    jarena = jkv.PagedKVArena(jbuild(ARCHS[arch].reduced()),
                              dtype=jnp.bfloat16, **kw)
    tarena = tkv.PagedKVArena(build_model(get_config(arch).reduced()),
                              dtype=torch.bfloat16, device="cpu", **kw)
    jleaves, treedef = jax.tree.flatten(jarena.buffers)
    rng, new = np.random.RandomState(5), []
    for j, t in zip(jleaves, tkv._leaves(tarena.buffers)):
        assert tuple(j.shape) == tuple(t.shape)
        if t.dtype == torch.int8:
            x = rng.randint(-127, 128, t.shape).astype(np.int8)
            new.append(jnp.asarray(x))
            t.copy_(torch.from_numpy(x))
        else:
            x = rng.randn(*t.shape).astype(np.float32)
            new.append(jnp.asarray(x).astype(j.dtype))
            t.copy_(torch.from_numpy(x).to(t.dtype))
    jarena.buffers = treedef.unflatten(new)
    return jarena, tarena


def _pages(arena, null):
    """Every page leaf as f32 numpy, the null page dropped."""
    if isinstance(arena, tkv.PagedKVArena):
        return [x[:, :null].float().numpy()
                for x in tkv._leaves(arena.buffers)]
    return [np.asarray(x[:, :null].astype(jnp.float32))
            for x in jax.tree.leaves(arena.buffers)]


def _same(jarena, tarena):
    np.testing.assert_array_equal(jarena.tables, tarena.tables)
    assert jarena.allocator.refcounts == tarena.allocator.refcounts
    assert jarena.allocator.free_blocks == tarena.allocator.free_blocks
    for a, b in zip(_pages(jarena, jarena.null_block),
                    _pages(tarena, tarena.null_block)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch,kv_quant", [
    ("qwen3-0.6b", "none"), ("qwen3-0.6b", "int8"),
    ("deepseek-v3-671b", "none"), ("deepseek-v3-671b", "int8")])
def test_paged_rollback_equals_jax(arch, kv_quant):
    jarena, tarena = _seeded_arenas(arch, kv_quant, prefix_cache=False)
    before = _pages(tarena, tarena.null_block)
    for a in (jarena, tarena):
        assert a.alloc_slot(3) == 0 and a.alloc_slot(2) == 1
    # (slot, start, count): inside one block, across blocks with a tail
    # trim, from position 0 (everything dropped), nothing.
    for call in ((1, 6, 2), (0, 5, 6), (1, 0, 5), (0, 2, 0)):
        assert tarena.rollback(*call, 8) == jarena.rollback(*call, 8)
        _same(jarena, tarena)
    after = _pages(tarena, tarena.null_block)
    changed = [np.flatnonzero((a != b).reshape(a.shape[0], a.shape[1], -1)
                              .any(axis=(0, 2))) for a, b in zip(before,
                                                                 after)]
    assert all(set(c) <= {1, 2, 3, 4} for c in changed)   # zeroed blocks
    assert tarena.allocator.free_blocks == 10


@pytest.mark.parametrize("arch,kv_quant", [
    ("qwen3-0.6b", "none"), ("qwen3-0.6b", "int8"),
    ("deepseek-v3-671b", "none")])
def test_rollback_spares_shared_and_cached_pages(arch, kv_quant):
    """tests/test_prefix_cache.py's case on both arenas: slot B shares
    slot A's root block; rolling back B over it skips the shared page and
    zeroes (and reclaims) B's exclusive tail; rolling back A over its own
    cached block keeps the page (it is the chain's KV) and leaves it
    resurrection-ready."""
    jarena, tarena = _seeded_arenas(arch, kv_quant, prefix_cache=True)
    prompt = np.arange(8)
    for a in (jarena, tarena):
        slot_a, _, _ = a.alloc_slot_prefix(prompt, 16)
        a.register_prefix(slot_a, prompt)
        got = a.alloc_slot_prefix(prompt, 16)
        assert got[:2] == (1, 7) and a.cow_splits == 1
        a.ensure(1, 10)
    _same(jarena, tarena)
    blocks_a = tarena.slot_blocks(0)
    before = _pages(tarena, tarena.null_block)
    assert tarena.rollback(1, 4, 6, 8) == jarena.rollback(1, 4, 6, 8) == 2
    _same(jarena, tarena)
    assert [tarena.allocator.refcounts[b] for b in blocks_a] == [2, 1]
    assert tarena.rollback(0, 4, 4, 8) == jarena.rollback(0, 4, 4, 8) == 1
    _same(jarena, tarena)
    after = _pages(tarena, tarena.null_block)
    for x, y in zip(before, after):
        np.testing.assert_array_equal(x[:, blocks_a], y[:, blocks_a])
    assert tarena.allocator.refcounts[blocks_a[1]] == 0
    assert tarena.prefix_cache.is_cached(blocks_a[1])


def test_contiguous_rollback_equals_jax():
    jarena = jkv.KVArena(jbuild(ARCHS["qwen3-0.6b"].reduced()), 2, 12,
                         dtype=jnp.float32)
    tarena = tkv.KVArena(build_model(get_config("qwen3-0.6b").reduced()),
                         2, 12, dtype=torch.float32, device="cpu")
    jleaves, treedef = jax.tree.flatten(jarena.buffers)
    rng = np.random.RandomState(2)
    xs = [rng.randn(*j.shape).astype(np.float32) for j in jleaves]
    jarena.buffers = treedef.unflatten([jnp.asarray(x) for x in xs])
    for t, x in zip(tkv._leaves(tarena.buffers), xs):
        t.copy_(torch.from_numpy(x))
    for call in ((0, 3, 4), (1, 9, 5), (1, 0, 1), (0, 11, 8)):
        jarena.rollback(*call, 8)
        tarena.rollback(*call, 8)
    for j, t in zip(jax.tree.leaves(jarena.buffers),
                    tkv._leaves(tarena.buffers)):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


# ----------------------------------------------------------------------
# Serving: the JAX spec serve, the port's spec serve, the port's plain one
# ----------------------------------------------------------------------
ARGS = types.SimpleNamespace(prompt_len=16, gen=12, requests=6,
                             temperature=0.0, shared_prefix=0,
                             arrival="back2back", rate=8.0)
PAGED = dict(num_slots=4, max_seq=ARGS.prompt_len + ARGS.gen, chunk_size=4,
             block_size=4, num_blocks=14)
CONTIGUOUS = dict(num_slots=4, max_seq=ARGS.prompt_len + ARGS.gen,
                  chunk_size=4)


def logit_rows(mod, eng, run, on_jax=False):
    """Call ``run()``, which steps ``eng``, recording for every emitted
    token the logit row it was chosen from: row ``lengths - 1`` of a
    prefill chunk, and row t for the t-th token a decoding slot emits
    (the correction or bonus row after t accepted proposals). ``mod`` is
    the sampling module the engine calls (``verify_slots`` with
    speculation, ``sample_slots`` without). Returns (run's result,
    {(rid, token index): row}, max |logit|)."""
    verify = eng.spec != "off"
    name = "verify_slots" if verify else "sample_slots"
    orig, steps, rows, scale = getattr(mod, name), [], {}, [0.0]

    def record(lg):
        lf = np.asarray(lg, np.float32)
        steps.append(lf if verify else lf[:, None])
        scale[0] = max(scale[0], float(np.abs(lf).max()))

    def spy(logits, *a, **kw):
        if on_jax:
            jax.debug.callback(record, logits)
        else:
            record(logits.float().numpy())
        return orig(logits, *a, **kw)

    inner = eng._step_once

    def step(*a, **kw):
        before = {s: (q, q.tokens_out, q.fed, q.state is SeqState.PREFILL
                      or q.state is JaxSeqState.PREFILL)
                  for s, q in eng.sched.active.items()}
        inner(*a, **kw)
        if on_jax:
            jax.effects_barrier()
        for s, (q, n0, f0, prefill) in before.items():
            for t in range(q.tokens_out - n0):
                j = t if not prefill else q.fed - f0 - 1 if verify else 0
                rows[(q.rid, n0 + t)] = steps[-1][s, j]
    eng._step_once = step
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, name, spy)
        out = run()
    return out, rows, scale[0]


def _weights(arch, seed=0):
    jcfg, tcfg = ARCHS[arch].reduced(), get_config(arch).reduced()
    jmodel = jbuild(jcfg)
    jparams = jax.jit(lambda key: jconvert.quantize_params(
        jmodel.init(key), "q8_0"))(jax.random.PRNGKey(seed))
    return (jcfg, jmodel, jparams), (tcfg, build_model(tcfg), params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu"))


def serve_spec(arch, engine, jax_attn="ref", draft=None, **spec):
    """The serving test's stream (``build_stream`` of ARGS) through the
    JAX spec engine, the port's spec engine and the port's plain engine,
    each traced, with the same q8_0 weights and an fp32 cache; ``draft``:
    the draft arch (weights from seed 1)."""
    (jcfg, jmodel, jparams), (tcfg, tmodel, tparams) = _weights(arch)
    jkw, tkw = {}, {}
    if draft:
        (_, jd, jdp), (_, td, tdp) = _weights(draft, seed=1)
        jkw = dict(spec_draft_model=jd, spec_draft_params=jdp)
        tkw = dict(spec_draft_model=td, spec_draft_params=tdp)
    if "block_size" in engine:
        jkw["paged_attn"] = jax_attn
    mk = lambda m, c: m.build_stream(  # noqa: E731
        c, ARGS, np.random.RandomState(0))
    out = dict(gen=ARGS.gen, jtrace=[], ttrace=[], ptrace=[])
    out["jeng"] = JaxEngine(jmodel, jparams, quant="q8_0",
                            cache_dtype=jnp.float32, telemetry=True,
                            **engine, **spec, **jkw)
    _trace(out["jeng"], out["jtrace"])
    out["jrep"], out["jrow"], out["scale"] = logit_rows(
        jsampling, out["jeng"], lambda: out["jeng"].serve(
            mk(jserve, jcfg), seed=0, realtime=False), on_jax=True)
    out["teng"] = ServingEngine(tmodel, tparams, quant="q8_0",
                                cache_dtype=torch.float32, device="cpu",
                                telemetry=True, **engine, **spec, **tkw)
    _trace(out["teng"], out["ttrace"])
    out["trep"] = out["teng"].serve(mk(tserve, tcfg), seed=0,
                                    realtime=False)
    plain = ServingEngine(tmodel, tparams, quant="q8_0",
                          cache_dtype=torch.float32, device="cpu", **engine)
    out["prep"], out["prow"], out["pscale"] = logit_rows(
        tsampling, plain, lambda: plain.serve(mk(tserve, tcfg), seed=0,
                                              realtime=False))
    return out


def _check_spec_run(runs, paged):
    jrep, trep = runs["jrep"], runs["trep"]
    st = trep.stats
    assert st.spec_proposed > 0 and st.spec_rolled_back > 0
    assert trep.sched.completed == ARGS.requests
    # against the JAX spec serve, and against the port's plain serve
    check_tokens_up_to_near_ties(runs)
    check_tokens_up_to_near_ties(dict(jrep=runs["prep"], trep=trep,
                                      jrow=runs["prow"],
                                      scale=runs["pscale"], gen=ARGS.gen))
    if paged:                                # every block came back
        arena = runs["teng"].arena
        assert arena.allocator.free_blocks == arena.num_blocks
    if [s.generated for s in jrep.sequences] != \
            [s.generated for s in trep.sequences]:
        return False
    js = jrep.stats
    assert (st.spec_proposed, st.spec_accepted, st.spec_rolled_back,
            st.steps) == (js.spec_proposed, js.spec_accepted,
                          js.spec_rolled_back, js.steps)
    assert (trep.sched.spec_lanes_planned, trep.sched.spec_lanes_trimmed) \
        == (jrep.sched.spec_lanes_planned, jrep.sched.spec_lanes_trimmed)
    check_traces_equal(runs)
    assert trep.ledger.breakdown() == jrep.ledger.breakdown()
    assert trep.ledger.tokens == jrep.ledger.tokens
    assert (st.decode_tokens, st.prefill_tokens) == (js.decode_tokens,
                                                     js.prefill_tokens)
    # The KV read counter follows the attention path (the fused kernel's
    # live pages, or the ref gather's whole table): compared where the
    # two engines attend alike. The port's phase seconds
    # (TIMING_COUNTERS) are wall clock, never compared, and its row
    # counters (ROW_COUNTERS) the JAX engine does not keep.
    same_attn = runs["jeng"].paged_attn == runs["teng"].paged_attn
    assert same_attn <= (st.paged_kv_read_bytes == js.paged_kv_read_bytes)
    counters = lambda rep: [  # noqa: E731
        {k: v for k, v in e.counters.items()
         if (same_attn or k != "paged_kv_read_bytes")
         and k not in TIMING_COUNTERS + ROW_COUNTERS}
        for e in rep.timeline.events]
    assert counters(trep) == counters(jrep)
    assert [e.slots for e in trep.timeline.events] == \
        [e.slots for e in jrep.timeline.events]
    assert trep.timeline.ledger_delta_totals() == trep.ledger.breakdown()
    return True


@pytest.mark.parametrize("arch,engine,jax_attn", [
    ("qwen3-0.6b", CONTIGUOUS, None),
    ("qwen3-0.6b", PAGED, "fused"),
    ("deepseek-v3-671b", PAGED, "ref"),
])
def test_ngram_serve_equals_jax(arch, engine, jax_attn):
    runs = serve_spec(arch, engine, jax_attn=jax_attn, spec="ngram",
                      spec_k=4)
    assert _check_spec_run(runs, "block_size" in engine)
    st, pst = runs["trep"].stats, runs["prep"].stats
    assert st.spec_accepted > 0
    if "block_size" in engine:
        assert runs["trep"].sched.preemptions > 0    # the arena was tight
    else:       # no recompute: accepted lanes take whole steps off
        assert st.decode_tokens == pst.decode_tokens
        assert st.steps_per_token < pst.steps_per_token
    assert runs["trep"].timeline.meta["spec"] == "ngram"


def test_draft_serve_equals_jax():
    """qwen3-1.7b drafted by qwen3-0.6b (reduced, the launcher's draft
    example) on the paged arena: the target's and the draft's ledgers
    equal JAX's; the draft's rounds and passes are counted."""
    runs = serve_spec("qwen3-1.7b", PAGED, draft="qwen3-0.6b", spec="draft",
                      spec_k=3)
    assert _check_spec_run(runs, paged=True)
    jp, tp = runs["jeng"]._proposer, runs["teng"]._proposer
    assert tp.ledger.breakdown() == jp.ledger.breakdown()
    assert tp.steps == jp.steps > 0 and tp.passes > tp.steps
    st = runs["trep"].stats
    assert st.draft_transfers.bytes_per_token == \
        runs["jrep"].stats.draft_transfers.bytes_per_token
    tl = runs["trep"].timeline
    assert [e.draft_delta for e in tl.events] == \
        [e.draft_delta for e in runs["jrep"].timeline.events]
    tot = {}
    for e in tl.events:
        for k, v in e.draft_delta.items():
            tot[k] = tot.get(k, 0.0) + v
    assert tot == pytest.approx({(p, c, d): v for p, cats in
                                 tp.ledger.breakdown().items()
                                 for c, dirs in cats.items()
                                 for d, v in dirs.items()}, rel=1e-12)
    assert sum(e.counters["draft_steps"] for e in tl.events) == tp.steps


# ----------------------------------------------------------------------
# The draft-model proposer
# ----------------------------------------------------------------------
def test_self_draft_accepts_everything():
    cfg, model, params = _tmodel("qwen3-0.6b")
    mk = lambda: tserve.build_stream(  # noqa: E731
        cfg, ARGS, np.random.RandomState(3))
    kw = dict(CONTIGUOUS, device="cpu", cache_dtype=torch.float32)
    off = ServingEngine(model, params, **kw).serve(mk(), seed=0,
                                                   realtime=False)
    eng = ServingEngine(model, params, spec="draft", spec_k=3,
                        spec_draft_model=model, spec_draft_params=params,
                        **kw)
    rep = eng.serve(mk(), seed=0, realtime=False)
    assert rep.stats.spec_proposed > 0
    assert rep.stats.spec_accepted == rep.stats.spec_proposed
    assert rep.stats.steps_per_token < 0.5 * off.stats.steps_per_token
    assert [s.generated for s in rep.sequences] == \
        [s.generated for s in off.sequences]
    assert rep.stats.draft_transfers.weight_stream_bytes > 0


def test_cross_model_draft_keeps_the_chain():
    cfg, model, params = _tmodel("qwen3-0.6b")
    tmodel = build_model(get_config("qwen3-1.7b").reduced())
    tparams = tmodel.init(torch.Generator().manual_seed(1))
    mk = lambda: tserve.build_stream(  # noqa: E731
        cfg, ARGS, np.random.RandomState(4))
    kw = dict(PAGED, device="cpu", cache_dtype=torch.float32)
    off = ServingEngine(tmodel, tparams, **kw).serve(mk(), seed=0,
                                                     realtime=False)
    eng = ServingEngine(tmodel, tparams, spec="draft", spec_k=3,
                        spec_draft_model=model, spec_draft_params=params,
                        **kw)
    rep = eng.serve(mk(), seed=0, realtime=False)
    assert [s.generated for s in rep.sequences] == \
        [s.generated for s in off.sequences]
    assert rep.stats.spec_proposed > 0
    assert eng.arena.allocator.free_blocks == eng.arena.num_blocks


def test_draft_proposer_catchup_and_sync_equal_jax():
    """The same schedule through both proposers with the same weights: a
    prompt longer than a chunk (multi-round catch-up), an accepted
    proposal and a diverging token (tail rewind), two lanes of unequal
    depth (surplus rolls): depth, tail, proposals and draft ledger
    equal."""
    (_, jmodel, jparams), (_, tmodel, tparams) = _weights("qwen3-0.6b")
    jp = jspec.DraftModelProposer(jmodel, jparams, num_slots=2, max_seq=32,
                                  chunk=4, quant="q8_0",
                                  cache_dtype=jnp.float32)
    tp = tspec.DraftModelProposer(tmodel, tparams, num_slots=2, max_seq=32,
                                  chunk=4, quant="q8_0",
                                  cache_dtype=torch.float32, device="cpu")
    seqs = []
    for cls_r, cls_s in ((JaxRequest, JaxSequence), (Request, Sequence)):
        pair = {}
        for slot, n in ((0, 11), (1, 5)):
            q = cls_s(cls_r(rid=slot, tokens=np.arange(n) + 3 + slot,
                            max_new_tokens=8))
            q.admit(slot, 0.0)
            q.feed_chunk(n)
            q.start_decode()
            q.record_token(7, 0.0)
            pair[slot] = q
        seqs.append(pair)
    grants = [{0: 3, 1: 2}, {0: 2, 1: 3}, {0: 3}]
    for rnd, g in enumerate(grants):
        jout, tout = jp.propose(seqs[0], g), tp.propose(seqs[1], g)
        assert {s: v.tolist() for s, v in jout.items()} == \
            {s: v.tolist() for s, v in tout.items()}, rnd
        assert tp._depth == jp._depth and tp._tail == jp._tail
        for pair in seqs:                    # accept one, then diverge
            for s, props in jout.items():
                pair[s].record_token(int(props[0]), 0.0)
                pair[s].record_token((int(props[-1]) + 1) % 512, 0.0)
    # slot 0: 12 committed tokens caught up in 4 + 4 + 4, then one kept
    # proposal and one fresh token a round
    assert tp._depth[0] == 12 + 2 + 2
    assert tp.ledger.breakdown() == jp.ledger.breakdown()
    assert tp.steps == jp.steps == 5         # two extra catch-up rounds
    assert tp.passes == 2 + 3 + 3 + 3
    tp.reset_slot(0)
    assert tp._depth[0] == 0 and tp._tail[0] == []


# ----------------------------------------------------------------------
# Preemption and validations
# ----------------------------------------------------------------------
def test_preemption_resets_speculation_state():
    cfg, model, params = _tmodel("qwen3-0.6b")
    eng = ServingEngine(model, params, spec="draft", spec_k=3,
                        spec_draft_model=model, spec_draft_params=params,
                        device="cpu", **{**PAGED, "num_blocks": 10})
    seen = []
    inner = eng._preempt

    def preempt(seq):
        slot = seq.slot
        inner(seq)
        seen.append((slot in eng._spec_ctrl.ema,
                     eng._proposer._depth[slot], eng._proposer._tail[slot]))
    eng._preempt = preempt
    rep = eng.serve(tserve.build_stream(cfg, ARGS, np.random.RandomState(0)),
                    seed=0, realtime=False)
    assert rep.sched.preemptions > 0 and len(seen) == rep.sched.preemptions
    assert all(s == (False, 0, []) for s in seen)
    assert rep.sched.completed == ARGS.requests


def _error(fn):
    with pytest.raises((ValueError, NotImplementedError)) as e:
        fn()
    return str(e.value)


def test_engine_validations_give_the_jax_messages():
    import dataclasses
    jcfg = ARCHS["qwen3-0.6b"].reduced()
    jmodel, tmodel = jbuild(jcfg), build_model(
        get_config("qwen3-0.6b").reduced())
    other = dataclasses.replace(jcfg, vocab_size=jcfg.vocab_size + 256)
    jother = jbuild(other)
    tother = types.SimpleNamespace(cfg=other)
    hybrid = types.SimpleNamespace(cfg=dataclasses.replace(jcfg,
                                                           family="hybrid"))
    cases = [
        (jmodel, tmodel, dict(spec="turbo")),
        (jmodel, tmodel, dict(spec="ngram", chunk_size=1)),
        (jmodel, tmodel, dict(spec="ngram", spec_k=0)),
        (jmodel, tmodel, dict(spec="draft")),
        (hybrid, hybrid, dict(spec="ngram")),
    ]
    for jm, tm, kw in cases:
        assert _error(lambda: ServingEngine(tm, {}, device="cpu", **kw)) \
            == _error(lambda: JaxEngine(jm, {}, **kw)), kw
    jmsg = _error(lambda: JaxEngine(jmodel, {}, spec="draft",
                                    spec_draft_model=jother,
                                    spec_draft_params={}))
    assert _error(lambda: ServingEngine(
        tmodel, {}, device="cpu", spec="draft", spec_draft_model=tother,
        spec_draft_params={})) == jmsg
    # spec_k is capped at chunk - 1, as in the JAX engine
    eng = ServingEngine(tmodel, {}, device="cpu", spec="ngram", spec_k=9,
                        chunk_size=4)
    assert eng.spec_k == JaxEngine(jmodel, {}, spec="ngram", spec_k=9,
                                   chunk_size=4).spec_k == 3


@pytest.mark.parametrize("argv", [
    ["--spec-k", "4"],                               # spec-k without --spec
    ["--spec-draft-model", "qwen3-0.6b"],            # draft model w/o spec
    ["--spec", "draft"],                             # draft without model
    ["--spec", "ngram", "--spec-draft-model", "x"],  # ngram + draft model
    ["--spec", "ngram", "--chunk-size", "1"],        # no proposal lane
    ["--spec", "ngram", "--arch", "mamba2-1.3b"],    # recurrent family
    ["--spec", "ngram", "--mode", "batch"],          # lockstep has no spec
    ["--spec", "ngram", "--spec-k", "0"],            # degenerate depth
    ["--spec", "draft", "--spec-draft-model", "whisper-small"],
    ["--spec", "draft", "--spec-draft-model", "mamba2-1.3b"],
])
def test_serve_validations_give_the_jax_messages(argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["serve.py", "--reduced"] + argv)
    with pytest.raises(SystemExit) as e:
        jserve.main()
    assert e.value.code == 2
    jerr = capsys.readouterr().err.strip().splitlines()[-1]
    with pytest.raises(SystemExit) as e:
        tserve.main(["--reduced", "--device", "cpu"] + argv)
    assert e.value.code == 2
    terr = capsys.readouterr().err.strip().splitlines()[-1]
    assert terr == jerr and "error: " in terr


@pytest.mark.parametrize("capacity_factor,differ", [(4.0, False),
                                                    (1.25, True)])
def test_moe_capacity_couples_spec_tokens_to_the_step_mix(capacity_factor,
                                                          differ):
    """Speculation changes which rows share a step (verify lanes fill a
    chunk a plain decode leaves empty), and capacity dispatch makes an
    MoE token depend on the other rows of its step: in the JAX engine,
    reduced deepseek-v3's greedy spec serve equals its plain serve when
    no token is dropped (capacity factor 4) and parts from it at the
    full config's 1.25, where an expert takes only its first ``cap``
    assignments of the step."""
    import dataclasses
    assert ARCHS["deepseek-v3-671b"].moe.capacity_factor == 1.25
    cfg = ARCHS["deepseek-v3-671b"].reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))
    model = jbuild(cfg)
    params = model.init(jax.random.PRNGKey(0))
    out = []
    for spec in ("off", "ngram"):
        eng = JaxEngine(model, params, paged_attn="ref", spec=spec,
                        **{**PAGED, "num_blocks": 40})
        rep = eng.serve(jserve.build_stream(cfg, ARGS,
                                            np.random.RandomState(0)),
                        seed=0, realtime=False)
        out.append([s.generated for s in rep.sequences])
    assert rep.stats.spec_accepted > 0
    assert (out[0] != out[1]) == differ
