"""Port vs JAX package: the prefix cache with copy-on-write (``kvcache``).

* ``BlockAllocator``: refcount, share, resurrection and reissue traces on
  seeded random operation sequences equal the JAX allocator's, return
  for return (the ``on_alloc`` eviction hook included).
* ``PrefixCache``: chain keys, lookup, registration and eviction equal.
* ``PagedKVArena.alloc_slot_prefix``/``register_prefix``/
  ``prepare_write``: the same returns, tables, refcounts and
  ``cow_splits`` as the JAX arena, and after every split the same page
  contents on every leaf — the copy equals its source and the sibling's
  pages stay bit-identical — on bf16 pages, int8 code + scale pages and
  MLA's latent and RoPE pages.
* A reduced ``--shared-prefix`` stream with the cache (qwen3 and
  deepseek-v3 reduced, MLA), small enough to preempt, through both
  engines: tokens up to near-ties (tests/test_torch_serving.py), the
  allocator and table traces, the ledger breakdown, and the prefix
  counters (hits, hit tokens, CoW splits) per run and per telemetry step,
  equal; a second ``serve()`` on the same engines hits the warm cache
  equally. The port's shared serve equals its unshared serve exactly.
* The schedule of ``chip_smoke.py``'s prefix phase: in
  ``test_torch_prefix_cache_stream.py`` (a file of its own, so that its
  long deepseek-v3 case runs on another test worker).
* Capacity dispatch makes an MoE model's tokens depend on the other rows
  of their step, so sharing, which changes which rows share a step, can
  change them beyond rounding: dropless (the reduced config) it does
  not, at deepseek-v3's own capacity factor it does, on the CPU.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.registry import ASSIGNED  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models.api import build_model as jbuild  # noqa: E402
from repro.runtime import kvcache as jkv  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.runtime import kvcache as tkv  # noqa: E402
from repro_torch.runtime.engine import ServingEngine  # noqa: E402
from repro_torch.runtime.telemetry import ROW_COUNTERS  # noqa: E402
from repro_torch.runtime.telemetry import TIMING_COUNTERS  # noqa: E402
from test_torch_serving import (ARGS, _trace,  # noqa: E402
                                check_ledger_exact,
                                check_tokens_up_to_near_ties,
                                check_traces_equal, serve_both)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: beside other test workers an intra-op pool a
    process slows the eager serves many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------------
# BlockAllocator and PrefixCache
# ----------------------------------------------------------------------
def _alloc_state(a, hooked):
    return (list(a.refcounts), a.free_blocks, a.used_blocks, a.reissues,
            list(hooked))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_allocator_traces_equal(seed):
    """Seeded random alloc/share/free sequences (shares of live blocks
    and resurrections of freed ones, decrefs of held references, failed
    allocations and the hook's reissue calls) give the JAX allocator's
    returns and state after every operation."""
    rng = np.random.RandomState(seed)
    n = 12
    ta, ja = tkv.BlockAllocator(n, 4), jkv.BlockAllocator(n, 4)
    th, jh = [], []
    ta.on_alloc, ja.on_alloc = th.append, jh.append
    held = []                        # one entry per reference taken
    for _ in range(300):
        op = rng.randint(3)
        if op == 0:
            k = int(rng.randint(0, 5))
            got = ta.alloc(k)
            assert got == ja.alloc(k)
            held += got or []
        elif op == 1:
            pool = sorted(set(held)) + [b for b in range(n)
                                        if ta.refcounts[b] == 0]
            if pool:
                pick = [int(b) for b in rng.choice(
                    pool, size=min(len(pool), int(rng.randint(1, 4))),
                    replace=False)]
                ta.share(pick)
                ja.share(pick)
                held += pick
        elif held:
            idx = sorted(set(int(i) for i in rng.randint(
                0, len(held), int(rng.randint(1, 4)))), reverse=True)
            drop = [held.pop(i) for i in idx]
            ta.free(drop)
            ja.free(drop)
        assert _alloc_state(ta, th) == _alloc_state(ja, jh)
    assert ta.reissues > 0 and th
    for bad in ([n], [-1]):
        for a in (ta, ja):
            with pytest.raises(ValueError):
                a.share(bad)


def test_prefix_cache_keys_and_lookup_equal():
    rng = np.random.RandomState(5)
    tc, jc = tkv.PrefixCache(4), jkv.PrefixCache(4)
    prompts = [rng.randint(0, 1000, int(rng.randint(4, 30)))
               for _ in range(8)]
    prompts.append(np.concatenate([prompts[0][:8], [1, 2, 3, 4, 5]]))
    block = 0
    for p in prompts:
        nfull = len(p) // 4
        keys = tc.keys_for(p, nfull)
        assert keys == jc.keys_for(p, nfull)
        assert tc.lookup(keys) == jc.lookup(keys)
        for k in keys:
            assert tc.register(k, block) == jc.register(k, block)
            block = (block + 3) % 20
    for b in range(0, 20, 3):
        tc.invalidate_block(b)
        jc.invalidate_block(b)
        assert tc.is_cached(b) == jc.is_cached(b)
    for p in prompts:
        keys = tc.keys_for(p, len(p) // 4)
        assert tc.lookup(keys) == jc.lookup(keys)
    assert (len(tc), tc.evictions) == (len(jc), jc.evictions)
    assert tc.lookup(tc.keys_for(prompts[-1], 3))[:2] == \
        tc.lookup(tc.keys_for(prompts[0], 2))      # a shared chain


# ----------------------------------------------------------------------
# Arena copy-on-write
# ----------------------------------------------------------------------
def _arenas(arch, kv_quant):
    """The JAX and the port arena over the same reduced model, prefix
    cache on, with the same seeded contents in every page leaf."""
    jarena = jkv.PagedKVArena(jbuild(ASSIGNED[arch].reduced()), num_slots=4,
                              max_seq=24, block_size=4, num_blocks=10,
                              dtype=jnp.bfloat16, prefix_cache=True,
                              kv_quant=kv_quant)
    tarena = tkv.PagedKVArena(build_model(get_config(arch).reduced()),
                              num_slots=4, max_seq=24, block_size=4,
                              num_blocks=10, dtype=torch.bfloat16,
                              prefix_cache=True, kv_quant=kv_quant,
                              device="cpu")
    jleaves, treedef = jax.tree.flatten(jarena.buffers)
    tleaves = tkv._leaves(tarena.buffers)
    assert [tuple(x.shape) for x in jleaves] == \
        [tuple(t.shape) for t in tleaves]
    rng = np.random.RandomState(9)
    new = []
    for j, t in zip(jleaves, tleaves):
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


def _pages(jarena, tarena):
    """Every page leaf of both arenas as f32 numpy (codes exactly)."""
    j = [np.asarray(x.astype(jnp.float32))
         for x in jax.tree.leaves(jarena.buffers)]
    t = [x.float().numpy() for x in tkv._leaves(tarena.buffers)]
    return j, t


def _same_state(jarena, tarena):
    np.testing.assert_array_equal(jarena.tables, tarena.tables)
    assert jarena.cow_splits == tarena.cow_splits
    assert jarena.allocator.refcounts == tarena.allocator.refcounts
    assert [jarena.slot_blocks(s) for s in range(4)] == \
        [tarena.slot_blocks(s) for s in range(4)]
    for a, b in zip(*_pages(jarena, tarena)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch,kv_quant", [
    ("qwen3-0.6b", "none"), ("qwen3-0.6b", "int8"),
    ("deepseek-v3-671b", "none"), ("deepseek-v3-671b", "int8")])
def test_arena_prefix_and_cow_equal_jax(arch, kv_quant):
    jarena, tarena = _arenas(arch, kv_quant)
    _, before = _pages(jarena, tarena)
    prompt = np.arange(100, 110)             # 2 full blocks + 2 tokens
    calls = [("alloc_slot_prefix", (prompt, 16)),
             ("register_prefix", (0, prompt)),
             # the whole 8-token prompt is cached: the last chain block is
             # split at admission (position 7 is re-fed)
             ("alloc_slot_prefix", (prompt[:8], 16)),
             ("alloc_slot_prefix", (np.concatenate([prompt, [7, 8]]), 4)),
             ("prepare_write", (2, 8, 4)),   # own block: nothing to split
             ("prepare_write", (2, 2, 5))]   # both shared blocks split
    for name, a in calls:
        jw = (a + (3,)) if name == "prepare_write" else a  # JAX pad width
        got = getattr(tarena, name)(*a)
        assert got == getattr(jarena, name)(*jw), name
        _same_state(jarena, tarena)
    assert tarena.cow_splits == 3
    assert tarena.allocator.refcounts[tarena.slot_blocks(0)[0]] == 2
    # the sibling's pages (slot 0) never changed; each copy equals its
    # source page
    _, after = _pages(jarena, tarena)
    src, cpy = tarena.slot_blocks(0), tarena.slot_blocks(2)
    for b0, b1 in zip(before, after):
        np.testing.assert_array_equal(b1[:, src], b0[:, src])
        np.testing.assert_array_equal(b1[:, cpy[:2]], b0[:, src[:2]])
        np.testing.assert_array_equal(b1[:, tarena.slot_blocks(1)[1]],
                                      b0[:, src[1]])
    assert tarena._dev_tables is None        # the next step re-uploads
    for s in (0, 1, 2):
        tarena.free_slot(s)
        jarena.free_slot(s)
    _same_state(jarena, tarena)
    assert tarena.allocator.free_blocks == 10


# ----------------------------------------------------------------------
# Serving with the cache
# ----------------------------------------------------------------------
# The serving test's stream behind an 8-token system prompt, 8 requests.
PREFIX_ARGS = type(ARGS)(**{**vars(ARGS), "shared_prefix": 8,
                            "requests": 8})
PREFIX_ENGINE = dict(num_slots=4, max_seq=8 + ARGS.prompt_len + ARGS.gen,
                     chunk_size=4, block_size=4, num_blocks=14)


@pytest.fixture(scope="module", params=["qwen3-0.6b", "deepseek-v3-671b"])
def runs(request):
    """A shared-prefix stream through both engines with the cache and
    telemetry on, then the same stream again on the same engines (warm
    cache)."""
    out = serve_both("q8_0", engine=PREFIX_ENGINE, arch=request.param,
                     args=PREFIX_ARGS, prefix_cache=True, telemetry=True)
    out["arch"] = request.param
    # The engines keep their step wrappers: detach the cold run's logit
    # rows and traces from what the warm run appends.
    for k in ("jrow", "jtrace", "ttrace"):
        out[k] = type(out[k])(out[k])
    out["jwarm"] = out["jeng"].serve(jserve.build_stream(
        ASSIGNED[request.param].reduced(), PREFIX_ARGS,
        np.random.RandomState(0)), seed=0, realtime=False)
    out["twarm"] = out["teng"].serve(out["treqs"], seed=0, realtime=False)
    return out


def test_shared_serve_tokens_up_to_near_ties(runs):
    assert runs["trep"].stats.prefix_hits > 0
    check_tokens_up_to_near_ties(runs)


def test_shared_serve_traces_and_ledger_equal(runs):
    assert runs["jrep"].sched.preemptions > 0      # the arena was tight
    check_traces_equal(runs)
    check_ledger_exact(runs)


def test_prefix_counters_equal(runs):
    for j, t in ((runs["jrep"], runs["trep"]),
                 (runs["jwarm"], runs["twarm"])):
        assert (t.stats.prefix_hits, t.stats.prefix_hit_tokens,
                t.stats.cow_splits) == (j.stats.prefix_hits,
                                        j.stats.prefix_hit_tokens,
                                        j.stats.cow_splits)
        assert t.ledger.prefix_hit_tokens == t.stats.prefix_hit_tokens
        # The port's phase seconds (TIMING_COUNTERS) are wall clock; its
        # row counters (ROW_COUNTERS) the JAX engine does not keep.
        assert [{k: v for k, v in e.counters.items()
                 if k not in TIMING_COUNTERS + ROW_COUNTERS}
                for e in t.timeline.events] == \
            [e.counters for e in j.timeline.events]
        assert t.timeline.ledger_delta_totals() == t.ledger.breakdown()
    assert runs["twarm"].stats.cow_splits > 0


def test_warm_serve_hits_the_cache(runs):
    """The second ``serve()`` on the same engine maps pages the first
    published: more hits, the same tokens as the cold run, and the JAX
    engine's ledger."""
    cold, warm = runs["trep"], runs["twarm"]
    assert warm.stats.prefix_hits > cold.stats.prefix_hits
    assert [s.generated for s in warm.sequences] == \
        [s.generated for s in cold.sequences]
    assert warm.ledger.breakdown() == runs["jwarm"].ledger.breakdown()
    arena = runs["teng"].arena
    assert arena.allocator.free_blocks == arena.num_blocks
    assert len(arena.prefix_cache) > 0


def test_shared_serve_equals_unshared(runs):
    """Sharing changes which physical pages hold a position, never its
    values: the port's stream without the cache gives the same tokens."""
    tcfg = get_config(runs["arch"]).reduced()
    plain = ServingEngine(build_model(tcfg), runs["teng"].params,
                          quant="q8_0", cache_dtype=torch.float32,
                          device="cpu", **PREFIX_ENGINE)
    trace = []
    _trace(plain, trace)
    rep = plain.serve(tserve.build_stream(tcfg, PREFIX_ARGS,
                                          np.random.RandomState(0)),
                      seed=0, realtime=False)
    assert rep.stats.prefix_hits == 0
    assert [s.generated for s in rep.sequences] == \
        [s.generated for s in runs["trep"].sequences]
    assert rep.stats.prefill_tokens > runs["trep"].stats.prefill_tokens


@pytest.mark.parametrize("capacity_factor,differ", [(4.0, False),
                                                    (1.25, True)])
def test_moe_capacity_couples_tokens_to_the_step_mix(capacity_factor,
                                                     differ):
    """Reduced deepseek-v3 with the shared-prefix stream: the warm cache
    run against the run without the cache, on the CPU (where nothing else
    differs). At capacity factor 4 no token is dropped and the tokens are
    equal; at the full config's 1.25 an expert takes only its first
    ``cap`` assignments of the step, so a request's tokens follow the
    step's other rows."""
    cfg = get_config("deepseek-v3-671b").reduced()
    assert get_config("deepseek-v3-671b").moe.capacity_factor == 1.25
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    out = []
    for cache in (False, True):
        eng = ServingEngine(model, params, quant="none",
                            cache_dtype=torch.float32, device="cpu",
                            prefix_cache=cache, **{**PREFIX_ENGINE,
                                                   "num_blocks": 40})
        for _ in range(1 + cache):                   # warm the cache
            rep = eng.serve(tserve.build_stream(
                cfg, PREFIX_ARGS, np.random.RandomState(0)), seed=0,
                realtime=False)
        out.append([s.generated for s in rep.sequences])
    assert rep.stats.prefix_hits == PREFIX_ARGS.requests
    assert (out[0] != out[1]) == differ
