"""Port vs JAX package: the encoder-decoder family (whisper-small) at
reduced widths (2 encoder layers over 64 frames, 4 decoder layers) on
the CPU.

The same numpy-seeded inputs (random frames, not zeros) and the same
q8_0 weights (carried across by ``params_from_jax``) go through the JAX
package's ``repro.models.encdec`` and the port's
``repro_torch.models.encdec``; the serving engines (JAX's with
``paged_attn="ref"``, the port's fused path, which on the CPU is its
kernel's plain version) serve the same stream with the same random
frames.

Tolerances, with their reasons:

* ``layernorm_apply`` and the tanh GELU in f32: within 4 f32 ulps of
  the value (the same formula; XLA and torch sum the statistics and
  evaluate tanh in another order). Rounded to bf16 as the model does,
  the layernorm is bit-equal but for values a rounding boundary apart,
  which move by one bf16 ulp.
* The sinusoid table and the decode step's rows: f32 2e-5 (the same
  products; the angle's division and the sin/cos come from another
  library).
* Whole passes (``encode``, ``encdec_encode_cross``, ``encdec_prefill``,
  ``encdec_forward`` and a paged decode step): activations are bf16 in
  both packages, so outputs agree within ``LOGIT_TOL`` = 2.5e-2 of
  their max |value| (``test_torch_model.py``). The JAX side is compiled
  with XLA's excess precision off (``EXACT_ROUNDING``,
  ``test_torch_ssm.py``), so it rounds where the model says.
* Serving: greedy tokens equal up to near-ties
  (``test_torch_serving.py``'s rule); allocator traces, the ledger (the
  frames' h2d charge and the cross K/V's cache growth included) and the
  counters exactly equal; the arenas' leaf dtypes and byte accounting
  and ``write_prefill``'s pages equal JAX's exactly.
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
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.api import build_model as jbuild  # noqa: E402
from repro.runtime import kvcache as jkv  # noqa: E402
from repro.runtime.engine import Engine as JaxBatchEngine  # noqa: E402
from repro.runtime.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.convert import params_from_jax  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import encdec as tencdec  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.runtime import kvcache as tkv  # noqa: E402
from repro_torch.runtime.engine import Engine  # noqa: E402
from repro_torch.runtime.engine import ServingEngine  # noqa: E402
from repro_torch.runtime.telemetry import TIMING_COUNTERS  # noqa: E402
from test_torch_serving import (ARGS, ENGINE, LOGIT_TOL,  # noqa: E402
                                _trace, check_tokens_up_to_near_ties,
                                check_traces_equal, jax_logit_rows)
from test_torch_ssm import EXACT_ROUNDING, _n, _t  # noqa: E402

ARCH = "whisper-small"
F32_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread (see test_torch_speculative.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def exact_jit(fn, **kw):
    """``jax.jit`` with XLA's excess precision off."""
    return jax.jit(fn, compiler_options=EXACT_ROUNDING, **kw)


def weights(arch, quant="q8_0"):
    """(JAX cfg, model, params; port cfg, model, params): the reduced
    ``arch``'s JAX weights from PRNGKey(0), quantized, and the same
    weights in the port's layout."""
    jcfg, tcfg = ASSIGNED[arch].reduced(), get_config(arch).reduced()
    jmodel = jbuild(jcfg)
    jparams = jax.jit(lambda key: jconvert.quantize_params(
        jmodel.init(key), quant))(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jmodel, jparams, tcfg, build_model(tcfg), tparams


@pytest.fixture(scope="module")
def models():
    return weights(ARCH)


def assert_close_rel(a, r, what, tol=LOGIT_TOL):
    """max |a - r| within ``tol`` of max |r| (both finite)."""
    a, r = np.asarray(a, np.float32), np.asarray(r, np.float32)
    assert a.shape == r.shape, (what, a.shape, r.shape)
    assert np.isfinite(a).all(), what
    err, scale = float(np.abs(a - r).max()), float(np.abs(r).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


def frames_for(cfg, b, seed=3):
    """Random frames (b, S_enc, d) in bf16: (JAX array, the same torch
    tensor)."""
    a = np.random.RandomState(seed).randn(
        b, cfg.encoder_seq_len, cfg.d_model).astype(np.float32)
    return jnp.asarray(a).astype(jnp.bfloat16), \
        torch.from_numpy(a).to(torch.bfloat16)


def extras_makers(jcfg, tcfg, seed=7):
    """Drop-in ``make_extras`` for the JAX launcher and the port's: each
    call draws the next request's random frontend input (frames or
    vision embeddings) from its own RandomState(seed), so the n-th
    request of both streams gets the same values, in bf16."""
    def draw(rng, cfg):
        if cfg.family == "encdec":
            shape, key = (1, cfg.encoder_seq_len, cfg.d_model), "frames"
        else:
            shape, key = (1, cfg.vision_tokens, cfg.d_model), "vision_embeds"
        return key, rng.randn(*shape).astype(np.float32)
    jr, tr = np.random.RandomState(seed), np.random.RandomState(seed)

    def jmake(cfg, batch):
        key, a = draw(jr, cfg)
        return {key: jnp.asarray(a).astype(jnp.bfloat16)}

    def tmake(cfg, batch, device="cpu"):
        key, a = draw(tr, cfg)
        return {key: torch.from_numpy(a).to(device, torch.bfloat16)}
    return jmake, tmake


# ----------------------------------------------------------------------
# Module level
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype):
    r = np.random.RandomState(0)
    x = (r.randn(3, 5, 96) * 2 + 0.5).astype(np.float32)
    p = {"g": (1 + r.randn(96) * 0.1).astype(np.float32),
         "b": (r.randn(96) * 0.1).astype(np.float32)}
    jx = jnp.asarray(x).astype(dtype)
    j = np.asarray(jlayers.layernorm_apply(jax.tree.map(jnp.asarray, p), jx)
                   .astype(jnp.float32))
    t = _n(tlayers.layernorm_apply({k: torch.from_numpy(v)
                                    for k, v in p.items()},
                                   _t(np.asarray(jx))))
    if dtype == "float32":
        np.testing.assert_allclose(t, j, rtol=4 * 2.0 ** -23, atol=1e-6)
    else:                               # one bf16 ulp at a rounding tie
        np.testing.assert_allclose(t, j, rtol=2.0 ** -7, atol=0)
        assert np.mean(t == j) > 0.99


def test_gelu_tanh_matches_jax():
    """``jax.nn.gelu`` defaults to the tanh approximation; the port's
    MLP calls ``F.gelu(approximate="tanh")`` in f32, not the erf form."""
    x = np.linspace(-6, 6, 4001, dtype=np.float32)
    j = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    t = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh")
    np.testing.assert_allclose(_n(t), j, rtol=4 * 2.0 ** -23, atol=1e-6)
    erf = _n(torch.nn.functional.gelu(torch.from_numpy(x)))
    assert np.abs(erf - j).max() > 1e-4          # the two forms differ


def test_mlp_matches_jax(models):
    """The fc1 -> tanh GELU -> fc2 MLP with its biases: q8_0 in bf16
    within LOGIT_TOL, and in f32 (unquantized, random biases) at f32
    2e-5, tight enough that the erf GELU would fail it."""
    jcfg, _, jparams, _, _, tparams = models
    r = np.random.RandomState(1)
    x = r.randn(2, 7, jcfg.d_model).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jp = jax.tree.map(lambda a: a[0], jparams["dec_layers"]["mlp"])
    j = exact_jit(lambda p, x: jencdec._mlp_apply(p, x, "q8_0", "ref",
                                                   True))(jp, jx)
    t = tencdec._mlp_apply(tparams["dec_layers"][0]["mlp"],
                           _t(np.asarray(jx)), "q8_0")
    assert t.dtype == torch.bfloat16
    assert_close_rel(_n(t), np.asarray(j.astype(jnp.float32)), "mlp")
    d, f = jcfg.d_model, jcfg.d_ff
    p32 = {"fc1": {"w": r.randn(f, d).astype(np.float32) * d ** -0.5,
                   "b": r.randn(f).astype(np.float32) * 0.1},
           "fc2": {"w": r.randn(d, f).astype(np.float32) * f ** -0.5,
                   "b": r.randn(d).astype(np.float32) * 0.1}}
    j = jencdec._mlp_apply(jax.tree.map(jnp.asarray, p32), jnp.asarray(x),
                           "none", "ref", True)
    t = tencdec._mlp_apply(jax.tree.map(torch.from_numpy, p32),
                           torch.from_numpy(x), "none")
    np.testing.assert_allclose(_n(t), np.asarray(j), **F32_TOL)


def test_sinusoid_positions_match_jax(models):
    """The encoder's table and the decode step's rows (positions of a
    chunk, and one past ``max_seq_len``, which the JAX gather clamps)."""
    jcfg = models[0]
    d = jcfg.d_model
    np.testing.assert_allclose(
        _n(tencdec.sinusoid_positions(jcfg.encoder_seq_len, d)),
        np.asarray(jencdec.sinusoid_positions(jcfg.encoder_seq_len, d)),
        **F32_TOL)
    table = np.asarray(jencdec.sinusoid_positions(jcfg.max_seq_len, d))
    pos = np.array([[0, 1, 2, 3], [21, 22, 23, 24],
                    [jcfg.max_seq_len - 2, jcfg.max_seq_len - 1,
                     jcfg.max_seq_len, jcfg.max_seq_len + 5]])
    rows = tencdec.sinusoid_rows(torch.clamp(torch.from_numpy(pos),
                                             max=jcfg.max_seq_len - 1), d)
    np.testing.assert_allclose(
        _n(rows), table[np.minimum(pos, jcfg.max_seq_len - 1)], **F32_TOL)


def test_encode_matches_jax(models):
    jcfg, _, jparams, tcfg, _, tparams = models
    jf, tf = frames_for(jcfg, 2)
    j = exact_jit(lambda p, f: jencdec.encode(p, jcfg, f, quant="q8_0"))(
        jparams, jf)
    t = tencdec.encode(tparams, tcfg, tf, quant="q8_0")
    assert t.dtype == torch.bfloat16
    assert_close_rel(_n(t), np.asarray(j.astype(jnp.float32)), "encode")


def test_encode_cross_matches_jax(models):
    """The admission pass: every decoder layer's cross K/V from one
    encoder pass, and seq-1 zero stubs for the self K/V."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = models
    jf, tf = frames_for(jcfg, 1, seed=4)
    j = exact_jit(lambda p, f: jmodel.encode_cross(p, f, quant="q8_0"))(
        jparams, jf)
    t = tmodel.encode_cross(tparams, tf, quant="q8_0")
    jd, td = j["dec_layers"], t["dec_layers"]
    for leaf in ("k", "v"):
        assert_close_rel(_n(td["cross"][leaf]),
                         np.asarray(jd["cross"][leaf].astype(jnp.float32)),
                         f"cross {leaf}")
        assert td["cross"][leaf].dtype == torch.bfloat16
        assert tuple(td["self"][leaf].shape) == jd["self"][leaf].shape
        assert not bool(td["self"][leaf].any())


@pytest.mark.parametrize("entry", ["forward", "prefill"])
def test_full_sequence_matches_jax(models, entry):
    """Logits of both entry points; the prefill's caches (self K/V of the
    decoder tokens, cross K/V of the frames) in the JAX layout."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = models
    jf, tf = frames_for(jcfg, 2, seed=5)
    tok = np.random.RandomState(6).randint(0, jcfg.vocab_size, (2, 11)) \
        .astype(np.int32)
    fn = getattr(jmodel, entry)
    jl, jc = exact_jit(lambda p, b: fn(p, b, quant="q8_0"))(
        jparams, {"tokens": jnp.asarray(tok), "frames": jf})
    tl, tc = getattr(tmodel, entry)(
        tparams, {"tokens": torch.from_numpy(tok), "frames": tf},
        quant="q8_0")
    assert_close_rel(_n(tl), np.asarray(jl.astype(jnp.float32)), entry)
    if entry == "forward":
        assert float(tc) == 0.0
        return
    for part in ("self", "cross"):
        for leaf in ("k", "v"):
            j = np.asarray(jc["dec_layers"][part][leaf].astype(jnp.float32))
            assert_close_rel(_n(tc["dec_layers"][part][leaf]), j,
                             f"{part} {leaf}")


def test_paged_decode_step_matches_jax(models):
    """A chunked decode step on pages (lengths 4 / 2, bases 0 / 5) over
    cross K/V written by the admission pass: the port's fused path
    against the JAX gather oracle."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = models
    jf, tf = frames_for(jcfg, 1, seed=8)
    jcross = exact_jit(lambda p, f: jmodel.encode_cross(p, f, quant="q8_0"))(
        jparams, jf)
    ja = jkv.PagedKVArena(jmodel, 2, 16, block_size=4, dtype=jnp.float32)
    ta = tkv.PagedKVArena(tmodel, 2, 16, block_size=4, dtype=torch.float32,
                          device="cpu")
    for arena in (ja, ta):
        for _ in range(2):
            arena.alloc_slot(arena.blocks_needed(12))
    tcross = jax.tree.map(lambda a: _t(np.asarray(a)), jcross)
    for s in range(2):
        ja.write_prefill(jcross, s)
        ta.write_prefill(tcross, s)
    r = np.random.RandomState(9)
    tok = r.randint(0, jcfg.vocab_size, (2, 4)).astype(np.int32)
    pos, lens = np.array([0, 5], np.int32), np.array([4, 2], np.int32)
    jl, _ = exact_jit(lambda p, c: jmodel.decode_step(
        p, jnp.asarray(tok), jnp.asarray(pos), c, quant="q8_0",
        block_tables=jnp.asarray(ja.tables), lengths=jnp.asarray(lens),
        paged_impl="ref"))(jparams, ja.buffers)
    tl, _ = tmodel.decode_step(
        tparams, torch.from_numpy(tok), torch.from_numpy(pos), ta.buffers,
        quant="q8_0", block_tables=ta.device_tables()[0],
        lengths=torch.from_numpy(lens))
    for b, n in enumerate(lens):
        assert_close_rel(_n(tl[b, :n]), np.asarray(jl[b, :n], np.float32),
                         f"row {b}")


# ----------------------------------------------------------------------
# Arenas
# ----------------------------------------------------------------------
def _leaf_dtypes(arena):
    return tuple(str(t.dtype).split(".")[-1]
                 for t in tkv._leaves(arena.buffers))


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_arena_leaf_dtypes_and_bytes_match_jax(models, dtype, paged):
    """The cross K/V is a per-slot state leaf in the arena's dtype beside
    the self K/V (pages or slot stripes); shapes, dtypes and byte
    accounting equal JAX's."""
    _, jmodel, _, _, tmodel, _ = models
    if paged:
        ja = jkv.PagedKVArena(jmodel, 3, 16, block_size=4,
                              dtype=jnp.dtype(dtype))
        ta = tkv.PagedKVArena(tmodel, 3, 16, block_size=4,
                              dtype=getattr(torch, dtype), device="cpu")
    else:
        ja = jkv.KVArena(jmodel, 3, 16, dtype=jnp.dtype(dtype))
        ta = tkv.KVArena(tmodel, 3, 16, dtype=getattr(torch, dtype),
                         device="cpu")
    assert _leaf_dtypes(ta) == tuple(
        x.dtype.name for x in jax.tree.leaves(ja.buffers))
    assert tuple(tuple(t.shape) for t in tkv._leaves(ta.buffers)) == \
        tuple(x.shape for x in jax.tree.leaves(ja.buffers))
    assert tkv._leaves(tmodel.state_leaves(3)) == [True, True, False, False]
    for who in (ja, ta):
        if paged:
            assert who.alloc_slot(who.blocks_needed(6)) == 0
        else:
            assert who.alloc() == 0
    attrs = ["nbytes", "token_bytes", "resident_bytes"] + (
        ["block_bytes", "const_bytes"] if paged else ["slot_bytes"])
    for attr in attrs:
        assert getattr(ta, attr)() == getattr(ja, attr)(), attr


@pytest.mark.parametrize("paged", [True, False])
def test_write_prefill_matches_jax(models, paged):
    """The same admission cache written into slot 1 of both arenas (the
    slot's one reserved block on the paged arena): every leaf equal bit
    for bit, the other slot's state and the other pages untouched."""
    jcfg, jmodel, _, _, tmodel, _ = models
    r = np.random.RandomState(10)
    cache = jax.tree.map(
        lambda s: r.randn(*s).astype(np.float32),
        jmodel.cache_shapes(1, 1), is_leaf=lambda x: isinstance(x, tuple))
    if paged:
        ja = jkv.PagedKVArena(jmodel, 2, 16, block_size=4,
                              dtype=jnp.float32)
        ta = tkv.PagedKVArena(tmodel, 2, 16, block_size=4,
                              dtype=torch.float32, device="cpu")
        for who in (ja, ta):
            who.alloc_slot(who.blocks_needed(4))
            who.alloc_slot(who.blocks_needed(4))
    else:
        ja = jkv.KVArena(jmodel, 2, 16, dtype=jnp.float32)
        ta = tkv.KVArena(tmodel, 2, 16, dtype=torch.float32, device="cpu")
        for who in (ja, ta):
            who.alloc(), who.alloc()
    ja.write_prefill(jax.tree.map(jnp.asarray, cache), 1)
    ta.write_prefill(jax.tree.map(torch.from_numpy, cache), 1)
    for j, t in zip(jax.tree.leaves(ja.buffers), tkv._leaves(ta.buffers)):
        np.testing.assert_array_equal(_n(t), np.asarray(j))
    cross = ta.buffers["dec_layers"]["cross"]["k"]
    assert bool(cross[:, 1].any()) and not bool(cross[:, 0].any())


# ----------------------------------------------------------------------
# Serving
# ----------------------------------------------------------------------
def serve_pair(arch, engine=ENGINE, args=ARGS):
    """The launchers' stream (``build_stream`` of ``args``) with random
    frontend inputs (``extras_makers``) through the JAX engine
    (``paged_attn="ref"``, excess precision off) and the port's, both
    traced, with the same q8_0 weights and an f32 cache."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = weights(arch)
    jmake, tmake = extras_makers(jcfg, tcfg)
    jit = jax.jit
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jserve, "make_extras", jmake)
        mp.setattr(tserve, "make_extras", tmake)
        jreqs = jserve.build_stream(jcfg, args, np.random.RandomState(0))
        treqs = tserve.build_stream(tcfg, args, np.random.RandomState(0))
        mp.setattr(jax, "jit", lambda *a, **kw: jit(
            *a, **kw, compiler_options=EXACT_ROUNDING))
        jeng = JaxEngine(jmodel, jparams, quant="q8_0",
                         cache_dtype=jnp.float32, paged_attn="ref",
                         telemetry=True, **engine)
        jtrace, ttrace = [], []
        _trace(jeng, jtrace)
        jrep, jrow, scale = jax_logit_rows(
            jeng, lambda: jeng.serve(jreqs, seed=0, realtime=False))
    teng = ServingEngine(tmodel, tparams, quant="q8_0",
                         cache_dtype=torch.float32, device="cpu",
                         telemetry=True, **engine)
    _trace(teng, ttrace)
    trep = teng.serve(treqs, seed=0, realtime=False)
    return dict(jrep=jrep, trep=trep, jtrace=jtrace, ttrace=ttrace,
                jrow=jrow, scale=scale, gen=args.gen, jreqs=jreqs,
                treqs=treqs)


def check_serve_exact(runs):
    """Traces, ledger, counters and the per-step timeline equal JAX's."""
    jrep, trep = runs["jrep"], runs["trep"]
    assert trep.sched.completed == len(runs["treqs"])
    check_traces_equal(runs)
    assert trep.ledger.breakdown() == jrep.ledger.breakdown()
    assert trep.ledger.tokens == jrep.ledger.tokens
    ts, js = trep.stats, jrep.stats
    for f in ("steps", "decode_tokens", "prefill_tokens", "cache_bytes",
              "peak_resident_bytes", "resident_bytes_sum",
              "live_tokens_sum"):
        assert getattr(ts, f) == getattr(js, f), f
    for f in ("admitted", "completed", "preemptions", "slot_reuses",
              "occupancy_sum", "max_occupancy", "steps", "prefill_chunks",
              "deferred_feeds"):
        assert getattr(trep.sched, f) == getattr(jrep.sched, f), f
    # The KV read counter follows the attention path (the port's fused
    # walk, the JAX gather): the other counters are compared, but the
    # port's phase seconds (TIMING_COUNTERS, wall clock).
    counters = lambda rep: [  # noqa: E731
        {k: v for k, v in e.counters.items()
         if k != "paged_kv_read_bytes" and k not in TIMING_COUNTERS}
        for e in rep.timeline.events]
    assert counters(trep) == counters(jrep)
    assert [e.slots for e in trep.timeline.events] == \
        [e.slots for e in jrep.timeline.events]


@pytest.fixture(scope="module")
def stream():
    return serve_pair(ARCH)


def test_stream_tokens_up_to_near_ties(stream):
    check_tokens_up_to_near_ties(stream)


def test_stream_traces_ledger_and_counters_exact(stream):
    """The arena is tight (re-admissions after preemption run the
    encoder again); the frames' h2d bytes and the cross K/V's cache
    growth are charged at every admission, as the JAX engine does."""
    check_serve_exact(stream)
    jrep, trep = stream["jrep"], stream["trep"]
    assert trep.sched.preemptions > 0
    cfg = get_config(ARCH).reduced()
    frames = cfg.encoder_seq_len * cfg.d_model * 2
    h2d = trep.ledger.breakdown()["prefill"]["acts"]["h2d"]
    assert h2d >= trep.sched.admitted * frames


def batch_pair(arch, b=3, prompt=10, gen=6):
    """The lockstep Engine of both packages (contiguous arena, bf16) over
    the same q8_0 weights, seeded prompts and random frontend inputs;
    returns the near-tie harness's dict."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = weights(arch)
    jmake, tmake = extras_makers(jcfg, tcfg, seed=11)
    jx = [jmake(jcfg, 1) for _ in range(b)]
    tx = [tmake(tcfg, 1) for _ in range(b)]
    key = next(iter(jx[0]))
    jextras = {key: jnp.concatenate([x[key] for x in jx])}
    textras = {key: torch.cat([x[key] for x in tx])}
    tok = np.random.RandomState(12).randint(0, jcfg.vocab_size,
                                            (b, prompt)).astype(np.int32)
    jit = jax.jit
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", lambda *a, **kw: jit(
            *a, **kw, compiler_options=EXACT_ROUNDING))
        jeng = JaxBatchEngine(jmodel, jparams, quant="q8_0",
                              max_seq=prompt + gen, chunk_size=4)
        (jout, jstats), jrow, scale = jax_logit_rows(
            jeng._engine_for(b), lambda: jeng.generate(
                jnp.asarray(tok), gen, extras=jextras))
    teng = Engine(tmodel, tparams, quant="q8_0", max_seq=prompt + gen,
                  chunk_size=4, device="cpu")
    tout, tstats = teng.generate(tok, gen, extras=textras)
    seqs = lambda out: types.SimpleNamespace(sequences=[  # noqa: E731
        types.SimpleNamespace(rid=i, generated=[int(x) for x in row])
        for i, row in enumerate(np.asarray(out))])
    return dict(jrep=seqs(jout), trep=seqs(tout), jrow=jrow, scale=scale,
                gen=gen, jstats=jstats, tstats=tstats)


def check_batch(runs):
    check_tokens_up_to_near_ties(runs)
    js, ts = runs["jstats"], runs["tstats"]
    assert ts.transfers.breakdown == js.transfers.breakdown
    assert (ts.steps, ts.decode_tokens, ts.cache_bytes) == \
        (js.steps, js.decode_tokens, js.cache_bytes)


def test_batch_mode_matches_jax():
    check_batch(batch_pair(ARCH))


def _refusal(engine_cls, model, **kw):
    with pytest.raises(ValueError) as e:
        engine_cls(model, {}, num_slots=2, max_seq=24, chunk_size=4, **kw)
    return str(e.value)


@pytest.mark.parametrize("kw", [dict(prefix_cache=True, block_size=4),
                                dict(kv_quant="int8", block_size=4),
                                dict(spec="draft")],
                         ids=["prefix_cache", "kv_quant", "draft"])
def test_engine_refusals_match_jax(models, kw):
    """The prefix cache (prompt KV depends on the frames), int8 pages
    (the admission pass writes the cross K/V unquantized) and a draft
    model (it has no frames): refused with the JAX engine's messages."""
    _, jmodel, _, _, tmodel, _ = models
    if kw.get("spec") == "draft":
        kw = dict(kw, spec_draft_model=jmodel, spec_draft_params={})
        tkw = dict(kw, spec_draft_model=tmodel)
    else:
        tkw = kw
    jmsg = _refusal(JaxEngine, jmodel, **kw)
    tmsg = _refusal(ServingEngine, tmodel, device="cpu", **tkw)
    assert tmsg == jmsg
    assert "encdec" in tmsg or "decoder-only" in tmsg


def launcher_refusals(arch, argv, capsys):
    """The same flag error from both launchers' checks."""
    msgs = []
    for mod in (jserve, tserve):
        ap = tserve.build_parser()    # the JAX launcher builds it in main()
        args = ap.parse_args(["--arch", arch, "--reduced", "--block-size",
                              "4"] + argv)
        with pytest.raises(SystemExit):
            mod.validate_args(ap, args)
        msgs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert msgs[0] == msgs[1]
    assert "unsupported" in msgs[0]


@pytest.mark.parametrize("argv", [["--prefix-cache"], ["--kv-quant", "int8"]],
                         ids=["prefix_cache", "kv_quant"])
def test_launcher_refusals_match_jax(argv, capsys):
    launcher_refusals(ARCH, argv, capsys)


@pytest.mark.parametrize("mode", ["stream", "batch"])
def test_cli_serves_on_cpu(mode, capsys):
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--quant",
            "q8_0", "--prompt-len", "8", "--gen", "3"]
    if mode == "stream":
        argv += ["--block-size", "4", "--requests", "3", "--arrival",
                 "back2back"]
    else:
        argv += ["--mode", "batch", "--batch", "2"]
    tserve.main(argv)
    out = capsys.readouterr().out
    assert f"arch={ARCH}-reduced" in out
    assert ("completed 3/3" in out) if mode == "stream" else \
        ("tok/s total" in out)
