"""Port vs JAX package: serving the recurrent families, mamba2 (SSD) and
jamba (Mamba + attention + MoE), on the CPU at reduced widths.

The same stream (``build_stream``) and the same q8_0 weights go through
the port's ``ServingEngine`` and the JAX one (``test_torch_serving.py``'s
harness) on the paged arena (f32 pages, as the harness serves) — jamba's
attention pages beside per-slot SSM state; mamba2's one-block tables
over no pages at all — and on the contiguous arena (bf16, the serve's
default: on an f32 contiguous arena the JAX step hands its conv window
back in bf16 and the JAX arena re-types that leaf after the first step,
moving its per-token bytes — ROADMAP §C):

1. greedy tokens equal up to near-ties (the harness's rule);
2. allocator and table traces, the ledger breakdown and the counters
   exactly equal;
3. the arenas' per-leaf storage dtypes equal JAX's probe (the SSM state
   f32 on every arena, the conv window bf16 on a bf16 one) and their byte
   accounting equal JAX's;
4. ``reset_slot`` zeroes exactly one slot's state leaves and nothing else;
5. chunk 4 serves the same tokens as chunk 1 (the recurrence gated per
   row collapses to the sequential one);
6. speculation, the prefix cache and int8 pages are refused with the JAX
   engine's and launcher's messages.

The JAX engine's step is compiled with XLA's ``xla_allow_excess_precision``
off (``EXACT_ROUNDING``): by default XLA drops the bf16 round trips of a
compiled step, and over jamba's 8 random layers that moves its logits by
~3 % of max |logit| (see ``test_torch_ssm.py``), enough to flip more
near-ties than the harness's rule lets pass. With the option off the JAX
step rounds where the model says, as the port does and as the same JAX
functions do when run op by op.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.registry import ASSIGNED  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models.api import build_model as jbuild  # noqa: E402
from repro.runtime import kvcache as jkv  # noqa: E402
from repro.runtime.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.runtime import kvcache as tkv  # noqa: E402
from repro_torch.runtime.engine import ServingEngine  # noqa: E402
from test_torch_serving import (ARGS, ENGINE,  # noqa: E402
                                check_ledger_exact,
                                check_tokens_up_to_near_ties,
                                check_traces_equal, serve_both)
from test_torch_ssm import EXACT_ROUNDING  # noqa: E402

ARCHS = ["mamba2-1.3b", "jamba-v0.1-52b"]
CONTIGUOUS = dict(num_slots=4, max_seq=ARGS.prompt_len + ARGS.gen,
                  chunk_size=4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread (see test_torch_speculative.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=[
    (a, arena) for a in ARCHS for arena in ("paged", "contiguous")],
    ids=lambda p: f"{p[0]}-{p[1]}")
def runs(request):
    arch, arena = request.param
    jit = jax.jit
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", lambda *a, **kw: jit(
            *a, **kw, compiler_options=EXACT_ROUNDING))
        return serve_both("q8_0", arch=arch,
                          engine=ENGINE if arena == "paged" else CONTIGUOUS,
                          cache_dtype="float32" if arena == "paged"
                          else "bfloat16")


def test_greedy_tokens_identical_up_to_near_ties(runs):
    check_tokens_up_to_near_ties(runs)


def test_allocator_and_table_traces_equal(runs):
    check_traces_equal(runs)


def test_ledger_and_counters_exact(runs):
    check_ledger_exact(runs)
    ts, js = runs["trep"].stats, runs["jrep"].stats
    for f in ("steps", "cache_bytes", "peak_resident_bytes",
              "resident_bytes_sum", "live_tokens_sum", "prefix_hits",
              "cow_splits", "spec_proposed"):
        assert getattr(ts, f) == getattr(js, f), f
    for f in ("admitted", "completed", "preemptions", "slot_reuses",
              "occupancy_sum", "max_occupancy", "steps", "prefill_chunks",
              "deferred_feeds"):                  # not the wall-clock waits
        assert getattr(runs["trep"].sched, f) == \
            getattr(runs["jrep"].sched, f), f


def _leaf_dtypes(arena):
    return tuple(str(t.dtype).split(".")[-1] for t in tkv._leaves(
        arena.buffers))


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_arena_leaf_dtypes_and_bytes_match_jax(arch, dtype, paged):
    """The JAX arena probes one decode step (``jax.eval_shape``) for the
    dtypes of its state leaves; the port states them per leaf kind. Both
    arenas hold the same leaves in the same dtypes and count the same
    bytes."""
    cfg, tcfg = ASSIGNED[arch].reduced(), get_config(arch).reduced()
    if paged:
        ja = jkv.PagedKVArena(jbuild(cfg), 3, 16, block_size=4,
                              dtype=jnp.dtype(dtype))
        ta = tkv.PagedKVArena(build_model(tcfg), 3, 16, block_size=4,
                              dtype=getattr(torch, dtype), device="cpu")
    else:
        ja = jkv.KVArena(jbuild(cfg), 3, 16, dtype=jnp.dtype(dtype))
        ta = tkv.KVArena(build_model(tcfg), 3, 16,
                         dtype=getattr(torch, dtype), device="cpu")
    jdt = tuple(x.dtype.name for x in jax.tree.leaves(ja.buffers))
    assert _leaf_dtypes(ta) == jdt
    assert "float32" in jdt                         # the SSM state
    assert tuple(tuple(t.shape) for t in tkv._leaves(ta.buffers)) == \
        tuple(x.shape for x in jax.tree.leaves(ja.buffers))
    for who in (ja, ta):
        if paged:
            assert who.alloc_slot(who.blocks_needed(6)) == 0
        else:
            assert who.alloc() == 0
    attrs = ["nbytes", "token_bytes", "resident_bytes"] + (
        ["block_bytes", "const_bytes", "blocks_needed"] if paged
        else ["slot_bytes"])
    for attr in attrs:
        args = (9,) if attr == "blocks_needed" else ()
        assert getattr(ta, attr)(*args) == getattr(ja, attr)(*args), attr
    if paged:
        assert ta.has_paged == ja.has_paged == (arch != "mamba2-1.3b")


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_reset_slot_zeroes_only_the_slots_state(arch, paged):
    """After tests/test_chunked_prefill.py's reset test: every leaf set to
    1, ``reset_slot(1)`` zeroes slot 1 of exactly the state leaves; the
    other slots' state and every page keep their ones."""
    model = build_model(get_config(arch).reduced())
    arena = tkv.PagedKVArena(model, 3, 16, block_size=4, device="cpu") \
        if paged else tkv.KVArena(model, 3, 16, device="cpu")
    state = tkv._leaves(model.state_leaves(3))
    for t in tkv._leaves(arena.buffers):
        t.fill_(1)
    arena.reset_slot(1)
    assert len(state) == len(tkv._leaves(arena.buffers))
    for t, const in zip(tkv._leaves(arena.buffers), state):
        if const:
            assert bool((t[:, 1] == 0).all())
            assert bool((t[:, 0] == 1).all()) and bool((t[:, 2] == 1).all())
        else:
            assert bool((t == 1).all())
    assert any(state)
    if arch == "jamba-v0.1-52b":
        assert not all(state)


@pytest.mark.parametrize("arch", ARCHS)
def test_chunk_4_serves_the_tokens_of_chunk_1(arch):
    """After tests/test_chunked_prefill.py's recurrent case: the same
    stream at chunk 4 and at chunk 1 (the paged arena) gives the same
    tokens exactly."""
    tcfg = get_config(arch).reduced()
    model = build_model(tcfg)
    params = tserve.build_params(model, types.SimpleNamespace(
        seed=0, quant="q8_0"), torch.device("cpu"))
    args = types.SimpleNamespace(**{**vars(ARGS), "gen": 3, "requests": 4})
    out = []
    for chunk in (4, 1):
        reqs = tserve.build_stream(tcfg, args, np.random.RandomState(6))
        eng = ServingEngine(model, params, quant="q8_0", num_slots=2,
                            max_seq=24, chunk_size=chunk, block_size=4,
                            device="cpu")
        rep = eng.serve(reqs, seed=0, realtime=False)
        out.append([s.generated for s in rep.sequences])
    assert out[0] == out[1]
    assert all(len(g) == 3 for g in out[0])


def _refusal(engine_cls, model, params, **kw):
    with pytest.raises(ValueError) as e:
        engine_cls(model, params, num_slots=2, max_seq=24, chunk_size=4,
                   **kw)
    return str(e.value)


@pytest.mark.parametrize("kw", [dict(spec="ngram"),
                                dict(prefix_cache=True, block_size=4),
                                dict(kv_quant="int8", block_size=4)],
                         ids=["spec", "prefix_cache", "kv_quant"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_refusals_match_jax(arch, kw):
    """The recurrent state cannot roll back, is not addressable by token
    blocks and is not per-position KV: each feature is refused with the
    JAX engine's message."""
    cfg, tcfg = ASSIGNED[arch].reduced(), get_config(arch).reduced()
    jmsg = _refusal(JaxEngine, jbuild(cfg), {}, **kw)
    tmsg = _refusal(ServingEngine, build_model(tcfg), {}, device="cpu",
                    **kw)
    assert tmsg == jmsg
    assert cfg.family in tmsg


@pytest.mark.parametrize("argv", [
    ["--spec", "ngram"], ["--prefix-cache"], ["--kv-quant", "int8"],
    ["--spec", "draft", "--spec-draft-model", "ARCH"]],
    ids=["spec", "prefix_cache", "kv_quant", "draft"])
@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_refusals_match_jax(arch, argv, capsys):
    """The launchers' flag checks: the same error message from both."""
    argv = [arch if a == "ARCH" else a for a in argv]
    base = ["--arch", arch if "draft" not in argv else "qwen3-0.6b",
            "--reduced", "--block-size", "4"] + argv
    msgs = []
    for mod in (jserve, tserve):
        ap = tserve.build_parser()    # the JAX launcher builds it in main()
        args = ap.parse_args(base)
        with pytest.raises(SystemExit):
            mod.validate_args(ap, args)
        msgs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert msgs[0] == msgs[1]
    assert "unsupported" in msgs[0] or "cannot draft" in msgs[0]


@pytest.mark.parametrize("mode", ["stream", "batch"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_the_recurrent_families_on_cpu(arch, mode, capsys):
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--quant",
            "q8_0", "--prompt-len", "8", "--gen", "3"]
    if mode == "stream":
        argv += ["--block-size", "4", "--requests", "3", "--arrival",
                 "back2back"]
    else:
        argv += ["--mode", "batch", "--batch", "2"]
    tserve.main(argv)
    out = capsys.readouterr().out
    assert f"arch={arch}-reduced" in out
    assert ("completed 3/3" in out) if mode == "stream" else \
        ("tok/s total" in out)
