"""Port vs JAX package: prefill, forward, the contiguous arena and the
lockstep batch serve (CPU, reduced widths).

* ``model.prefill`` (last-token logits and every layer's K/V) and
  ``model.forward`` (all logits) under the paper's four recipes. The
  attention goes through ``chunked_attention`` (the flash kernel's plain
  version here).
* The contiguous insert (``_insert_kv``, bit for bit) and the
  contiguous branch of ``gqa_decode`` (f32).
* ``KVArena``: buffers and bytes after ``write_prefill`` and
  ``reset_slot``, bit for bit.
* The contiguous ``ServingEngine`` (``block_size=None``): allocator
  trace and ``TransferLedger.breakdown()`` exact, tokens up to near-ties
  (the harness of ``tests/test_torch_serving.py``).
* The lockstep ``Engine.generate``: tokens up to near-ties; and
  ``serve --mode batch --device cpu`` runs.

Tolerances: activations are bf16 in both packages, so logits agree
within ``LOGIT_TOL`` = 2.5e-2 of max |logit| (tests/test_torch_model.py
gives the reason); K/V within the decode test's 0.1 + 5 % (one bf16 flip
upstream moves a projection by a few bf16 ulps).
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.registry import ASSIGNED  # noqa: E402
from repro.core import convert as jconvert  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.api import build_model as jbuild  # noqa: E402
from repro.runtime.engine import Engine as JaxLockstep  # noqa: E402
from repro.runtime.kvcache import KVArena as JaxArena  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.convert import params_from_jax  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.runtime.engine import Engine  # noqa: E402
from repro_torch.runtime.kvcache import KVArena  # noqa: E402
from test_torch_serving import (check_ledger_exact,  # noqa: E402
                                check_tokens_up_to_near_ties,
                                check_traces_equal, jax_logit_rows,
                                serve_both)

LOGIT_TOL = 2.5e-2
KV_TOL = dict(atol=0.1, rtol=0.05)
B, S = 2, 13


@pytest.fixture(scope="module")
def recipes():
    """recipe -> (JAX cfg, JAX params, port model, port params)."""
    made = {}

    def get(quant):
        if quant not in made:
            cfg = ASSIGNED["qwen3-0.6b"].reduced()
            jparams = jax.jit(lambda key: jconvert.quantize_params(
                jbuild(cfg).init(key), quant))(jax.random.PRNGKey(0))
            tcfg = get_config("qwen3-0.6b").reduced()
            tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")
            made[quant] = (cfg, jparams, build_model(tcfg), tparams)
        return made[quant]
    return get


def _tokens(cfg, seed=1):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _close_logits(lt, lj):
    lj = np.asarray(lj.astype(jnp.float32))
    lt = lt.float().numpy()
    assert lt.shape == lj.shape
    scale = np.abs(lj).max()
    assert np.abs(lt - lj).max() <= LOGIT_TOL * scale, \
        (np.abs(lt - lj).max(), scale)


@pytest.mark.parametrize("quant", ["q8_0", "fp16", "q6_k", "q3_k_s"])
def test_prefill_matches_jax(recipes, quant):
    cfg, jparams, model, tparams = recipes(quant)
    tok = _tokens(cfg)
    lj, cj = jlm.lm_prefill(jparams, cfg, {"tokens": jnp.asarray(tok)},
                            quant=quant)
    lt, ct = model.prefill(tparams, {"tokens": torch.from_numpy(tok)},
                           quant=quant)
    assert lt.dtype == torch.bfloat16 and lt.shape == (B, 1, cfg.vocab_size)
    _close_logits(lt, lj)
    assert set(ct) == set(cj) == {"layers0"}
    for leaf in ("k", "v"):
        got = ct["layers0"][leaf]
        want = np.asarray(cj["layers0"][leaf].astype(jnp.float32))
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == \
            want.shape == (cfg.num_layers, B, S, cfg.num_kv_heads,
                           cfg.resolved_head_dim())
        np.testing.assert_allclose(got.float().numpy(), want, **KV_TOL)


@pytest.mark.parametrize("quant", ["q8_0", "fp16", "q6_k", "q3_k_s"])
def test_forward_matches_jax(recipes, quant):
    cfg, jparams, model, tparams = recipes(quant)
    tok = _tokens(cfg, seed=2)
    lj, aux_j = jlm.lm_forward(jparams, cfg, {"tokens": jnp.asarray(tok)},
                               quant=quant)
    lt, aux_t = model.forward(tparams, {"tokens": torch.from_numpy(tok)},
                              quant=quant)
    assert lt.shape == (B, S, cfg.vocab_size)
    _close_logits(lt, lj)
    assert float(aux_t) == float(aux_j) == 0.0


def test_prefill_refuses_non_token_inputs(recipes):
    """A dense model takes no vision embeddings (only the vlm family
    merges them, ``test_torch_vlm.py``): refused, not ignored."""
    _, _, model, tparams = recipes("q8_0")
    with pytest.raises(ValueError, match="vision_embeds"):
        model.prefill(tparams, {
            "tokens": torch.zeros((1, 4), dtype=torch.int32),
            "vision_embeds": torch.zeros((1, 2, 8))})


@pytest.mark.parametrize("position,lengths", [
    (5, None),                        # lockstep: one token at a scalar
    ([3, 0, 9], None),                # per-slot depths, one token each
    ([3, 0, 9], [4, 0, 2]),           # chunks with invalid tails
    ([14, 2, 13], [3, 1, 3]),         # entries past S are dropped
])
def test_insert_kv_matches_jax(position, lengths):
    """The contiguous insert against the JAX package's ``_insert_kv``
    (drop-mode scatter), bit for bit, in place."""
    rng = np.random.RandomState(7)
    c = 1 if lengths is None and np.ndim(position) == 0 else 4
    cache = rng.randn(3, 16, 2, 8).astype(np.float32)
    new = rng.randn(3, c, 2, 8).astype(np.float32)
    if np.ndim(position) == 1 and lengths is None:
        new = new[:, :1]
    pos = np.asarray(position, np.int32)
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    want = np.asarray(jattn._insert_kv(
        jnp.asarray(cache), jnp.asarray(new), jnp.asarray(pos),
        None if lens is None else jnp.asarray(lens)))
    got = torch.from_numpy(cache.copy())
    out = tattn._insert_kv(got, torch.from_numpy(new), torch.from_numpy(pos),
                           None if lens is None else torch.from_numpy(lens))
    assert out is got
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("chunk", [1, 3])
def test_gqa_decode_contiguous_f32_matches_jax(recipes, chunk):
    """The contiguous branch of ``gqa_decode`` (insert + plain decode
    attention with kv_len = pos + 1) with f32 activations and cache: the
    few-ULP f32 bound of tests/test_torch_model.py."""
    cfg, jparams, _, tparams = recipes("q8_0")
    jp = jax.tree.map(lambda a: a[0], jparams["layers0"]["attn"])
    tp = tparams["layers0"][0]["attn"]
    rng = np.random.RandomState(8 + chunk)
    hist = rng.randn(2, 3, 16, cfg.num_kv_heads,
                     cfg.resolved_head_dim()).astype(np.float32)
    x = rng.randn(3, chunk, cfg.d_model).astype(np.float32)
    pos = np.array([3, 7, 0], np.int32)
    lens = np.array([chunk, 1, chunk], np.int32)
    oj, cj = jattn.gqa_decode(jp, cfg, jnp.asarray(x), jnp.asarray(pos),
                              {"k": jnp.asarray(hist[0]),
                               "v": jnp.asarray(hist[1])}, fmt="q8_0",
                              lengths=jnp.asarray(lens))
    cache = {"k": torch.from_numpy(hist[0].copy()),
             "v": torch.from_numpy(hist[1].copy())}
    ot, _ = tattn.gqa_decode(tp, cfg, torch.from_numpy(x),
                             torch.from_numpy(pos), cache, fmt="q8_0",
                             lengths=torch.from_numpy(lens))
    oj = np.asarray(oj)
    for b, n in enumerate(lens):
        np.testing.assert_allclose(ot[b, :n].numpy(), oj[b, :n],
                                   rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(cj["k"]),
                               rtol=2e-5, atol=2e-5)


def test_kv_arena_write_prefill_and_reset_match_jax(recipes):
    """The same B=1 prefill cache written into slot 1 of both arenas:
    every buffer and byte count equal, bit for bit; reset_slot changes
    nothing for the dense family."""
    cfg, jparams, model, tparams = recipes("q8_0")
    tok = _tokens(cfg)[:1, :9]
    _, cj = jlm.lm_prefill(jparams, cfg, {"tokens": jnp.asarray(tok)},
                           quant="q8_0")
    ja = JaxArena(jbuild(cfg), 3, 16)
    ta = KVArena(model, 3, 16, device="cpu")
    assert ja.alloc() == ta.alloc() == 0
    assert ja.alloc() == ta.alloc() == 1
    ja.write_prefill(cj, 1)
    ta.write_prefill({g: {k: torch.from_numpy(
        np.asarray(v).view(np.uint16).copy()).view(torch.bfloat16)
        for k, v in leaves.items()} for g, leaves in cj.items()}, 1)
    ja.reset_slot(1)
    ta.reset_slot(1)
    for leaf in ("k", "v"):
        np.testing.assert_array_equal(
            ta.buffers["layers0"][leaf].view(torch.uint16).numpy(),
            np.asarray(ja.buffers["layers0"][leaf]).view(np.uint16))
    assert ta.buffers["layers0"]["k"][:, 1, :9].any()
    for attr in ("nbytes", "slot_bytes", "token_bytes", "resident_bytes"):
        assert getattr(ta, attr)() == getattr(ja, attr)(), attr
    ja.free(0)
    ta.free(0)
    assert ta.free_slots == ja.free_slots == 2
    assert ta.resident_bytes() == ja.resident_bytes()


@pytest.fixture(scope="module")
def contiguous_runs():
    return serve_both("q8_0", engine=dict(num_slots=4, max_seq=24,
                                          chunk_size=4))


def test_contiguous_serve_tokens_up_to_near_ties(contiguous_runs):
    check_tokens_up_to_near_ties(contiguous_runs)


def test_contiguous_serve_allocator_trace_equal(contiguous_runs):
    check_traces_equal(contiguous_runs)


def test_contiguous_serve_ledger_exact(contiguous_runs):
    check_ledger_exact(contiguous_runs)
    assert contiguous_runs["trep"].stats.cache_bytes == \
        contiguous_runs["jrep"].stats.cache_bytes


def test_lockstep_generate_matches_jax(recipes):
    """``Engine.generate`` (contiguous arena, chunked step) against the
    JAX package's, greedy: tokens up to near-ties."""
    cfg, jparams, model, tparams = recipes("q8_0")
    prompt = _tokens(cfg, seed=3)[:, :10]
    gen = 6
    jeng = JaxLockstep(jbuild(cfg), jparams, quant="q8_0", max_seq=16,
                       chunk_size=4)
    inner = jeng._engine_for(B)                # wrapped before generate
    (jout, _), jrow, scale = jax_logit_rows(
        inner, lambda: jeng.generate(jnp.asarray(prompt), gen))
    tout, stats = Engine(model, tparams, quant="q8_0", max_seq=16,
                         chunk_size=4, device="cpu").generate(prompt, gen)
    assert tout.shape == (B, gen) and stats.decode_tokens == B * gen
    seqs = lambda out: types.SimpleNamespace(sequences=[  # noqa: E731
        types.SimpleNamespace(rid=i, generated=[int(t) for t in row])
        for i, row in enumerate(np.asarray(out))])
    check_tokens_up_to_near_ties(dict(jrep=seqs(jout), trep=seqs(tout),
                                      jrow=jrow, scale=scale, gen=gen))


def test_lockstep_from_dense_quantizes(recipes):
    cfg, _, model, _ = recipes("q8_0")
    dense = model.init(torch.Generator().manual_seed(0))
    eng = Engine.from_dense(model, dense, "q8_0", max_seq=16, device="cpu")
    assert set(eng.params["layers0"][0]["attn"]["q"]) == {"qs", "d"}
    out, _ = eng.generate(_tokens(cfg)[:, :5], 3)
    assert out.shape == (B, 3)
    with pytest.raises(ValueError, match="exceed"):
        eng.generate(_tokens(cfg)[:, :12], 5)


def test_cli_batch_mode_runs_on_cpu(capsys):
    tserve.main(["--reduced", "--device", "cpu", "--quant", "q8_0",
                 "--mode", "batch", "--prompt-len", "8", "--gen", "3",
                 "--batch", "2"])
    out = capsys.readouterr().out
    assert "[8:3] batch=2" in out and "tok/s total" in out


def test_cli_contiguous_stream_runs_on_cpu(capsys):
    tserve.main(["--reduced", "--device", "cpu", "--quant", "q8_0",
                 "--requests", "3", "--slots", "2", "--prompt-len", "8",
                 "--gen", "3", "--arrival", "back2back"])
    out = capsys.readouterr().out
    assert "contiguous[2x" in out and "completed 3/3" in out
