"""Port vs JAX package: MLA (deepseek-v3, reduced widths) on the CPU.

* The MLA form of ``paged_decode_attention`` (``v_pages=None``: the ckv
  pages are V; the RoPE side ``q2``/``k2_pages``) through the port's
  wrapper on CPU tensors — the plain version its CUDA kernel is held
  against on the card — against the JAX Pallas kernel in interpret mode:
  chunk 1/4/5, f32, bf16 and int8 pages, partly null tables, at
  ``FP32_TOL`` (tests/test_paged_attention_kernel.py: blocked online vs
  dense softmax, the same math in another order).
* ``mla_decode`` (fused, ref and contiguous over an f32 cache; fused
  and ref over int8 pages) and ``mla_prefill`` with f32 activations
  against the JAX functions: outputs of valid rows at atol 5e-6 / rtol
  5e-5 (the JAX package's own fused-vs-ref bound); the step writes the
  same cache positions, with the same values at that bound (int8: codes
  at most one step apart, where the f32 inputs round differently), and
  the port's fused and ref steps write bit-identical pages.
* The whole reduced model: forward, prefill and decode logits within
  ``LOGIT_TOL`` (activations are bf16 in both packages,
  tests/test_torch_model.py), and a paged serve stream on bf16 and int8
  pages through both ``ServingEngine``s: greedy tokens equal up to
  near-ties, allocator traces and ``breakdown()`` exactly equal
  (tests/test_torch_serving.py's harness).

The port's MLA is held against the JAX package's chunked *engine* (the
serve streams below), which it matches. The JAX package's sequential
fp32 oracle disagrees with that engine for this model
(``tests/test_chunked_prefill.py::test_chunked_matches_oracle_fp32
[deepseek-v3-671b]`` fails in the reference itself), so it is not
reproduced here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.registry import ASSIGNED  # noqa: E402
from repro.core import convert as jconvert  # noqa: E402
from repro.kernels.paged_attention import (  # noqa: E402
    paged_decode_attention as jax_paged)
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.api import build_model as jbuild  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.convert import params_from_jax  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_decode_attention)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from test_torch_serving import (check_ledger_exact,  # noqa: E402
                                check_tokens_up_to_near_ties,
                                check_traces_equal, serve_both)

ARCH = "deepseek-v3-671b"
FP32_TOL = dict(atol=2e-6, rtol=2e-5)
LAYER_TOL = dict(atol=5e-6, rtol=5e-5)
LOGIT_TOL = 2.5e-2
B, H, RANK, ROPE, BS, MB = 3, 4, 16, 8, 4, 6
NB = B * MB


def _t(a) -> torch.Tensor:
    """numpy (incl. ml_dtypes bf16) -> torch, bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a.view(np.uint16))).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _tables(rng, owned):
    perm = rng.permutation(NB)
    t = np.full((B, MB), NB, np.int32)
    for i in range(B):
        t[i, :owned[i]] = perm[i * MB:i * MB + owned[i]]
    return t


def _kernel_case(chunk, pages, seed):
    """MLA operands in the kernel's layout (Hkv = 1): f32, bf16 or int8
    (code + fp16 scale) ckv and krope pages."""
    rng = np.random.RandomState(seed)
    owned = [MB, 3, 2]
    tables = _tables(rng, owned)
    ckv = rng.randn(NB + 1, BS, 1, RANK).astype(np.float32)
    kr = rng.randn(NB + 1, BS, 1, ROPE).astype(np.float32)
    q1 = rng.randn(B, chunk, H, RANK).astype(np.float32)
    q2 = rng.randn(B, chunk, H, ROPE).astype(np.float32)
    pos = np.array([max(o * BS - chunk, 0) for o in owned], np.int32)
    lens = np.array([chunk, max(chunk - 2, 1), 1], np.int32)
    args = dict(q=q1, q2=q2, tables=tables, pos=pos, lens=lens)
    if pages == "int8":
        for name, x in (("k", ckv), ("k2", kr)):
            q, s = jattn.quantize_kv(jnp.asarray(x[:, :, 0]))
            args[name] = np.asarray(q)[:, :, None]
            args[name + "s"] = np.asarray(s)[:, :, None]
    else:
        dt = jnp.bfloat16 if pages == "bfloat16" else jnp.float32
        args["k"] = np.asarray(jnp.asarray(ckv, dt))
        args["k2"] = np.asarray(jnp.asarray(kr, dt))
    return args


def _both_kernels(a, rope=True):
    sm = (RANK + ROPE) ** -0.5
    j = dict(q2=jnp.asarray(a["q2"]), k2_pages=jnp.asarray(a["k2"])) \
        if rope else {}
    t = dict(q2=_t(a["q2"]), k2_pages=_t(a["k2"])) if rope else {}
    if "ks" in a:
        j.update(k_scales=jnp.asarray(a["ks"]))
        t.update(k_scales=_t(a["ks"]))
        if rope:
            j.update(k2_scales=jnp.asarray(a["k2s"]))
            t.update(k2_scales=_t(a["k2s"]))
    want = np.asarray(jax_paged(
        jnp.asarray(a["q"]), jnp.asarray(a["k"]), None,
        jnp.asarray(a["tables"]), jnp.asarray(a["pos"]), sm_scale=sm,
        lengths=jnp.asarray(a["lens"]), out_dtype=jnp.float32,
        interpret=True, **j))
    got = paged_decode_attention(
        _t(a["q"]), _t(a["k"]), None, _t(a["tables"]), _t(a["pos"]),
        sm_scale=sm, lengths=_t(a["lens"]), **t).numpy()
    return got, want


@pytest.mark.parametrize("pages", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("chunk", [1, 4, 5])          # 5 == block_size + 1
def test_mla_plain_version_matches_pallas(chunk, pages):
    a = _kernel_case(chunk, pages, seed=100 + chunk)
    got, want = _both_kernels(a)
    assert got.shape == (B, chunk, H, RANK) and got.dtype == np.float32
    for b, n in enumerate(a["lens"]):
        np.testing.assert_allclose(got[b, :n], want[b, :n], **FP32_TOL)


def test_shared_kv_without_rope_matches_pallas():
    """``v_pages=None`` alone (no q2): the K pages are V."""
    a = _kernel_case(3, "float32", seed=7)
    got, want = _both_kernels(a, rope=False)
    for b, n in enumerate(a["lens"]):
        np.testing.assert_allclose(got[b, :n], want[b, :n], **FP32_TOL)


# ----------------------------------------------------------------------
# The MLA layer
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def layer():
    """(JAX cfg, JAX q8_0 MLA params, port cfg, the same in the port)."""
    cfg = ASSIGNED[ARCH].reduced()
    jp = jax.jit(lambda key: jattn.mla_init(key, cfg, "q8_0"))(
        jax.random.PRNGKey(3))
    tcfg = get_config(ARCH).reduced()
    tp = params_from_jax({"attn": jax.tree.map(np.asarray, jp)}, tcfg,
                         device="cpu")["attn"]
    return cfg, jp, tcfg, tp


def _layer_inputs(cfg, chunk, seed):
    m = cfg.mla
    rng = np.random.RandomState(seed)
    tables = _tables(rng, [MB, 4, 3])
    hist = {"ckv": rng.randn(NB + 1, BS, m.kv_lora_rank),
            "krope": rng.randn(NB + 1, BS, m.qk_rope_head_dim)}
    hist = {k: v.astype(np.float32) for k, v in hist.items()}
    x = rng.randn(B, chunk, cfg.d_model).astype(np.float32)
    pos = np.array([7, 3, 9], np.int32)
    lens = np.array([chunk, max(chunk - 1, 1), 1], np.int32)
    return tables, hist, x, pos, lens


# The JAX layer, compiled once per shape (its eager op-by-op dispatch is
# several times slower on the CPU).
_jit_decode = jax.jit(jattn.mla_decode, static_argnums=1,
                      static_argnames=("fmt", "paged_impl"))


def _contiguous(hist, tables):
    """The paged history as a contiguous (B, MB * bs, ...) cache."""
    return {k: v[tables].reshape(B, MB * BS, -1) for k, v in hist.items()}


@pytest.mark.parametrize("impl", ["fused", "ref", "contiguous"])
@pytest.mark.parametrize("chunk", [1, 3, 5])
def test_mla_decode_matches_jax(layer, impl, chunk):
    """f32 activations and an f32 cache: outputs of valid rows at the JAX
    package's fused-vs-ref bound, and the step's cache writes land
    where the JAX step's do, with the JAX step's values."""
    cfg, jp, tcfg, tp = layer
    tables, hist, x, pos, lens = _layer_inputs(cfg, chunk, seed=20 + chunk)
    paged = impl != "contiguous"
    cache = hist if paged else _contiguous(hist, tables)
    kw = dict(block_tables=tables, paged_impl=impl) if paged else {}
    oj, cj = _jit_decode(
        jp, cfg, jnp.asarray(x), jnp.asarray(pos),
        {k: jnp.asarray(v) for k, v in cache.items()}, fmt="q8_0",
        lengths=jnp.asarray(lens),
        **{k: jnp.asarray(v) if k == "block_tables" else v
           for k, v in kw.items()})
    tcache = {k: _t(v) for k, v in cache.items()}
    ot, ct = tattn.mla_decode(
        tp, tcfg, _t(x), _t(pos), tcache, fmt="q8_0", lengths=_t(lens),
        **{k: _t(v) if k == "block_tables" else v for k, v in kw.items()})
    assert ct is tcache                       # written in place
    for b, n in enumerate(lens):
        np.testing.assert_allclose(ot[b, :n].numpy(), np.asarray(oj)[b, :n],
                                   **LAYER_TOL)
    for leaf in ("ckv", "krope"):
        got, want = ct[leaf].numpy(), np.asarray(cj[leaf])
        changed = got != cache[leaf]
        np.testing.assert_array_equal(changed, want != cache[leaf])
        np.testing.assert_allclose(got, want, **LAYER_TOL)


@pytest.mark.parametrize("chunk", [1, 3, 5])
def test_mla_decode_fused_and_ref_write_the_same_pages(layer, chunk):
    """The port's fused and ref paths share the insert: their pages are
    bit-identical after the step, and their valid rows agree at the
    layer bound (the JAX package's fused-vs-ref layer test, in the
    port)."""
    cfg, _, tcfg, tp = layer
    tables, hist, x, pos, lens = _layer_inputs(cfg, chunk, seed=40 + chunk)
    out = {}
    for impl in ("fused", "ref"):
        cache = {k: _t(v) for k, v in hist.items()}
        out[impl] = tattn.mla_decode(
            tp, tcfg, _t(x), _t(pos), cache, fmt="q8_0",
            block_tables=_t(tables), lengths=_t(lens), paged_impl=impl)
    (of, cf), (orf, cr) = out["fused"], out["ref"]
    for leaf in ("ckv", "krope"):
        assert torch.equal(cf[leaf], cr[leaf])
    for b, n in enumerate(lens):
        np.testing.assert_allclose(of[b, :n].numpy(), orf[b, :n].numpy(),
                                   **LAYER_TOL)


def _quant_cache(hist):
    out = {}
    for k, v in hist.items():
        q, s = jattn.quantize_kv(jnp.asarray(v))
        out[k] = {"q": np.asarray(q), "s": np.asarray(s)}
    return out


@pytest.mark.parametrize("impl", ["fused", "ref"])
@pytest.mark.parametrize("chunk", [1, 4])
def test_mla_decode_int8_matches_jax(layer, impl, chunk):
    """int8 pages: quantize-on-insert writes the JAX codes and scales (at
    most one code step apart where the f32 inputs round differently),
    and the valid rows agree at the layer bound."""
    cfg, jp, tcfg, tp = layer
    tables, hist, x, pos, lens = _layer_inputs(cfg, chunk, seed=30 + chunk)
    qc = _quant_cache(hist)
    oj, cj = _jit_decode(
        jp, cfg, jnp.asarray(x), jnp.asarray(pos),
        jax.tree.map(jnp.asarray, qc), fmt="q8_0",
        block_tables=jnp.asarray(tables), lengths=jnp.asarray(lens),
        paged_impl=impl)
    tcache = {k: {p: _t(a) for p, a in v.items()} for k, v in qc.items()}
    ot, ct = tattn.mla_decode(tp, tcfg, _t(x), _t(pos), tcache, fmt="q8_0",
                              block_tables=_t(tables), lengths=_t(lens),
                              paged_impl=impl)
    for b, n in enumerate(lens):
        np.testing.assert_allclose(ot[b, :n].numpy(), np.asarray(oj)[b, :n],
                                   **LAYER_TOL)
    for leaf in ("ckv", "krope"):
        gq, wq = ct[leaf]["q"].numpy(), np.asarray(cj[leaf]["q"])
        assert np.abs(gq.astype(int) - wq.astype(int)).max() <= 1
        np.testing.assert_allclose(ct[leaf]["s"].float().numpy(),
                                   np.asarray(cj[leaf]["s"], np.float32),
                                   rtol=1e-3)


def test_mla_prefill_matches_jax(layer):
    """Prefill (expanded K/V, flash kernel's plain version at D = nope +
    rope, Dv = v) and the compressed cache it returns, f32 activations."""
    cfg, jp, tcfg, tp = layer
    rng = np.random.RandomState(5)
    x = rng.randn(2, 11, cfg.d_model).astype(np.float32)
    positions = np.broadcast_to(np.arange(11), (2, 11)).astype(np.int32)
    oj, cj = jax.jit(jattn.mla_prefill, static_argnums=1,
                     static_argnames="fmt")(
        jp, cfg, jnp.asarray(x), jnp.asarray(positions), fmt="q8_0")
    ot, ct = tattn.mla_prefill(tp, tcfg, _t(x),
                               tattn.rope_tables(tcfg, _t(positions)),
                               fmt="q8_0")
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **LAYER_TOL)
    for leaf in ("ckv", "krope"):
        np.testing.assert_allclose(ct[leaf].numpy(), np.asarray(cj[leaf]),
                                   **LAYER_TOL)


# ----------------------------------------------------------------------
# The whole reduced model
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def model():
    cfg = ASSIGNED[ARCH].reduced()
    jparams = jax.jit(lambda key: jconvert.quantize_params(
        jbuild(cfg).init(key), "q8_0"))(jax.random.PRNGKey(0))
    tcfg = get_config(ARCH).reduced()
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return cfg, jparams, build_model(tcfg), tparams


def _close_logits(lt, lj, rows=None):
    lj = np.asarray(jnp.asarray(lj, jnp.float32))
    lt = lt.float().numpy()
    assert lt.shape == lj.shape
    scale = np.abs(lj).max()
    for b in range(lt.shape[0]):
        n = lt.shape[1] if rows is None else rows[b]
        err = np.abs(lt[b, :n] - lj[b, :n]).max()
        assert err <= LOGIT_TOL * scale, (b, err, scale)


def test_params_from_jax_carries_the_mla_tree(model):
    """Both groups (the dense MLA layer, then the MoE MLA layers) arrive
    with every leaf of the JAX tree, per layer."""
    cfg, jparams, tmodel, tparams = model
    groups = [(n, c) for n, c, _ in jlm.layer_groups(cfg)]
    assert groups == [("layers0", 1), ("layers1", 3)]
    for name, count in groups:
        assert len(tparams[name]) == count
        flat_j = jax.tree_util.tree_flatten_with_path(jparams[name])[0]
        for path, leaf in flat_j:
            node = tparams[name][count - 1]
            for p in path:
                node = node[p.key]
            want = np.asarray(leaf)[count - 1]
            if want.dtype.name == "bfloat16":
                want = want.view(np.uint16)
                node = node.view(torch.uint16)
            np.testing.assert_array_equal(node.numpy(), want)
    assert set(tparams["layers0"][0]["attn"]) >= {"q_a_norm", "kv_a_norm",
                                                  "kv_b"}


def test_paged_cache_shapes_match_jax(model):
    cfg, _, tmodel, _ = model
    jshapes, paged = jbuild(cfg).paged_cache_shapes(4, 17, 8)
    assert tmodel.paged_cache_shapes(4, 17, 8) == jshapes
    assert all(jax.tree.leaves(paged))
    q = tmodel.paged_cache_shapes(4, 17, 8, kv_quant="int8")
    assert q["layers1"]["ckv"] == {"q": (3, 17, 8, cfg.mla.kv_lora_rank),
                                   "s": (3, 17, 8)}


@pytest.mark.parametrize("entry", ["forward", "prefill"])
def test_full_sequence_logits_match_jax(model, entry):
    cfg, jparams, tmodel, tparams = model
    tok = np.random.RandomState(8).randint(0, cfg.vocab_size, (2, 9))
    tok = tok.astype(np.int32)
    jfn = jlm.lm_forward if entry == "forward" else jlm.lm_prefill
    lj, extra_j = jax.jit(jfn, static_argnums=1, static_argnames="quant")(
        jparams, cfg, {"tokens": jnp.asarray(tok)}, quant="q8_0")
    lt, extra_t = getattr(tmodel, entry)(
        tparams, {"tokens": torch.from_numpy(tok)}, quant="q8_0")
    _close_logits(lt, lj)
    if entry == "forward":     # the MoE layers' load-balance losses
        np.testing.assert_allclose(float(extra_t), float(extra_j),
                                   rtol=1e-2)
    else:
        for name, leaves in extra_j.items():
            for leaf, want in leaves.items():
                np.testing.assert_allclose(
                    extra_t[name][leaf].float().numpy(),
                    np.asarray(want, np.float32), atol=0.1, rtol=0.05)


@pytest.mark.parametrize("paged_impl", ["fused", "ref"])
def test_decode_step_logits_match_jax(model, paged_impl):
    cfg, jparams, tmodel, tparams = model
    m = cfg.mla
    rng = np.random.RandomState(9)
    tables = rng.permutation(NB).reshape(B, MB).astype(np.int32)
    shapes = tmodel.paged_cache_shapes(B, NB + 1, BS)
    hist = {n: {k: (rng.randn(*s) * 0.5).astype(np.float32)
                for k, s in leaves.items()} for n, leaves in shapes.items()}
    assert shapes["layers1"]["ckv"] == (3, NB + 1, BS, m.kv_lora_rank)
    tok = rng.randint(0, cfg.vocab_size, (B, 4)).astype(np.int32)
    pos = np.array([0, 5, 9], np.int32)
    lens = np.array([4, 2, 1], np.int32)
    lj, _ = jax.jit(jlm.lm_decode_step, static_argnums=1,
                    static_argnames=("quant", "paged_impl"))(
        jparams, cfg, jnp.asarray(tok), jnp.asarray(pos),
        jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), hist),
        quant="q8_0", block_tables=jnp.asarray(tables),
        lengths=jnp.asarray(lens), paged_impl=paged_impl)
    tcache = {n: {k: _t(v).to(torch.bfloat16) for k, v in leaves.items()}
              for n, leaves in hist.items()}
    lt, _ = tmodel.decode_step(tparams, _t(tok), _t(pos), tcache,
                               quant="q8_0", block_tables=_t(tables),
                               lengths=_t(lens), paged_impl=paged_impl)
    _close_logits(lt, lj, rows=lens)


@pytest.fixture(scope="module", params=["none", "int8"])
def runs(request):
    return serve_both("q8_0", arch=ARCH, kv_quant=request.param)


def test_serve_tokens_up_to_near_ties(runs):
    check_tokens_up_to_near_ties(runs)


def test_serve_allocator_and_table_traces_equal(runs):
    assert runs["jrep"].sched.preemptions > 0      # the arena was tight
    check_traces_equal(runs)


def test_serve_ledger_breakdown_exact(runs):
    check_ledger_exact(runs)
