"""Port vs JAX package: the dense qwen3 model (reduced widths; q8_0, and
the decode step under every recipe).

The JAX package's parameters are carried into the port through
``params_from_jax`` (numpy in between), the same random cache pages and
inputs go to both, and one chunked paged decode step
(``lm_decode_step``) must give the same logits.

Tolerances, with their reasons:

* Activations are bf16 in both packages (``lm.py`` hard-codes it). The
  f32 matmuls sum in another order (oneDNN vs XLA/Eigen), so an
  intermediate occasionally rounds to the neighbouring bf16 value, and
  such one-ulp flips travel through the layers. Logits of valid rows must
  agree within ``LOGIT_TOL`` = 2.5e-2 of max |logit| (measured 1.7e-2;
  anything looser than 5e-2 would be a fault to chase, not a tolerance).
* With f32 activations (the layer-level test) nothing rounds to bf16 and
  the few-ULP f32 bound holds.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.registry import ASSIGNED  # noqa: E402
from repro.core import convert as jconvert  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.api import build_model as jbuild  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.convert import params_from_jax  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402

LOGIT_TOL = 2.5e-2
F32_TOL = dict(rtol=2e-5, atol=2e-5)
B, C, BS, MB = 3, 4, 4, 4


@pytest.fixture(scope="module")
def recipes():
    """recipe -> (cfg, JAX params, port cfg, the same params in the port),
    built once per recipe."""
    made = {}

    def get(quant):
        if quant not in made:
            cfg = ASSIGNED["qwen3-0.6b"].reduced()
            jparams = jax.jit(lambda key: jconvert.quantize_params(
                jbuild(cfg).init(key), quant))(jax.random.PRNGKey(0))
            tcfg = get_config("qwen3-0.6b").reduced()
            tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")
            made[quant] = (cfg, jparams, tcfg, tparams)
        return made[quant]
    return get


@pytest.fixture(scope="module")
def both(recipes):
    return recipes("q8_0")


def _t(a: np.ndarray) -> torch.Tensor:
    """numpy (incl. ml_dtypes bf16) -> torch, bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a.view(np.uint16))).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def test_params_from_jax_unstacks_groups(both):
    cfg, jparams, tcfg, tparams = both
    assert set(tparams) == set(jparams)
    layers = tparams["layers0"]
    assert isinstance(layers, list) and len(layers) == cfg.num_layers
    j_qs = np.asarray(jparams["layers0"]["attn"]["q"]["qs"])
    for i, lp in enumerate(layers):
        np.testing.assert_array_equal(lp["attn"]["q"]["qs"].numpy(), j_qs[i])
    np.testing.assert_array_equal(
        tparams["embed"]["d"].numpy().view(np.uint16),
        np.asarray(jparams["embed"]["d"]).view(np.uint16))
    # bf16 leaves travel as their bit pattern.
    w = jnp.asarray(np.random.RandomState(0).randn(3, 5), jnp.bfloat16)
    got = params_from_jax({"x": {"w": np.asarray(w)}}, tcfg,
                          device="cpu")["x"]["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.uint16).numpy(),
                                  np.asarray(w).view(np.uint16))


def test_paged_cache_shapes_match_jax(both):
    cfg, _, tcfg, _ = both
    jshapes, paged = jbuild(cfg).paged_cache_shapes(4, 17, 8)
    assert build_model(tcfg).paged_cache_shapes(4, 17, 8) == jshapes
    assert all(jax.tree.leaves(paged))


@pytest.mark.parametrize("quant", ["q8_0", "fp16", "q6_k", "q3_k_s"])
@pytest.mark.parametrize("paged_impl", ["fused", "ref"])
@pytest.mark.parametrize("cache_dtype", ["bfloat16", "float32"])
def test_decode_step_logits_match_jax(recipes, quant, paged_impl,
                                      cache_dtype):
    """Each of the paper's recipes: q8_0, fp16 (fp16 linears and a plain
    tied lm_head), q6_k (q6_k linears and lm_head) and q3_k_s (q3_k
    linears, q6_k embedding and lm_head)."""
    cfg, jparams, tcfg, tparams = recipes(quant)
    rng = np.random.RandomState(1)
    nb = B * MB
    tables = rng.permutation(nb).reshape(B, MB).astype(np.int32)
    hist = (rng.randn(2, cfg.num_layers, nb + 1, BS, cfg.num_kv_heads,
                      cfg.resolved_head_dim()) * 0.5).astype(np.float32)
    jcache = {"layers0": {"k": jnp.asarray(hist[0], cache_dtype),
                          "v": jnp.asarray(hist[1], cache_dtype)}}
    tcache = {"layers0": {k: _t(np.asarray(v))
                          for k, v in jcache["layers0"].items()}}
    tok = rng.randint(0, cfg.vocab_size, (B, C)).astype(np.int32)
    pos = np.array([0, 5, 9], np.int32)            # history depths
    lens = np.array([4, 2, 1], np.int32)           # prefill chunk .. decode
    lj, cj = jlm.lm_decode_step(
        jparams, cfg, jnp.asarray(tok), jnp.asarray(pos), jcache,
        quant=quant, block_tables=jnp.asarray(tables),
        lengths=jnp.asarray(lens), paged_impl=paged_impl)
    lt, ct = build_model(tcfg).decode_step(
        tparams, _t(tok), _t(pos), tcache, quant=quant,
        block_tables=_t(tables), lengths=_t(lens), paged_impl=paged_impl)
    assert lt.dtype == torch.bfloat16 and tuple(lt.shape) == \
        (B, C, cfg.vocab_size)
    lj = np.asarray(lj.astype(jnp.float32))
    lt = lt.float().numpy()
    scale = np.abs(lj).max()
    for b, n in enumerate(lens):
        err = np.abs(lj[b, :n] - lt[b, :n]).max()
        assert err <= LOGIT_TOL * scale, (b, err, scale)
    # The step wrote each valid token's K/V into its page, in place.
    kt = ct["layers0"]["k"].float().numpy()
    kj = np.asarray(cj["layers0"]["k"].astype(jnp.float32))
    np.testing.assert_allclose(kt, kj, atol=0.1, rtol=0.05)
    untouched = np.ones(nb + 1, bool)
    for b, n in enumerate(lens):
        for p in range(pos[b], pos[b] + n):
            untouched[tables[b, p // BS]] = False
    np.testing.assert_array_equal(kt[:, untouched],
                                  hist[0][:, untouched].astype(kt.dtype)
                                  if cache_dtype == "float32" else
                                  kj[:, untouched])


@pytest.mark.parametrize("chunk", [1, 3])
def test_gqa_decode_f32_matches_jax(both, chunk):
    """One GQA layer with f32 activations and an f32 cache: no bf16
    rounding anywhere, so the few-ULP f32 bound holds."""
    cfg, jparams, _, tparams = both
    jp = jax.tree.map(lambda a: a[0], jparams["layers0"]["attn"])
    tp = tparams["layers0"][0]["attn"]
    rng = np.random.RandomState(2 + chunk)
    nb = B * MB
    tables = rng.permutation(nb).reshape(B, MB).astype(np.int32)
    hist = rng.randn(2, nb + 1, BS, cfg.num_kv_heads,
                     cfg.resolved_head_dim()).astype(np.float32)
    x = rng.randn(B, chunk, cfg.d_model).astype(np.float32)
    pos = np.array([3, 7, 0], np.int32)
    lens = np.array([chunk, 1, chunk], np.int32)
    oj, _ = jax.jit(jattn.gqa_decode, static_argnums=1,
                    static_argnames="fmt")(
        jp, cfg, jnp.asarray(x), jnp.asarray(pos),
        {"k": jnp.asarray(hist[0]), "v": jnp.asarray(hist[1])}, fmt="q8_0",
        block_tables=jnp.asarray(tables), lengths=jnp.asarray(lens))
    cache = {"k": _t(hist[0]), "v": _t(hist[1])}
    ot, _ = tattn.gqa_decode(tp, cfg, _t(x), _t(pos), cache, fmt="q8_0",
                             block_tables=_t(tables), lengths=_t(lens))
    for b, n in enumerate(lens):
        np.testing.assert_allclose(ot[b, :n].numpy(), np.asarray(oj)[b, :n],
                                   **F32_TOL)


def test_host_side_layers_match_jax(both):
    """rmsnorm, rope, the q8_0 embedding gather and swiglu in f32."""
    cfg, jparams, _, tparams = both
    rng = np.random.RandomState(4)
    x = rng.randn(2, 5, cfg.d_model).astype(np.float32)
    g = {"g": rng.rand(cfg.d_model).astype(np.float32) + 0.5}
    np.testing.assert_allclose(
        tlayers.rmsnorm_apply({"g": _t(g["g"])}, _t(x), 1e-6).numpy(),
        np.asarray(jlayers.rmsnorm_apply(
            {"g": jnp.asarray(g["g"])}, jnp.asarray(x), 1e-6)), **F32_TOL)
    hx = rng.randn(2, 5, 4, 32).astype(np.float32)
    pos = rng.randint(0, 1000, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        tlayers.apply_rope(_t(hx), _t(pos), cfg.rope_theta).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(hx), jnp.asarray(pos),
                                      cfg.rope_theta)),
        rtol=1e-4, atol=1e-4)       # cos/sin of angles up to ~1e3 rad
    tok = rng.randint(0, cfg.vocab_size, (2, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        tlayers.embedding_lookup(tparams["embed"], _t(tok), "q8_0",
                                 torch.float32, width=cfg.d_model).numpy(),
        np.asarray(jlayers.embedding_lookup(
            jparams["embed"], jnp.asarray(tok), "q8_0", jnp.float32,
            width=cfg.d_model)))
    jf = jax.tree.map(lambda a: a[0], jparams["layers0"]["ffn"])
    np.testing.assert_allclose(
        tlayers.swiglu_apply(tparams["layers0"][0]["ffn"], _t(x),
                             "q8_0").numpy(),
        np.asarray(jlayers.swiglu_apply(jf, jnp.asarray(x), "q8_0")),
        **F32_TOL)


def test_fp16_embedding_lookup_matches_jax(recipes):
    """The fp16 recipe's lookup gathers the rows, then casts them: the
    same bits as the JAX package's cast-then-gather."""
    cfg, jparams, _, tparams = recipes("fp16")
    tok = np.random.RandomState(6).randint(0, cfg.vocab_size, (2, 3))
    got = tlayers.embedding_lookup(tparams["embed"], _t(tok.astype(np.int32)),
                                   "fp16", torch.bfloat16)
    want = jlayers.embedding_lookup(jparams["embed"], jnp.asarray(tok),
                                    "fp16", jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.uint16).numpy(),
                                  np.asarray(want).view(np.uint16))
