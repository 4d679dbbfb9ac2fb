"""Port vs JAX package: the three remaining dense configs, llama3.2-3b
(tied embeddings), qwen2-72b (qkv bias, rope_theta 1e6) and llama3-405b
(128 heads over 8 kv-heads, G = 16), at reduced widths on the CPU.

* The config copies equal the JAX package's field by field, at full
  width and reduced.
* Reduced models with the same q8_0 weights: ``forward`` and ``prefill``
  logits within ``LOGIT_TOL`` = 2.5e-2 of max |logit| of the JAX
  package's (activations are bf16 in both packages; the reason and the
  number are ``tests/test_torch_model.py``'s), and the paged stream's
  greedy tokens equal to JAX's under the near-tie rule
  (``tests/test_torch_serving.py``'s harness: JAX's fused paged
  attention in interpret mode, an fp32 arena that preempts). The JAX
  side is compiled with ``xla_allow_excess_precision`` off
  (``EXACT_ROUNDING``, as ``tests/test_torch_recurrent_serving.py``
  does): by default XLA drops the bf16 round trips the model spells out,
  and in these reduced models, whose random logits tie often, that alone
  flips more near-ties than the harness's rule lets pass.
* llama3-405b's group of 16 query heads a kv-head, at reduced widths
  (``num_heads=16, num_kv_heads=1, head_dim=16``): the plain versions of
  B1 (bf16-valued f32 pages and int8 pages) and B7 against the JAX
  package's Pallas kernels in interpret mode, in f32, at their
  references' tolerances (``FP32_TOL`` of
  ``tests/test_paged_attention_kernel.py``; 1e-4 of
  ``tests/test_kernels.py`` for flash).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.core import convert as jconvert  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402,E501
from repro.kernels.paged_attention import (  # noqa: E402
    paged_decode_attention as jax_paged)
from repro.models import lm as jlm  # noqa: E402
from repro.models.api import build_model as jbuild  # noqa: E402
from repro_torch.configs.registry import (ARCHS, PENDING,  # noqa: E402
                                          family_of, get_config)
from repro_torch.core.convert import params_from_jax  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_decode_attention)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from test_torch_serving import (LOGIT_TOL,  # noqa: E402
                                check_tokens_up_to_near_ties, serve_both)

DENSE = ["llama3.2-3b", "qwen2-72b", "llama3-405b"]
EXACT_ROUNDING = {"xla_allow_excess_precision": False}
FP32_TOL = dict(atol=2e-6, rtol=2e-5)
FLASH_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: beside other test workers a thread pool per
    process slows these small ops by far more than it gains."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a.view(np.uint16))).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("arch", DENSE)
def test_config_copies_equal_jax(arch):
    j, t = JARCHS[arch], get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    assert family_of(arch) == "dense"


def test_every_jax_arch_is_ported():
    """``PENDING`` is empty: the port's registry holds every
    architecture of the JAX package's, and each builds at full width."""
    assert PENDING == {}
    assert set(ARCHS) == set(JARCHS)
    for arch in DENSE:
        assert build_model(get_config(arch)).cfg.name == arch
    assert get_config("llama3-405b").num_heads // \
        get_config("llama3-405b").num_kv_heads == 16


@pytest.fixture(scope="module")
def pairs():
    """arch -> (JAX cfg, JAX q8_0 params, port cfg, the same params)."""
    made = {}

    def get(arch):
        if arch not in made:
            cfg = JARCHS[arch].reduced()
            jp = jax.jit(lambda key: jconvert.quantize_params(
                jbuild(cfg).init(key), "q8_0"))(jax.random.PRNGKey(0))
            tcfg = get_config(arch).reduced()
            made[arch] = (cfg, jp, tcfg, params_from_jax(
                jax.tree.map(np.asarray, jp), tcfg, device="cpu"))
        return made[arch]
    return get


@pytest.mark.parametrize("arch", DENSE)
def test_forward_and_prefill_match_jax(pairs, arch):
    """Full-sequence logits and the prefill's last-token logits and
    caches; llama3.2-3b has no lm_head (tied), qwen2-72b carries q/k/v
    biases."""
    cfg, jp, tcfg, tp = pairs(arch)
    assert ("lm_head" in tp) != cfg.tie_embeddings
    assert ("b" in tp["layers0"][0]["attn"]["q"]) == cfg.qkv_bias
    tok = np.random.RandomState(7).randint(0, cfg.vocab_size, (2, 12)) \
        .astype(np.int32)
    jm, tm = jbuild(cfg), build_model(tcfg)
    batch_j, batch_t = {"tokens": jnp.asarray(tok)}, {"tokens": _t(tok)}
    lj, _ = jax.jit(lambda p, b: jm.forward(p, b, quant="q8_0"),
                    compiler_options=EXACT_ROUNDING)(jp, batch_j)
    lt, aux = tm.forward(tp, batch_t, quant="q8_0")
    assert float(aux) == 0.0
    pj, cj = jax.jit(lambda p, b: jm.prefill(p, b, quant="q8_0"),
                     compiler_options=EXACT_ROUNDING)(jp, batch_j)
    pt, ct = tm.prefill(tp, batch_t, quant="q8_0")
    for a, b in ((lt, lj), (pt, pj)):
        b = np.asarray(b.astype(jnp.float32))
        assert tuple(a.shape) == b.shape
        err = np.abs(a.float().numpy() - b).max()
        assert err <= LOGIT_TOL * np.abs(b).max(), (err, np.abs(b).max())
    for leaf in ("k", "v"):
        a = ct["layers0"][leaf].float().numpy()
        b = np.asarray(cj["layers0"][leaf].astype(jnp.float32))
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= LOGIT_TOL * np.abs(b).max()


@pytest.mark.parametrize("arch", DENSE)
def test_stream_tokens_match_jax_up_to_near_ties(arch):
    """The paged stream (q8_0, fp32 arena, back-to-back, preempting)
    through both engines: greedy tokens equal up to near-ties."""
    jit = jax.jit
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", lambda *a, **kw: jit(
            *a, **kw, compiler_options=EXACT_ROUNDING))
        runs = serve_both("q8_0", arch=arch)
    check_tokens_up_to_near_ties(runs)


def _g16():
    return dataclasses.replace(get_config("llama3-405b").reduced(),
                               num_heads=16, num_kv_heads=1, head_dim=16)


@pytest.mark.parametrize("chunk", [1, 5])
@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_group_16_paged_plain_matches_pallas(chunk, kv):
    """B1 (and B8 on int8 pages) at G = 16: the port's wrapper on CPU
    tensors (the plain version) against the JAX kernel in interpret
    mode, over shuffled, partly null tables."""
    cfg = _g16()
    h, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    b, bs, mb = 3, 4, 5
    nb = b * mb
    rng = np.random.RandomState(16 + chunk)
    perm = rng.permutation(nb)
    owned = [mb, 3, 2]
    tables = np.full((b, mb), nb, np.int32)
    for i in range(b):
        tables[i, :owned[i]] = perm[i * mb:i * mb + owned[i]]
    kp = rng.randn(nb + 1, bs, hkv, d).astype(np.float32)
    vp = rng.randn(nb + 1, bs, hkv, d).astype(np.float32)
    q = rng.randn(b, chunk, h, d).astype(np.float32)
    lens = np.array([chunk, max(chunk - 2, 1), 1], np.int32)
    pos = np.array([max(o * bs - chunk, 0) for o in owned], np.int32)
    kw_j, kw_t = {}, {}
    if kv == "int8":
        kq, ks = tattn.quantize_kv(_t(kp))
        vq, vs = tattn.quantize_kv(_t(vp))
        kp, vp = kq.numpy(), vq.numpy()
        for name, s in (("k_scales", ks), ("v_scales", vs)):
            kw_j[name], kw_t[name] = jnp.asarray(s.numpy()), s
    sm = d ** -0.5
    want = np.asarray(jax_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(pos), sm_scale=sm, lengths=jnp.asarray(lens),
        interpret=True, **kw_j))
    got = paged_decode_attention(_t(q), _t(kp), _t(vp), _t(tables), _t(pos),
                                 sm_scale=sm, lengths=_t(lens), **kw_t)
    assert tuple(got.shape) == (b, chunk, h, d)
    for i, n in enumerate(lens):
        np.testing.assert_allclose(got[i, :n].numpy(), want[i, :n],
                                   **FP32_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_group_16_flash_plain_matches_pallas(causal):
    """B7 at G = 16: the plain version (the wrapper on CPU tensors)
    against the JAX Pallas flash kernel in interpret mode."""
    cfg = _g16()
    h, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    rng = np.random.RandomState(3)
    s = 40
    q = (rng.randn(2, s, h, d) * 0.3).astype(np.float32)
    k = (rng.randn(2, s, hkv, d) * 0.3).astype(np.float32)
    v = rng.randn(2, s, hkv, d).astype(np.float32)
    tr = lambda a: jnp.asarray(np.transpose(a, (0, 2, 1, 3)))  # noqa: E731
    want = np.transpose(np.asarray(jax_flash(
        tr(q), tr(k), tr(v), causal=causal, block_q=128, block_k=128,
        interpret=True)), (0, 2, 1, 3))
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, **FLASH_TOL)


def test_group_16_decode_step_matches_jax():
    """A chunked paged decode step of the reduced llama3-405b widened to
    G = 16 (q8_0, the plain paged attention against JAX's fused one):
    valid rows' logits within LOGIT_TOL."""
    cfg = dataclasses.replace(JARCHS["llama3-405b"].reduced(), num_heads=16,
                              num_kv_heads=1, head_dim=16)
    jm = jbuild(cfg)
    jp = jax.jit(lambda key: jconvert.quantize_params(jm.init(key), "q8_0"))(
        jax.random.PRNGKey(1))
    tcfg = _g16()
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    rng = np.random.RandomState(5)
    b, c, bs, mb = 3, 4, 4, 4
    nb = b * mb
    tables = rng.permutation(nb).reshape(b, mb).astype(np.int32)
    hist = (rng.randn(2, cfg.num_layers, nb + 1, bs, 1, 16) * 0.5).astype(
        np.float32)
    jcache = {"layers0": {"k": jnp.asarray(hist[0], jnp.bfloat16),
                          "v": jnp.asarray(hist[1], jnp.bfloat16)}}
    tcache = {"layers0": {k: _t(np.asarray(v))
                          for k, v in jcache["layers0"].items()}}
    tok = rng.randint(0, cfg.vocab_size, (b, c)).astype(np.int32)
    pos = np.array([0, 5, 9], np.int32)
    lens = np.array([4, 2, 1], np.int32)
    lj, _ = jlm.lm_decode_step(
        jp, cfg, jnp.asarray(tok), jnp.asarray(pos), jcache, quant="q8_0",
        block_tables=jnp.asarray(tables), lengths=jnp.asarray(lens),
        paged_impl="fused")
    lt, _ = build_model(tcfg).decode_step(
        tp, _t(tok), _t(pos), tcache, quant="q8_0", block_tables=_t(tables),
        lengths=_t(lens))
    lj = np.asarray(lj.astype(jnp.float32))
    scale = np.abs(lj).max()
    for i, n in enumerate(lens):
        err = np.abs(lt[i, :n].float().numpy() - lj[i, :n]).max()
        assert err <= LOGIT_TOL * scale, (i, err, scale)
