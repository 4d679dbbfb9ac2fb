"""Port vs JAX package: the vlm family (qwen2-vl-2b: M-RoPE, qkv bias,
the vision-embed merge, tied embeddings) at reduced widths (8 vision
tokens, M-RoPE sections (4, 6, 6)) on the CPU.

The same numpy-seeded inputs (random vision embeddings, not zeros) and
the same q8_0 weights go through the JAX package's ``repro.models.lm``
and the port's ``repro_torch.models.lm``, and the same stream through
both serving engines (``test_torch_encdec.py``'s harness).

Tolerances, with their reasons:

* ``apply_mrope`` in f32: 2e-5 (the same products; cos/sin from another
  library). The M-RoPE position grids are integers: equal exactly.
* Whole passes (``lm_forward``/``lm_prefill`` with vision embeddings,
  also clipped to a prompt shorter than the vision grid, and decode
  chunks, one spanning the vision/text boundary): within ``LOGIT_TOL``
  = 2.5e-2 of max |logit| (bf16 activations in both packages; the JAX
  side compiled with excess precision off).
* Serving (chunk 3, so prompt chunks straddle the vision/text
  boundary): tokens equal up to near-ties; traces, the ledger (the
  vision rows' h2d charges included) and the counters exactly equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.runtime import kvcache as jkv  # noqa: E402
from repro.runtime.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.runtime import kvcache as tkv  # noqa: E402
from repro_torch.runtime.engine import ServingEngine  # noqa: E402
from test_torch_encdec import (F32_TOL, _refusal,  # noqa: E402
                               assert_close_rel, batch_pair, check_batch,
                               check_serve_exact, exact_jit,
                               launcher_refusals, serve_pair, weights)
from test_torch_serving import ENGINE  # noqa: E402
from test_torch_serving import check_tokens_up_to_near_ties  # noqa: E402
from test_torch_ssm import _n  # noqa: E402

ARCH = "qwen2-vl-2b"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread (see test_torch_speculative.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    return weights(ARCH)


def vision_for(cfg, b, seed=3):
    """Random vision embeddings (b, vision_tokens, d) in bf16: (JAX
    array, the same torch tensor)."""
    a = np.random.RandomState(seed).randn(
        b, cfg.vision_tokens, cfg.d_model).astype(np.float32)
    return jnp.asarray(a).astype(jnp.bfloat16), \
        torch.from_numpy(a).to(torch.bfloat16)


def test_apply_mrope_matches_jax(models):
    """Each section of the D/2 rotary channels rotates by its own
    position stream."""
    cfg = models[0]
    r = np.random.RandomState(0)
    x = r.randn(2, 9, 3, cfg.resolved_head_dim()).astype(np.float32)
    pos3 = r.randint(0, 300, (2, 9, 3)).astype(np.int32)
    j = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos3),
                            cfg.rope_theta, cfg.mrope_sections)
    t = tlayers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                            cfg.rope_theta, cfg.mrope_sections)
    np.testing.assert_allclose(_n(t), np.asarray(j), **F32_TOL)
    # streams differ per section: a plain RoPE of any one stream differs
    assert np.abs(_n(t) - _n(tlayers.apply_rope(
        torch.from_numpy(x), torch.from_numpy(pos3[..., 0]),
        cfg.rope_theta))).max() > 1e-3


@pytest.mark.parametrize("seq", [5, 8, 13])
def test_mrope_positions_equal_jax(models, seq):
    """The prefill grid (its vision raster clipped to a short sequence)
    and the pointwise decode mapping, over positions that span the
    vision/text boundary."""
    cfg = models[0]
    np.testing.assert_array_equal(
        tlm._mrope_positions(cfg, 2, seq, "cpu").numpy(),
        np.asarray(jlm._mrope_positions(cfg, 2, seq)))
    pos = np.arange(seq)[None] + np.array([[0], [3]])
    np.testing.assert_array_equal(
        tlm._mrope_decode_positions(cfg, torch.from_numpy(pos)).numpy(),
        np.asarray(jlm._mrope_decode_positions(cfg, jnp.asarray(pos))))


@pytest.mark.parametrize("seq", [13, 5], ids=["text-after-vision",
                                              "clipped-vision"])
@pytest.mark.parametrize("entry", ["forward", "prefill"])
def test_full_sequence_matches_jax(models, entry, seq):
    cfg, jmodel, jparams, _, tmodel, tparams = models
    jv, tv = vision_for(cfg, 2)
    tok = np.random.RandomState(4).randint(0, cfg.vocab_size, (2, seq)) \
        .astype(np.int32)
    v = min(cfg.vision_tokens, seq)
    fn = getattr(jmodel, entry)
    jl, jc = exact_jit(lambda p, b: fn(p, b, quant="q8_0"))(
        jparams, {"tokens": jnp.asarray(tok), "vision_embeds": jv[:, :v]})
    tl, tc = getattr(tmodel, entry)(
        tparams, {"tokens": torch.from_numpy(tok),
                  "vision_embeds": tv[:, :v]}, quant="q8_0")
    assert_close_rel(_n(tl), np.asarray(jl.astype(jnp.float32)), entry)
    if entry == "prefill":
        for leaf in ("k", "v"):
            assert_close_rel(_n(tc["layers0"][leaf]), np.asarray(
                jc["layers0"][leaf].astype(jnp.float32)), leaf)
    # the vision rows took effect: zero embeddings move the logits
    zl, _ = getattr(tmodel, entry)(
        tparams, {"tokens": torch.from_numpy(tok),
                  "vision_embeds": torch.zeros_like(tv[:, :v])},
        quant="q8_0")
    assert float((zl.float() - tl.float()).abs().max()) > 1e-2


def test_decode_chunks_span_the_vision_boundary(models):
    """Two chunked decode steps on the contiguous arena: positions 0..3
    (vision rows), then 4..11 (rows 4..7 vision, the rest text; lengths
    8 / 6), the override mask per position as the engine builds it."""
    cfg, jmodel, jparams, _, tmodel, tparams = models
    jv, tv = vision_for(cfg, 2, seed=5)
    ja = jkv.KVArena(jmodel, 2, 16, dtype=jnp.float32)
    ta = tkv.KVArena(tmodel, 2, 16, dtype=torch.float32, device="cpu")
    r = np.random.RandomState(6)
    jcache = ja.buffers
    for base, width, lens in ((0, 4, [4, 4]), (4, 8, [8, 6])):
        tok = r.randint(0, cfg.vocab_size, (2, width)).astype(np.int32)
        pos = np.full((2,), base, np.int32)
        n_vis = max(0, min(cfg.vision_tokens - base, width))
        emb = np.zeros((2, width, cfg.d_model), np.float32)
        emb[:, :n_vis] = np.asarray(
            jv[:, base:base + n_vis].astype(jnp.float32))
        mask = np.zeros((2, width), bool)
        mask[:, :n_vis] = True
        lens = np.asarray(lens, np.int32)
        jl, jcache = exact_jit(lambda p, c: jmodel.decode_step(
            p, jnp.asarray(tok), jnp.asarray(pos), c, quant="q8_0",
            lengths=jnp.asarray(lens),
            embeds=jnp.asarray(emb).astype(jnp.bfloat16),
            embeds_mask=jnp.asarray(mask)))(jparams, jcache)
        tl, _ = tmodel.decode_step(
            tparams, torch.from_numpy(tok), torch.from_numpy(pos),
            ta.buffers, quant="q8_0", lengths=torch.from_numpy(lens),
            embeds=torch.from_numpy(emb).to(torch.bfloat16),
            embeds_mask=torch.from_numpy(mask))
        for b, n in enumerate(lens):
            assert_close_rel(_n(tl[b, :n]), np.asarray(jl[b, :n],
                                                       np.float32),
                             f"base {base} row {b}")
    assert n_vis == 4                   # the second chunk straddles


@pytest.fixture(scope="module")
def stream():
    return serve_pair(ARCH, engine=dict(ENGINE, chunk_size=3))


def test_stream_tokens_up_to_near_ties(stream):
    check_tokens_up_to_near_ties(stream)


def test_stream_traces_ledger_and_counters_exact(stream):
    """Every prompt holds the whole vision prefix: each streamed vision
    row is charged as a bf16 upload, as the JAX engine charges it."""
    check_serve_exact(stream)
    trep = stream["trep"]
    cfg = tserve.get_config(ARCH).reduced()
    h2d = trep.ledger.breakdown()["prefill"]["acts"]["h2d"]
    assert h2d >= len(stream["treqs"]) * cfg.vision_tokens * cfg.d_model * 2


def test_batch_mode_matches_jax():
    check_batch(batch_pair(ARCH))


def test_engine_refuses_the_prefix_cache_as_jax(models):
    _, jmodel, _, _, tmodel, _ = models
    kw = dict(prefix_cache=True, block_size=4)
    jmsg = _refusal(JaxEngine, jmodel, **kw)
    assert _refusal(ServingEngine, tmodel, device="cpu", **kw) == jmsg
    assert "vlm" in jmsg


def test_launcher_refuses_the_prefix_cache_as_jax(capsys):
    launcher_refusals(ARCH, ["--prefix-cache"], capsys)


@pytest.mark.parametrize("mode", ["stream", "batch"])
def test_cli_serves_on_cpu(mode, capsys):
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--quant",
            "q8_0", "--prompt-len", "12", "--gen", "3"]
    if mode == "stream":
        argv += ["--block-size", "4", "--requests", "3", "--arrival",
                 "back2back", "--spec", "ngram", "--spec-k", "2"]
    else:
        argv += ["--mode", "batch", "--batch", "2"]
    tserve.main(argv)
    out = capsys.readouterr().out
    assert f"arch={ARCH}-reduced" in out
    assert ("completed 3/3" in out) if mode == "stream" else \
        ("tok/s total" in out)
