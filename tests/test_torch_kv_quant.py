"""Port vs JAX package: int8 KV pages (CPU, reduced widths).

* ``quantize_kv`` codes and scales bit for bit, all-zero rows and exact
  half-way ties included; ``dequantize_kv`` exact.
* The int8 form of the paged attention's plain version (what the CUDA
  kernel is held against on the card) against the JAX Pallas kernel in
  interpret mode, at ``tests/test_kv_quant.py``'s shapes and
  ``FP32_TOL`` (blocked online vs dense softmax, the same math in
  another order).
* ``gqa_decode`` on int8 pages, fused and ref, against the JAX package:
  the inserted codes and scales, and the outputs.
* The int8 serve against the JAX serve (the harness of
  ``tests/test_torch_serving.py``): allocator traces and the ledger
  exact, tokens up to near-ties.
* The arena's layout and bytes, the ``write_prefill`` refusal, and the
  engine's and launcher's refusals (after ``tests/test_kv_quant.py``).
"""
import argparse
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.registry import ASSIGNED  # noqa: E402
from repro.kernels.paged_attention import (  # noqa: E402
    paged_decode_attention as jax_paged)
from repro.models import attention as jattn  # noqa: E402
from repro.models.api import build_model as jbuild  # noqa: E402
from repro.runtime.kvcache import PagedKVArena as JaxPagedArena  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.convert import params_from_jax  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_decode_attention)
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.runtime.engine import ServingEngine  # noqa: E402
from repro_torch.runtime.kvcache import PagedKVArena  # noqa: E402
from test_torch_serving import (ENGINE, check_ledger_exact,  # noqa: E402
                                check_tokens_up_to_near_ties,
                                check_traces_equal, serve_both)

FP32_TOL = dict(atol=2e-6, rtol=2e-5)
B, H, HKV, D, BS, MB = 3, 8, 2, 16, 4, 6
NB = B * MB


def _t(a):
    return torch.from_numpy(np.array(a))


def _quant_both(x):
    """(port codes, port scales, JAX codes, JAX scales) as numpy."""
    qt, st = tattn.quantize_kv(_t(x))
    qj, sj = jattn.quantize_kv(jnp.asarray(x))
    return qt.numpy(), st.numpy(), np.asarray(qj), np.asarray(sj)


def test_quantize_kv_bit_exact():
    rng = np.random.RandomState(3)
    x = (rng.randn(5, 7, 16) * 3.0).astype(np.float32)
    x[1, 2] = 0.0                                   # an all-zero row
    x[4, :3] = 0.0
    qt, st, qj, sj = _quant_both(x)
    assert qt.dtype == np.int8 and st.dtype == np.float16
    np.testing.assert_array_equal(qt, qj)
    np.testing.assert_array_equal(st.view(np.uint16), sj.view(np.uint16))
    assert not qt[1, 2].any() and st[1, 2] == 0


def test_quantize_kv_half_way_ties_round_to_even():
    """Rows whose f32 scale is exactly 1 or 2 put elements exactly half
    way between codes: both packages round them to the even code."""
    row1 = np.array([127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5],
                    np.float32)
    row2 = np.array([254, 1, 3, 5, -1, -3, -5, 7], np.float32)
    x = np.stack([row1, row2])[None]
    qt, st, qj, sj = _quant_both(x)
    np.testing.assert_array_equal(qt, qj)
    np.testing.assert_array_equal(st.view(np.uint16), sj.view(np.uint16))
    np.testing.assert_array_equal(qt[0, 0], [127, 0, 2, 2, 0, -2, -2, 4])


def test_dequantize_kv_exact():
    rng = np.random.RandomState(4)
    q = rng.randint(-127, 128, (3, 5, 8)).astype(np.int8)
    s = (rng.rand(3, 5) * 0.05).astype(np.float16)
    got = tattn.dequantize_kv(_t(q), _t(s))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jattn.dequantize_kv(jnp.asarray(q),
                                                    jnp.asarray(s))))


def _quant_pages(rng, d=D):
    """Codes and scales of random K/V pages (quantized from a normal
    tensor, so the joint statistics are realistic), tables with null
    entries, per-row positions."""
    owned = [MB, 3, 2]
    perm = rng.permutation(NB)
    tables = np.full((B, MB), NB, np.int32)
    for i in range(B):
        tables[i, :owned[i]] = perm[i * MB:i * MB + owned[i]]
    pages = []
    for _ in range(2):
        q, s = jattn.quantize_kv(jnp.asarray(
            rng.randn(NB + 1, BS, HKV, d).astype(np.float32)))
        pages += [np.asarray(q), np.asarray(s)]
    return tables, owned, pages


@pytest.mark.parametrize("chunk", [1, 4, 5])
def test_int8_plain_version_matches_jax_kernel(chunk):
    rng = np.random.RandomState(40 + chunk)
    tables, owned, (kq, ks, vq, vs) = _quant_pages(rng)
    q = rng.randn(B, chunk, H, D).astype(np.float32)
    pos = np.array([max(o * BS - chunk, 0) for o in owned], np.int32)
    lens = np.array([chunk, max(chunk - 2, 1), 1], np.int32)
    sm = D ** -0.5
    want = np.asarray(jax_paged(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(tables),
        jnp.asarray(pos), sm_scale=sm, k_scales=jnp.asarray(ks),
        v_scales=jnp.asarray(vs), lengths=jnp.asarray(lens), interpret=True))
    got = paged_decode_attention(
        _t(q), _t(kq), _t(vq), _t(tables), _t(pos), sm_scale=sm,
        lengths=_t(lens), k_scales=_t(ks), v_scales=_t(vs)).numpy()
    for b, n in enumerate(lens):
        np.testing.assert_allclose(got[b, :n], want[b, :n], **FP32_TOL)


def test_int8_zeroed_pages_read_as_zero():
    """Codes 0 with scales 0 dequantize to exactly 0: attention over an
    all-zero int8 arena is exactly 0."""
    q = torch.randn(1, 2, H, D)
    pages = torch.zeros(NB + 1, BS, HKV, D, dtype=torch.int8)
    scales = torch.zeros(NB + 1, BS, HKV, dtype=torch.float16)
    out = paged_decode_attention(
        q, pages, pages, torch.tensor([[0, 1, NB, NB, NB, NB]],
                                      dtype=torch.int32),
        torch.tensor([5], dtype=torch.int32), sm_scale=0.25,
        k_scales=scales, v_scales=scales)
    assert not out.any()


@pytest.mark.parametrize("kw,err,match", [
    (dict(k_scales=0), ValueError, "accompany"),
    (dict(k_scales=0, v_scales=0, pages=torch.float32), ValueError,
     "take none"),
    (dict(pages=torch.int8), ValueError, "need k_scales"),
    (dict(k_scales=0, v_scales=0, scale_dtype=torch.float32), TypeError,
     "float16"),
    (dict(k_scales=0, v_scales=0, scale_shape=(NB + 1, BS)), TypeError,
     "float16"),
    (dict(v_none=True, k_scales=0, v_scales=0), ValueError,
     "v_scales must accompany v_pages"),
    (dict(q2=True, k_scales=0, v_scales=0), ValueError,
     "q2 and k2_pages must accompany"),
])
def test_int8_wrapper_checks(kw, err, match):
    """Scales come with int8 pages, both or neither, fp16 (NP, bs, Hkv);
    the MLA form's operands come in their pairs (v_scales only with
    v_pages, q2 with k2_pages), as the JAX kernel asserts."""
    pages = torch.zeros(NB + 1, BS, HKV, D, dtype=kw.get("pages",
                                                        torch.int8))
    scales = torch.zeros(kw.get("scale_shape", (NB + 1, BS, HKV)),
                         dtype=kw.get("scale_dtype", torch.float16))
    args = dict(k_scales=scales if "k_scales" in kw else None,
                v_scales=scales if "v_scales" in kw else None)
    if kw.get("q2"):
        args["q2"] = torch.zeros(1, 1, H, 4)
    with pytest.raises(err, match=match):
        paged_decode_attention(
            torch.zeros(1, 1, H, D), pages, None if kw.get("v_none")
            else pages, torch.zeros((1, MB), dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), sm_scale=1.0, **args)


@pytest.fixture(scope="module")
def layer():
    cfg = ASSIGNED["qwen3-0.6b"].reduced()
    jparams = jbuild(cfg).init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              get_config("qwen3-0.6b").reduced(),
                              device="cpu")
    return (cfg, jax.tree.map(lambda a: a[0], jparams["layers0"]["attn"]),
            tparams["layers0"][0]["attn"])


@pytest.mark.parametrize("paged_impl", ["fused", "ref"])
@pytest.mark.parametrize("chunk", [1, 4, 5])
def test_gqa_decode_int8_matches_jax(layer, paged_impl, chunk):
    """f32 activations (no bf16 rounding): the step's quantize-on-insert
    writes the JAX package's codes and scales, and its outputs agree at
    FP32_TOL, on the fused and on the ref path."""
    cfg, jp, tp = layer
    rng = np.random.RandomState(17 + chunk)
    assert cfg.num_kv_heads == HKV
    tables, _, (kq, ks, vq, vs) = _quant_pages(rng, cfg.resolved_head_dim())
    x = rng.randn(B, chunk, cfg.d_model).astype(np.float32)
    pos = np.array([5, 9, 2], np.int32)
    lens = np.array([chunk, max(chunk - 2, 1), chunk], np.int32)
    jcache = {"k": {"q": jnp.asarray(kq), "s": jnp.asarray(ks)},
              "v": {"q": jnp.asarray(vq), "s": jnp.asarray(vs)}}
    oj, cj = jattn.gqa_decode(jp, cfg, jnp.asarray(x), jnp.asarray(pos),
                              jcache, block_tables=jnp.asarray(tables),
                              lengths=jnp.asarray(lens),
                              paged_impl=paged_impl)
    tcache = {"k": {"q": _t(kq), "s": _t(ks)},
              "v": {"q": _t(vq), "s": _t(vs)}}
    ot, ct = tattn.gqa_decode(tp, cfg, _t(x), _t(pos), tcache,
                              block_tables=_t(tables), lengths=_t(lens),
                              paged_impl=paged_impl)
    for leaf in ("k", "v"):
        np.testing.assert_array_equal(ct[leaf]["q"].numpy(),
                                      np.asarray(cj[leaf]["q"]))
        np.testing.assert_array_equal(
            ct[leaf]["s"].numpy().view(np.uint16),
            np.asarray(cj[leaf]["s"]).view(np.uint16))
    oj = np.asarray(oj)
    for b, n in enumerate(lens):
        np.testing.assert_allclose(ot[b, :n].numpy(), oj[b, :n], **FP32_TOL)


@pytest.fixture(scope="module")
def int8_runs():
    return serve_both("q8_0", kv_quant="int8")


def test_int8_serve_tokens_up_to_near_ties(int8_runs):
    check_tokens_up_to_near_ties(int8_runs)


def test_int8_serve_traces_equal(int8_runs):
    assert int8_runs["jrep"].sched.preemptions > 0     # the arena was tight
    check_traces_equal(int8_runs)


def test_int8_serve_ledger_exact(int8_runs):
    check_ledger_exact(int8_runs)
    assert int8_runs["trep"].stats.cache_bytes == \
        int8_runs["jrep"].stats.cache_bytes


@pytest.fixture(scope="module")
def models():
    cfg = ASSIGNED["qwen3-0.6b"].reduced()
    return jbuild(cfg), build_model(get_config("qwen3-0.6b").reduced())


def test_int8_arena_layout_and_bytes_match_jax(models):
    jmodel, tmodel = models
    kw = dict(num_blocks=ENGINE["num_blocks"], kv_quant="int8")
    ja = JaxPagedArena(jmodel, 2, 16, 4, **kw)
    ta = PagedKVArena(tmodel, 2, 16, 4, device="cpu", **kw)
    assert ta.page_layout()["kv_quant"] == "int8"
    assert ta.page_layout() == {k: v for k, v in ja.page_layout().items()
                                if k in ta.page_layout()}
    for name, group in ja.buffers.items():
        for k, leaf in group.items():
            for part in ("q", "s"):
                t = ta.buffers[name][k][part]
                assert tuple(t.shape) == leaf[part].shape
                assert str(t.dtype).split(".")[-1] == leaf[part].dtype.name
    assert ta.nbytes() == ja.nbytes()
    assert ta.block_bytes() == ja.block_bytes()
    assert ta.token_bytes() == ja.token_bytes()
    bf16 = PagedKVArena(tmodel, 2, 16, 4, num_blocks=ENGINE["num_blocks"],
                        device="cpu")
    hd = tmodel.cfg.resolved_head_dim()
    assert ta.block_bytes() / bf16.block_bytes() == \
        pytest.approx((hd + 2) / (2 * hd))


def test_paged_cache_shapes_int8_match_jax_specs(models):
    jmodel, tmodel = models
    specs = jmodel.paged_decode_specs(2, 8, 4, 16, kv_quant="int8")["cache"]
    got = tmodel.paged_cache_shapes(2, 9, 4, kv_quant="int8")
    assert got == jax.tree.map(lambda s: s.shape, specs)


def test_int8_write_prefill_refused(models):
    arena = PagedKVArena(models[1], 1, 16, 4, kv_quant="int8", device="cpu")
    with pytest.raises(NotImplementedError, match="quantize-on-insert"):
        arena.write_prefill({}, 0)


def _model_stub(family):
    return types.SimpleNamespace(cfg=types.SimpleNamespace(family=family))


@pytest.mark.parametrize("kw,match", [
    (dict(block_size=4, kv_quant="int4"), "kv_quant"),
    (dict(block_size=None, kv_quant="int8"), "paged"),
    (dict(block_size=4, kv_quant="int8", family="ssm"), "recurrent"),
    (dict(block_size=4, kv_quant="int8", family="hybrid"), "recurrent"),
    (dict(block_size=4, kv_quant="int8", family="encdec"), "encoder"),
])
def test_engine_kv_quant_refusals(models, kw, match):
    """The JAX engine's kv_quant checks, one per refusal (families the
    port cannot build yet are stood in for by a stub model)."""
    family = kw.pop("family", None)
    model = models[1] if family is None else _model_stub(family)
    with pytest.raises(ValueError, match=match):
        ServingEngine(model, {}, num_slots=1, max_seq=16, device="cpu",
                      **kw)


def _args(**over):
    d = dict(arch="qwen3-0.6b", mode="stream", chunk_size=8, block_size=4,
             num_blocks=0, paged_attn=None, spec="off", spec_k=None,
             spec_draft_model=None, kv_quant="int8", prefix_cache=False,
             shared_prefix=0, dp=1, tp=1)
    d.update(over)
    return argparse.Namespace(**d)


@pytest.mark.parametrize("over,msg", [
    (dict(block_size=0), "--kv-quant requires the paged arena"),
    (dict(mode="batch"), "--kv-quant requires --mode stream"),
    (dict(arch="mamba2-1.3b"), "recurrent state is a running summary"),
    (dict(arch="jamba-v0.1-52b"), "recurrent state is a running summary"),
    (dict(arch="whisper-small"), "one-time encoder pass"),
])
def test_cli_kv_quant_refusals(over, msg, capsys):
    ap = argparse.ArgumentParser(prog="serve")
    with pytest.raises(SystemExit):
        tserve.validate_args(ap, _args(**over))
    assert msg in capsys.readouterr().err


def test_cli_kv_quant_passes():
    ap = argparse.ArgumentParser(prog="serve")
    tserve.validate_args(ap, _args(kv_quant="none", block_size=0))
    tserve.validate_args(ap, _args())      # int8 + paged + stream is fine


def test_cli_int8_serve_runs_on_cpu(capsys):
    tserve.main(["--reduced", "--device", "cpu", "--quant", "q8_0",
                 "--block-size", "4", "--kv-quant", "int8", "--requests",
                 "3", "--slots", "2", "--prompt-len", "8", "--gen", "3",
                 "--arrival", "back2back"])
    out = capsys.readouterr().out
    assert "kv=int8" in out and "completed 3/3" in out
