"""Port vs JAX package: the MoE FFN and granite-moe (reduced widths) on
the CPU.

* ``moe_apply`` at ``capacity_factor=1.25`` with enough tokens that
  experts overflow and drop assignments: the tokens dispatched to every
  (expert, capacity) slot are identical — the port's dispatched rows
  equal, bit for bit, the rows the JAX function hands its expert product
  (read by wrapping its ``jnp.einsum``) — and the outputs agree within
  the bf16 bound below; exact router ties go to the lowest expert index
  first, as ``lax.top_k`` does.
* ``quantize_params`` turns the expert banks into the JAX package's
  (E, out, packed) planes bit for bit and keeps the router unquantized;
  ``params_from_jax`` carries the MoE tree; ``moe_init`` draws its banks
  a group of experts at a time into the same layout.
* The whole reduced granite-moe: forward, prefill and decode logits within
  ``LOGIT_TOL`` (tests/test_torch_model.py), and a paged serve stream on
  bf16 and int8 pages through both ``ServingEngine``s: greedy tokens equal
  up to near-ties, allocator traces and ``breakdown()`` exactly equal
  (tests/test_torch_serving.py's harness).

The MoE output bound: both packages multiply bf16 weights by bf16
activations and round each expert product to bf16, possibly in another
summation order, so an element may land one bf16 ulp away: outputs agree
within 2^-8 of max |out| (one bf16 ulp of the largest element; measured
0 on this CPU).

Near-ties: with bf16 activations a token whose k-th and (k+1)-th router
probabilities are within bf16 noise may go to another expert in the two
packages, and its row (and, through attention, the later rows of its
sequence) then differs by O(1). The full-sequence test records both
packages' expert choices and exempts the rows after such a flip only
when the port's margin there is below ``NEAR_TIE``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.registry import ASSIGNED  # noqa: E402
from repro.core import convert as jconvert  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.api import build_model as jbuild  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.convert import (params_from_jax,  # noqa: E402
                                      quantize_params)
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from test_torch_serving import (check_ledger_exact,  # noqa: E402
                                check_tokens_up_to_near_ties,
                                check_traces_equal, serve_both)

ARCH = "granite-moe-3b-a800m"
LOGIT_TOL = 2.5e-2
MOE_TOL = 2.0 ** -8
NEAR_TIE = 5e-3       # k-th vs (k+1)-th router probability


def _t(a) -> torch.Tensor:
    """numpy (incl. ml_dtypes bf16) -> torch, bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a.view(np.uint16))).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _moe_cfg(arch, cf=1.25):
    """The reduced config at the full models' capacity factor (the
    reduced default, 4.0, never drops)."""
    cfg = ASSIGNED[arch].reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))
    tcfg = get_config(arch).reduced()
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=cf))
    return cfg, tcfg


class _EinsumSpy:
    """Stands in for ``jnp`` inside ``repro.models.moe``: records the
    dispatched rows its first expert product receives."""

    def __init__(self, seen):
        self.seen = seen

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *ops, **kw):
        if spec == "ecd,efd->ecf" and not self.seen:
            self.seen.append(np.asarray(ops[0]))
        return jnp.einsum(spec, *ops, **kw)


def _both_moe(monkeypatch, arch, fmt, x, router=None, seed=0):
    """``router``: None, "zero" (all ties) or "skew" (expert 0 favoured
    by every row of ``x``, whose features all lean positive)."""
    cfg, tcfg = _moe_cfg(arch)
    jp = jax.jit(lambda key: jmoe.moe_init(key, cfg, fmt))(
        jax.random.PRNGKey(seed))
    if router == "zero":
        jp["router"]["w"] = jnp.zeros_like(jp["router"]["w"])
    elif router == "skew":
        jp["router"]["w"] = jp["router"]["w"].at[0].add(0.02)
    tp = params_from_jax({"ffn": jax.tree.map(np.asarray, jp)}, tcfg,
                         device="cpu")["ffn"]
    seen = []
    monkeypatch.setattr(jmoe, "jnp", _EinsumSpy(seen))
    oj, aux_j = jmoe.moe_apply(jp, cfg, jnp.asarray(x), fmt=fmt)
    monkeypatch.undo()
    ot, aux_t = tmoe.moe_apply(tp, tcfg, _t(np.asarray(x)), fmt=fmt)
    xt = _t(np.asarray(x)).reshape(-1, cfg.d_model)
    dispatch, _, token_slots, _, _, cap = tmoe.route(tp, tcfg, xt)
    rows = torch.cat([xt, torch.zeros_like(xt[:1])])[dispatch]
    xe = rows.reshape(cfg.moe.num_experts, cap, -1).to(torch.bfloat16)
    return dict(cfg=cfg, oj=np.asarray(jnp.asarray(oj, jnp.float32)),
                ot=ot.float().numpy(), aux=(float(aux_j), float(aux_t)),
                jax_xe=seen[0], xe=xe, dispatch=dispatch.numpy(),
                token_slots=token_slots.numpy(), t=xt.shape[0])


@pytest.mark.parametrize("fmt", ["none", "q8_0"])
@pytest.mark.parametrize("arch", [ARCH, "deepseek-v3-671b"])
def test_moe_apply_matches_jax_with_drops(monkeypatch, arch, fmt):
    """48 tokens x top-2 over 4 experts at capacity 30 per expert, the
    router skewed towards expert 0, which takes more than 30 assignments:
    the later ones drop. deepseek-v3 adds its shared expert."""
    rng = np.random.RandomState(11)
    x = jnp.asarray(rng.randn(4, 12, 128).astype(np.float32) + 0.5,
                    jnp.bfloat16)
    r = _both_moe(monkeypatch, arch, fmt, x, router="skew")
    k = r["cfg"].moe.num_experts_per_tok
    kept = int((r["dispatch"] < r["t"]).sum())
    assert kept < r["t"] * k                        # assignments dropped
    np.testing.assert_array_equal(r["xe"].view(torch.uint16).numpy(),
                                  np.asarray(r["jax_xe"]).view(np.uint16))
    assert (np.sort(r["token_slots"], axis=1) == r["token_slots"]).all()
    scale = np.abs(r["oj"]).max()
    assert np.abs(r["ot"] - r["oj"]).max() <= MOE_TOL * scale
    np.testing.assert_allclose(r["aux"][1], r["aux"][0], rtol=1e-5)


def test_router_ties_go_to_the_lowest_expert(monkeypatch):
    """A zero router gives every expert probability 1/E: ``lax.top_k``
    picks experts 0..k-1 for every token, and so must the port."""
    rng = np.random.RandomState(12)
    x = jnp.asarray(rng.randn(2, 10, 128).astype(np.float32), jnp.bfloat16)
    r = _both_moe(monkeypatch, ARCH, "none", x, router="zero")
    k, e = r["cfg"].moe.num_experts_per_tok, r["cfg"].moe.num_experts
    cap = r["xe"].shape[1]
    used = sorted({int(s) // cap for s in r["token_slots"].ravel()
                   if s < e * cap})
    assert used == list(range(k))
    np.testing.assert_array_equal(r["xe"].view(torch.uint16).numpy(),
                                  np.asarray(r["jax_xe"]).view(np.uint16))
    assert np.abs(r["ot"] - r["oj"]).max() <= \
        MOE_TOL * np.abs(r["oj"]).max()


def test_quantize_params_banks_and_router_match_jax():
    """The JAX conversion stage on an MoE tree: banks (L, E, out, in) ->
    (L, E, out, packed) planes bit for bit, the router kept unquantized
    (bf16), norms untouched."""
    cfg = ASSIGNED[ARCH].reduced()
    dense = jax.jit(jbuild(cfg).init)(jax.random.PRNGKey(4))
    want = jax.jit(lambda p: jconvert.quantize_params(p, "q8_0"))(dense)
    tcfg = get_config(ARCH).reduced()
    got = quantize_params(params_from_jax(jax.tree.map(np.asarray, dense),
                                          tcfg, device="cpu"), "q8_0")
    ffn_j = want["layers0"]["ffn"]
    for i, lp in enumerate(got["layers0"]):
        for bank in ("gate", "up", "down"):
            for plane, v in ffn_j[bank].items():
                w = np.asarray(v)[i]
                g = lp["ffn"][bank][plane]
                assert tuple(g.shape) == w.shape
                if w.dtype == np.float16:
                    g, w = g.view(torch.int16), w.view(np.int16)
                np.testing.assert_array_equal(g.numpy(), w)
        router = lp["ffn"]["router"]["w"]
        assert router.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            router.view(torch.uint16).numpy(),
            np.asarray(ffn_j["router"]["w"])[i].view(np.uint16))


def test_moe_init_draws_banks_in_expert_groups(monkeypatch):
    """Groups of 3 experts (the bank drawn in pieces) give the layout of
    the JAX ``moe_init``: (E, out, packed) planes, an f32 router and the
    shared expert's SwiGLU."""
    cfg = ASSIGNED["deepseek-v3-671b"].reduced()
    jshapes = jax.eval_shape(lambda k: jmoe.moe_init(k, cfg, "q8_0"),
                             jax.random.PRNGKey(0))
    monkeypatch.setattr(tmoe, "EXPERT_GROUP_ELEMS", 3 * 64 * 128)
    tp = tmoe.moe_init(torch.Generator().manual_seed(0),
                       get_config("deepseek-v3-671b").reduced(), "q8_0")
    flat_j = jax.tree_util.tree_flatten_with_path(jshapes)[0]
    assert len(flat_j) == len(jax.tree.leaves(
        jax.tree.map(lambda a: 0, tp, is_leaf=torch.is_tensor)))
    for path, leaf in flat_j:
        node = tp
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).split(".")[-1] == leaf.dtype.name, path
    assert tp["router"]["w"].dtype == torch.float32
    assert bool((tp["gate"]["d"][-1] != 0).any())   # last group filled


# ----------------------------------------------------------------------
# The whole reduced granite-moe
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
        if n == 0:
            continue
        err = np.abs(lt[b, :n] - lj[b, :n]).max()
        assert err <= LOGIT_TOL * scale, (b, err, scale)


def test_params_from_jax_carries_the_moe_tree(model):
    cfg, jparams, _, tparams = model
    assert len(tparams["layers0"]) == cfg.num_layers
    ffn = tparams["layers0"][2]["ffn"]
    e = cfg.moe.num_experts
    assert tuple(ffn["gate"]["qs"].shape) == (e, cfg.moe.moe_d_ff,
                                              cfg.d_model)
    assert tuple(ffn["down"]["d"].shape) == (e, cfg.d_model,
                                             cfg.moe.moe_d_ff // 32)
    np.testing.assert_array_equal(
        ffn["up"]["qs"].numpy(),
        np.asarray(jparams["layers0"]["ffn"]["up"]["qs"])[2])
    np.testing.assert_array_equal(
        ffn["router"]["w"].view(torch.uint16).numpy(),
        np.asarray(jparams["layers0"]["ffn"]["router"]["w"])[2]
        .view(np.uint16))


def _expert_choices(monkeypatch, run_jax, run_port, k):
    """Run both packages while recording every MoE layer's top-k expert
    sets; returns (results, [(JAX sets (t, k), port sets, port margins
    between the k-th and (k+1)-th probability)] per layer)."""
    jsets, tsets = [], []
    top_k = jax.lax.top_k

    def spy_top_k(x, kk):
        v, i = top_k(x, kk)
        jax.debug.callback(lambda a: jsets.append(np.sort(np.asarray(a))), i)
        return v, i
    route = tmoe.route

    def spy_route(p, cfg, xt):
        probs = torch.softmax(tmoe.layers.linear_apply(
            p["router"], xt.to(torch.float32), "none"), dim=-1)
        srt = torch.sort(probs, dim=-1, descending=True, stable=True)
        tsets.append((np.sort(srt.indices[:, :k].numpy()),
                      (srt.values[:, k - 1] - srt.values[:, k]).numpy()))
        return route(p, cfg, xt)
    monkeypatch.setattr(jax.lax, "top_k", spy_top_k)
    out_j = jax.block_until_ready(run_jax())
    jax.effects_barrier()
    monkeypatch.undo()
    monkeypatch.setattr(tmoe, "route", spy_route)
    out_t = run_port()
    monkeypatch.undo()
    assert len(jsets) == len(tsets)
    return (out_j, out_t), [(j, t, m) for j, (t, m) in zip(jsets, tsets)]


@pytest.mark.parametrize("entry", ["forward", "prefill"])
def test_full_sequence_logits_match_jax(monkeypatch, model, entry):
    """Logits within LOGIT_TOL, except the positions of a sequence at and
    after a token routed differently at a near-tie (see the module
    docstring); such flips must be rare."""
    cfg, jparams, tmodel, tparams = model
    b, s = 2, 9
    tok = np.random.RandomState(8).randint(0, cfg.vocab_size, (b, s))
    tok = tok.astype(np.int32)
    jfn = jlm.lm_forward if entry == "forward" else jlm.lm_prefill
    ((lj, extra_j), (lt, extra_t)), layers = _expert_choices(
        monkeypatch,
        lambda: jax.jit(jfn, static_argnums=1, static_argnames="quant")(
            jparams, cfg, {"tokens": jnp.asarray(tok)}, quant="q8_0"),
        lambda: getattr(tmodel, entry)(
            tparams, {"tokens": torch.from_numpy(tok)}, quant="q8_0"),
        cfg.moe.num_experts_per_tok)
    first_flip = np.full(b, s)
    for jset, tset, margin in layers:                   # in layer order
        for tkn in np.nonzero((jset != tset).any(axis=1))[0]:
            row, i = divmod(int(tkn), s)
            if first_flip[row] <= i:
                continue        # downstream of an earlier flip in its row
            assert margin[tkn] < NEAR_TIE, (tkn, margin[tkn])
            first_flip[row] = i
    assert (first_flip < s).sum() <= 1                  # rare
    rows = first_flip if entry == "forward" else (first_flip == s).astype(int)
    assert rows.sum() > 0
    _close_logits(lt, lj, rows=rows)
    if entry == "forward" and (first_flip == s).all():
        np.testing.assert_allclose(float(extra_t), float(extra_j),
                                   rtol=1e-4)


@pytest.mark.parametrize("paged_impl", ["fused", "ref"])
def test_decode_step_logits_match_jax(model, paged_impl):
    cfg, jparams, tmodel, tparams = model
    rng = np.random.RandomState(9)
    b, mb, bs = 3, 4, 4
    nb = b * mb
    tables = rng.permutation(nb).reshape(b, mb).astype(np.int32)
    shapes = tmodel.paged_cache_shapes(b, nb + 1, bs)
    hist = {n: {k: (rng.randn(*s) * 0.5).astype(np.float32)
                for k, s in leaves.items()} for n, leaves in shapes.items()}
    tok = rng.randint(0, cfg.vocab_size, (b, 4)).astype(np.int32)
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
