"""Port vs JAX package: the mamba2 (SSD) mixer and the recurrent models,
mamba2 and jamba (reduced widths, CPU).

The same numpy-seeded inputs and parameters go through the JAX package's
``repro.models.ssm`` and the port's ``repro_torch.models.ssm``; model
parameters are carried across by ``params_from_jax``.

Tolerances, with their reasons:

* The mixer's functions in f32 (``_causal_conv``, ``ssd_chunked``,
  ``ssm_apply``, the one-token ``ssm_decode`` and the chunk path with
  ragged ``lengths``): rtol = atol = 2e-5, the f32 matmul tolerance of
  ``tests/test_kernels.py`` — the sums run in another order (oneDNN vs
  XLA/Eigen), nothing rounds to bf16.
* The port's chunk recurrence against its own one-token steps (from the
  same in_proj rows: the CPU's f32 matmul sums a row in an order that
  depends on how many rows it is given), and a padded tail against the
  state before the step: bit for bit.
* Whole models: activations are bf16 in both packages, so logits agree
  within ``LOGIT_TOL`` = 2.5e-2 of max |logit| (``test_torch_model.py``);
  the quantized planes of the same dense weights are equal exactly. The
  JAX side is compiled with XLA's ``xla_allow_excess_precision`` off
  (``EXACT_ROUNDING``): by default XLA drops a compiled block's bf16
  round trips, and over jamba's 8 random layers that alone moves its
  logits by ~3 % of max |logit| (against this port and against the same
  JAX functions run op by op, which agree with each other within 2^-6).
  With the option off the JAX package rounds where the model says, as
  when run op by op, and the bound holds with room.
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
from repro.models import ssm as jssm  # noqa: E402
from repro.models.api import build_model as jbuild  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import convert as tconvert  # noqa: E402
from repro_torch.core.convert import params_from_jax  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from test_torch_moe import NEAR_TIE, _expert_choices  # noqa: E402

F32_TOL = dict(rtol=2e-5, atol=2e-5)
LOGIT_TOL = 2.5e-2
# XLA compiler options under which a compiled JAX step keeps every bf16
# rounding the model writes (see the module docstring).
EXACT_ROUNDING = {"xla_allow_excess_precision": False}
ARCHS = ["mamba2-1.3b", "jamba-v0.1-52b"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: beside other test workers a thread pool per
    process slows these small ops by far more than it gains."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    """numpy / JAX array (incl. bf16) -> torch, bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a.view(np.uint16))).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _n(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _cfg(groups: int = 1):
    """The reduced mamba2 mixer (d 128, 8 heads of 32, N 16); ``groups``
    > 1 broadcasts B/C groups over the heads."""
    tcfg = get_config("mamba2-1.3b").reduced()
    jcfg = ASSIGNED["mamba2-1.3b"].reduced()
    if groups > 1:
        tcfg = dataclasses.replace(tcfg, ssm=dataclasses.replace(
            tcfg.ssm, n_groups=groups))
        jcfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(
            jcfg.ssm, n_groups=groups))
    return jcfg, tcfg


def _mixer_params(cfg, seed=0):
    """(JAX params, the same in torch): numpy-seeded, with non-trivial
    A_log, D, dt_bias and conv bias; linears f32 (the f32 tests)."""
    s, d = cfg.ssm, cfg.d_model
    di, nh = s.d_inner(d), s.n_heads(d)
    conv_dim = di + 2 * s.n_groups * s.d_state
    r = np.random.RandomState(seed)
    f = np.float32
    npar = {
        "in_proj": {"w": (r.randn(2 * di + 2 * s.n_groups * s.d_state + nh,
                                  d) * d ** -0.5).astype(f)},
        "conv_w": (r.randn(s.conv_kernel, conv_dim) * 0.2).astype(f),
        "conv_b": (r.randn(conv_dim) * 0.1).astype(f),
        "A_log": (r.randn(nh) * 0.5).astype(f),
        "D": (1 + r.randn(nh) * 0.1).astype(f),
        "dt_bias": (r.randn(nh) * 0.5).astype(f),
        "norm": {"g": (1 + r.randn(di) * 0.1).astype(f)},
        "out_proj": {"w": (r.randn(d, di) * di ** -0.5).astype(f)},
    }
    jp = jax.tree.map(jnp.asarray, npar)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), npar)
    return jp, tp


def _state(cfg, b, seed=1):
    """A random carried state: conv window and SSM state, f32."""
    s, d = cfg.ssm, cfg.d_model
    di, nh = s.d_inner(d), s.n_heads(d)
    conv_dim = di + 2 * s.n_groups * s.d_state
    r = np.random.RandomState(seed)
    return {"conv": r.randn(b, s.conv_kernel - 1, conv_dim).astype(
                np.float32),
            "ssm": (r.randn(b, nh, s.d_state, s.head_dim) * 0.5).astype(
                np.float32)}


def _tstate(st):
    return {k: torch.from_numpy(v.copy()) for k, v in st.items()}


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    r = np.random.RandomState(2)
    x = r.randn(3, 9, 40).astype(np.float32)
    w = (r.randn(4, 40) * 0.3).astype(np.float32)
    b = r.randn(40).astype(np.float32)
    st = r.randn(3, 3, 40).astype(np.float32) if with_state else None
    yj, sj = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               state=None if st is None else jnp.asarray(st))
    yt, stt = tssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(b),
                                state=None if st is None
                                else torch.from_numpy(st))
    np.testing.assert_allclose(_n(yt), np.asarray(yj), **F32_TOL)
    np.testing.assert_array_equal(_n(stt), np.asarray(sj))


@pytest.mark.parametrize("l,chunk,groups", [(32, 16, 1), (40, 16, 1),
                                            (21, 8, 2)])
def test_ssd_chunked_matches_jax(l, chunk, groups):
    """Whole chunks, a padded last chunk, and B/C groups over heads."""
    r = np.random.RandomState(3)
    b, h, p, n = 2, 4, 8, 6
    x = r.randn(b, l, h, p).astype(np.float32)
    dt = np.log1p(np.exp(r.randn(b, l, h))).astype(np.float32)
    a = -np.exp(r.randn(h) * 0.5).astype(np.float32)
    bm = r.randn(b, l, groups, n).astype(np.float32)
    cm = r.randn(b, l, groups, n).astype(np.float32)
    yj, sj = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, a, bm, cm)), chunk)
    yt, st = tssm.ssd_chunked(*map(torch.from_numpy, (x, dt, a, bm, cm)),
                              chunk)
    assert yt.dtype == st.dtype == torch.float32
    np.testing.assert_allclose(_n(yt), np.asarray(yj), **F32_TOL)
    np.testing.assert_allclose(_n(st), np.asarray(sj), **F32_TOL)


@pytest.mark.parametrize("groups", [1, 2])
def test_ssm_apply_with_state_matches_jax(groups):
    jcfg, tcfg = _cfg(groups)
    jp, tp = _mixer_params(tcfg)
    u = np.random.RandomState(4).randn(2, 45, tcfg.d_model).astype(
        np.float32)                   # 45: a ragged chunk of 32
    oj, cj = jssm.ssm_apply(jp, jcfg, jnp.asarray(u), return_state=True)
    ot, ct = tssm.ssm_apply(tp, tcfg, torch.from_numpy(u), return_state=True)
    np.testing.assert_allclose(_n(ot), np.asarray(oj), **F32_TOL)
    np.testing.assert_allclose(_n(ct["conv"]), np.asarray(cj["conv"]),
                               **F32_TOL)
    assert ct["ssm"].dtype == torch.float32
    np.testing.assert_allclose(_n(ct["ssm"]), np.asarray(cj["ssm"]),
                               **F32_TOL)


def test_ssm_decode_one_token_matches_jax():
    jcfg, tcfg = _cfg()
    jp, tp = _mixer_params(tcfg)
    st = _state(tcfg, 3)
    u = np.random.RandomState(5).randn(3, 1, tcfg.d_model).astype(np.float32)
    oj, cj = jssm.ssm_decode(jp, jcfg, jnp.asarray(u),
                             jax.tree.map(jnp.asarray, st))
    tcache = _tstate(st)
    ot, ct = tssm.ssm_decode(tp, tcfg, torch.from_numpy(u), tcache)
    assert ct is tcache                               # written in place
    np.testing.assert_allclose(_n(ot), np.asarray(oj), **F32_TOL)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(_n(ct[k]), np.asarray(cj[k]), **F32_TOL)


@pytest.mark.parametrize("groups", [1, 2])
def test_ssm_decode_chunk_ragged_matches_jax(groups):
    """A chunk of 5 with ragged valid lengths (a full row, a partial one
    and an idle one): the valid rows' outputs and every row's state."""
    jcfg, tcfg = _cfg(groups)
    jp, tp = _mixer_params(tcfg)
    st = _state(tcfg, 3)
    u = np.random.RandomState(6).randn(3, 5, tcfg.d_model).astype(np.float32)
    lens = np.array([5, 2, 0], np.int32)
    oj, cj = jssm.ssm_decode(jp, jcfg, jnp.asarray(u),
                             jax.tree.map(jnp.asarray, st),
                             lengths=jnp.asarray(lens))
    ot, ct = tssm.ssm_decode(tp, tcfg, torch.from_numpy(u), _tstate(st),
                             lengths=torch.from_numpy(lens))
    for b, n in enumerate(lens):
        np.testing.assert_allclose(_n(ot[b, :n]), np.asarray(oj[b, :n]),
                                   **F32_TOL)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(_n(ct[k]), np.asarray(cj[k]), **F32_TOL)


@pytest.mark.parametrize("groups", [1, 2])
def test_chunk_path_equals_one_token_steps_exactly(groups):
    """The recurrence of one chunk of 4 against 4 one-token steps from
    the same state and the same in_proj rows: the same outputs and the
    same state, bit for bit."""
    _, tcfg = _cfg(groups)
    _, tp = _mixer_params(tcfg)
    st = _state(tcfg, 2)
    u = torch.from_numpy(np.random.RandomState(7).randn(
        2, 4, tcfg.d_model).astype(np.float32))
    rows = tssm.layers.linear_apply(tp["in_proj"], u)
    cc = _tstate(st)
    zc, yc = tssm._recur(tp, tcfg, rows, cc, None)
    cs = _tstate(st)
    steps = [tssm._recur(tp, tcfg, rows[:, t:t + 1], cs, None)
             for t in range(4)]
    assert torch.equal(yc, torch.cat([y for _, y in steps], dim=1))
    assert torch.equal(zc, torch.cat([z for z, _ in steps], dim=1))
    for k in ("conv", "ssm"):
        assert torch.equal(cc[k], cs[k]), k


def test_padded_tail_leaves_state_unchanged():
    """A row's state advances only through its valid prefix: an idle row
    (length 0) keeps every bit of its state, and a row with 2 of 4
    entries valid ends exactly where a 2-wide chunk of the same tokens
    ends."""
    _, tcfg = _cfg()
    _, tp = _mixer_params(tcfg)
    st = _state(tcfg, 2)
    u = torch.from_numpy(np.random.RandomState(8).randn(
        2, 4, tcfg.d_model).astype(np.float32))
    _, padded = tssm.ssm_decode(tp, tcfg, u, _tstate(st),
                                lengths=torch.tensor([2, 0]))
    rows = tssm.layers.linear_apply(tp["in_proj"], u)
    padded_rows, short = _tstate(st), _tstate(st)
    tssm._recur(tp, tcfg, rows, padded_rows, torch.tensor([2, 0]))
    tssm._recur(tp, tcfg, rows[:, :2], short, None)
    for k in ("conv", "ssm"):
        assert torch.equal(padded_rows[k][0], short[k][0]), k
        assert torch.equal(padded[k][0], short[k][0]), k
        assert torch.equal(padded[k][1], torch.from_numpy(st[k][1])), k


# ----------------------------------------------------------------------
# Whole models: mamba2 and jamba, reduced
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    """(arch, quant) -> (JAX cfg, JAX params, port cfg, port params)."""
    made = {}

    def get(arch, quant):
        if (arch, quant) not in made:
            cfg = ASSIGNED[arch].reduced()
            jparams = jax.jit(lambda key: jconvert.quantize_params(
                jbuild(cfg).init(key), quant))(jax.random.PRNGKey(0))
            tcfg = get_config(arch).reduced()
            tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")
            made[(arch, quant)] = (cfg, jparams, tcfg, tparams)
        return made[(arch, quant)]
    return get


def _close_logits(lt, lj, rows=None):
    lt, lj = lt.float().numpy(), np.asarray(lj.astype(jnp.float32))
    assert lt.shape == lj.shape
    scale = np.abs(lj).max()
    if rows is None:
        err = np.abs(lt - lj).max()
    else:
        err = max(np.abs(lt[b, :n] - lj[b, :n]).max()
                  for b, n in enumerate(rows) if n)
    assert np.isfinite(lt).all() and err <= LOGIT_TOL * scale, (err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_carries_ssm_and_hybrid_stacks(models, arch):
    cfg, jparams, tcfg, tparams = models(arch, "q8_0")
    assert set(tparams) == set(jparams)
    (name, count, subs), = [g for g in jlm.layer_groups(cfg)
                            if any(m == "ssm" for m, _ in g[2])]
    assert len(tparams[name]) == count
    j_layer = jparams[name] if len(subs) == 1 else jparams[name]["sub0"]
    t_layer = tparams[name][0] if len(subs) == 1 else tparams[name][0]["sub0"]
    for k in ("conv_w", "conv_b", "A_log", "D", "dt_bias"):
        assert t_layer["ssm"][k].dtype == torch.float32
        np.testing.assert_array_equal(t_layer["ssm"][k].numpy(),
                                      np.asarray(j_layer["ssm"][k][0]))
    np.testing.assert_array_equal(
        t_layer["ssm"]["in_proj"]["qs"].numpy(),
        np.asarray(j_layer["ssm"]["in_proj"]["qs"][0]))


@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_params_planes_equal_jax(models, arch):
    """The same dense weights quantized by both packages: every plane
    equal bit for bit; the SSM's conv taps, A_log, D and dt_bias and the
    norms untouched."""
    cfg, dense_j, tcfg, dense_t = models(arch, "none")
    qj = jax.tree.map(np.asarray, jconvert.quantize_params(dense_j, "q8_0"))
    qt = tconvert.quantize_params(dense_t, "q8_0")
    expect = params_from_jax(qj, tcfg, device="cpu")
    flat_t = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.view(torch.uint16).numpy()
                     if t.dtype == torch.bfloat16 else t.numpy(), qt))[0]
    flat_e = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.view(torch.uint16).numpy()
                     if t.dtype == torch.bfloat16 else t.numpy(),
                     expect))[0])
    assert len(flat_t) == len(flat_e)
    for path, leaf in flat_t:
        np.testing.assert_array_equal(leaf, flat_e[path],
                                      err_msg=jax.tree_util.keystr(path))
    lay = qt["layers0"][0] if arch == "mamba2-1.3b" else \
        qt["blocks"][0]["sub0"]
    assert set(lay["ssm"]["in_proj"]) == {"qs", "d"}
    assert lay["ssm"]["conv_w"] is (dense_t["layers0"][0] if arch ==
                                    "mamba2-1.3b" else
                                    dense_t["blocks"][0]["sub0"])["ssm"][
        "conv_w"]


@pytest.mark.parametrize("entry", ["forward", "prefill"])
@pytest.mark.parametrize("quant", ["none", "q8_0"])
@pytest.mark.parametrize("arch", ARCHS)
def test_full_sequence_logits_match_jax(monkeypatch, models, arch, quant,
                                        entry):
    """Logits within LOGIT_TOL, except — jamba's MoE layers — the
    positions of a sequence at and after a token routed differently at a
    near-tie (``test_torch_moe.py``'s rule; such flips must be rare).
    The prefill's caches come back in the JAX layout, the SSM state f32
    and the conv window bf16."""
    cfg, jparams, tcfg, tparams = models(arch, quant)
    b, s = 2, 37                      # 37: a ragged SSD chunk of 32
    tok = np.random.RandomState(9).randint(0, cfg.vocab_size, (b, s)).astype(
        np.int32)
    jfn = jlm.lm_forward if entry == "forward" else jlm.lm_prefill
    model = build_model(tcfg)

    def run_jax():
        return jax.jit(jfn, static_argnums=1, static_argnames="quant",
                       compiler_options=EXACT_ROUNDING)(
            jparams, cfg, {"tokens": jnp.asarray(tok)}, quant=quant)
    ((lj, extra_j), (lt, extra_t)), layers = _expert_choices(
        monkeypatch, run_jax,
        lambda: getattr(model, entry)(tparams, {"tokens": _t(tok)},
                                      quant=quant),
        cfg.moe.num_experts_per_tok if cfg.moe is not None else 1)
    first_flip = np.full(b, s)
    for jset, tset, margin in layers:                   # in layer order
        for tkn in np.nonzero((jset != tset).any(axis=1))[0]:
            row, i = divmod(int(tkn), s)
            if first_flip[row] <= i:
                continue        # downstream of an earlier flip in its row
            assert margin[tkn] < NEAR_TIE, (tkn, margin[tkn])
            first_flip[row] = i
    assert (first_flip < s).sum() <= 1                  # rare
    if entry == "forward":
        _close_logits(lt, lj, rows=first_flip)
        if (first_flip == s).all():
            np.testing.assert_allclose(float(extra_t), float(extra_j),
                                       rtol=1e-3, atol=1e-6)
        return
    _close_logits(lt, lj, rows=(first_flip == s).astype(int))
    got = jax.tree.map(lambda t: tuple(t.shape), extra_t)
    assert got == jax.tree.map(lambda a: tuple(a.shape), extra_j)
    for path, t in jax.tree_util.tree_flatten_with_path(extra_t)[0]:
        key = jax.tree_util.keystr(path)
        if key.endswith("['ssm']"):
            assert t.dtype == torch.float32, key
        elif key.endswith("['conv']"):
            assert t.dtype == torch.bfloat16, key


def _decode_caches(cfg, tcfg, b, nb, bs, seed):
    """(JAX cache, port cache) of the same random contents: attention
    leaves paged (layers, nb + 1, bs, Hkv, D) in f32, state leaves per
    slot (layers, b, ...) — conv window bf16, SSM state f32."""
    model = build_model(tcfg)
    shapes = model.paged_cache_shapes(b, nb + 1, bs)
    state = model.state_leaves(b)
    r = np.random.RandomState(seed)

    def mk(s, const):
        a = (r.randn(*s) * 0.5).astype(np.float32)
        return a
    npc = jax.tree.map(mk, shapes, state,
                       is_leaf=lambda x: isinstance(x, tuple))
    flat = jax.tree_util.tree_flatten_with_path(npc)[0]
    jflat, tflat = [], []
    for path, a in flat:
        key = jax.tree_util.keystr(path)
        dt = jnp.bfloat16 if key.endswith("['conv']") else jnp.float32
        ja = jnp.asarray(a, dt)
        jflat.append(ja)
        tflat.append(_t(np.asarray(ja)))
    treedef = jax.tree.structure(npc)
    return (jax.tree.unflatten(treedef, jflat),
            jax.tree.unflatten(treedef, tflat))


@pytest.mark.parametrize("quant", ["none", "q8_0"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(models, arch, quant):
    """One chunked decode step (chunk 4, lengths 4/2/1/0) over paged
    attention pages and per-slot state: the valid rows' logits within
    LOGIT_TOL, and the state the step leaves behind within the same
    share of its scale (it is computed from bf16 activations)."""
    cfg, jparams, tcfg, tparams = models(arch, quant)
    b, c, bs, mb = 4, 4, 4, 4
    nb = b * mb
    jc, tc = _decode_caches(cfg, tcfg, b, nb, bs, seed=10)
    rng = np.random.RandomState(11)
    tables = rng.permutation(nb).reshape(b, mb).astype(np.int32)
    tok = rng.randint(0, cfg.vocab_size, (b, c)).astype(np.int32)
    pos = np.array([0, 5, 9, 3], np.int32)
    lens = np.array([4, 2, 1, 0], np.int32)
    lj, cj = jax.jit(jlm.lm_decode_step, static_argnums=1,
                     static_argnames=("quant", "paged_impl"),
                     compiler_options=EXACT_ROUNDING)(
        jparams, cfg, jnp.asarray(tok), jnp.asarray(pos), jc, quant=quant,
        block_tables=jnp.asarray(tables), lengths=jnp.asarray(lens),
        paged_impl="ref")
    lt, ct = build_model(tcfg).decode_step(
        tparams, _t(tok), _t(pos), tc, quant=quant,
        block_tables=_t(tables), lengths=_t(lens), paged_impl="ref")
    assert ct is tc
    _close_logits(lt, lj, rows=lens)
    for (path, a), e in zip(jax.tree_util.tree_flatten_with_path(ct)[0],
                            jax.tree.leaves(cj)):
        key = jax.tree_util.keystr(path)
        e = np.asarray(e, np.float32)
        if key.endswith("['ssm']") or key.endswith("['conv']"):
            assert a.dtype == (torch.float32 if key.endswith("['ssm']")
                               else torch.bfloat16), key
            err = np.abs(_n(a) - e).max()
            assert err <= LOGIT_TOL * np.abs(e).max(), (key, err)
            # The idle row (length 0) keeps its state bit for bit.
            before = jax.tree_util.tree_flatten_with_path(
                _decode_caches(cfg, tcfg, b, nb, bs, seed=10)[1])[0]
            orig = dict((jax.tree_util.keystr(p), t) for p, t in before)[key]
            assert torch.equal(a[:, 3], orig[:, 3]), key
