"""Port vs JAX package: training (the loss, its gradients, one AdamW step,
checkpoints, the elastic runner and the train -> quantize -> serve flow),
at reduced widths on the CPU.

The JAX parameters go into the port through ``params_from_jax`` (numpy in
between); the same numpy inputs go to both. The JAX side is compiled
with ``xla_allow_excess_precision`` off (``EXACT_ROUNDING``): by default
XLA drops the bf16 round trips the model spells out, which alone moves
the gradients 2-3 % per leaf against the same functions run op by op.

Tolerances, with their reasons:

* f32 (the attention's gradient, a dense layer's gradient with f32
  activations and weights, the cross entropy on f32 logits): the same
  products in another summation order, ``F32_TOL`` = rtol/atol 2e-5.
* bf16 (whole models: activations are bf16 in both packages, as
  ``tests/test_torch_model.py`` states): the loss within ``LOSS_TOL`` =
  1e-3 (measured up to 4.3e-4, whisper); each parameter's gradient
  within ``GRAD_LEAF_TOL`` = 4 % of its norm (measured up to 2.1 %) and
  all of them together within ``GRAD_TOL`` = 2 % (measured up to 0.81 %):
  a bf16 gradient holds 8 bits, and one-ulp flips of the activations
  travel through the layers.
* One AdamW step with two microbatches and int8 gradient compression:
  each gradient of two or more dimensions becomes per-tensor codes of
  one step ``u`` = its max |g| / 127, so every element of the port's
  ``m`` must be an integer multiple of its leaf's step (exact, the
  compression's structure), and the codes of elements that differ by
  bf16 rounding may land some steps apart: ``m`` and ``sqrt(v)`` within
  ``STEP_TOL`` = 5 % of the norm over all leaves (measured 2.4 %) and
  ``STEP_LEAF_TOL`` = 20 % per leaf (measured 11.5 %, a deep layer's q
  projection whose small codes flip). ``grad_norm`` within 1 %, ``lr``
  exact. A first AdamW step moves an element by lr x g / (|g| + eps),
  about ±lr, so a code that flips moves its element the other way or
  not at all: every parameter within 2 lr x (1 + weight decay) plus one
  bf16 ulp of JAX's, and at most ``FLIP_SHARE`` = 8 % of elements
  (measured 4.3 %) beyond that ulp.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.core import convert as jconvert  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.api import build_model as jbuild  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.trainer import make_train_step as jmake_step  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.runtime.engine import Engine  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train.data import SyntheticDataset  # noqa: E402
from repro_torch.train.elastic import ElasticRunner, StepMonitor  # noqa: E402
from repro_torch.train.trainer import make_train_step  # noqa: E402

EXACT_ROUNDING = {"xla_allow_excess_precision": False}
F32_TOL = dict(rtol=2e-5, atol=2e-5)
LOSS_TOL = 1e-3
GRAD_LEAF_TOL = 4e-2
GRAD_TOL = 2e-2
STEP_TOL = 5e-2
STEP_LEAF_TOL = 0.2
FLIP_SHARE = 8e-2
FAMILIES = ["qwen3-0.6b", "granite-moe-3b-a800m", "mamba2-1.3b",
            "whisper-small"]


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


def _jcfg(arch):
    from repro.configs.registry import ARCHS
    return ARCHS[arch].reduced()


def _pair(arch, seed=0):
    """(JAX cfg, JAX model, JAX params, port cfg, port params): the same
    reduced weights in both packages."""
    cfg = _jcfg(arch)
    jm = jbuild(cfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tcfg = get_config(arch).reduced()
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return cfg, jm, jp, tcfg, tp


def _batch(cfg, b=2, s=16, seed=0):
    """numpy batch: tokens, labels shifted with a trailing -1, and an
    encoder-decoder model's frames."""
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)
    out = {"tokens": tok,
           "labels": np.concatenate([tok[:, 1:], -np.ones((b, 1), np.int32)],
                                    axis=1)}
    if cfg.family == "encdec":
        out["frames"] = (rng.randn(b, cfg.encoder_seq_len, cfg.d_model)
                         * 0.5).astype(np.float32)
    return out


def _jbatch(batch):
    out = {k: jnp.asarray(v) for k, v in batch.items()}
    if "frames" in out:
        out["frames"] = out["frames"].astype(jnp.bfloat16)
    return out


def _tbatch(jb):
    return {k: _t(v) for k, v in jb.items()}


def _flat_jax(tree, tcfg):
    """The JAX tree (numpy leaves) in the port's layout, flattened."""
    return topt.flatten(params_from_jax(jax.tree.map(np.asarray, tree),
                                        tcfg, device="cpu"))


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """|a - b| / |b| (norms in f64)."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def _check_grads(got, want):
    """Per leaf within GRAD_LEAF_TOL of its norm, all within GRAD_TOL."""
    num = den = 0.0
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        assert _rel(g, w) <= GRAD_LEAF_TOL, (k, _rel(g, w))
        num += float((g.double() - w.double()).norm()) ** 2
        den += float(w.double().norm()) ** 2
    assert (num / den) ** 0.5 <= GRAD_TOL, (num / den) ** 0.5


def _torch_value_and_grad(model, params, batch, **kw):
    leaves = topt.tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = model.loss(leaves, batch, **kw)
    grads = torch.autograd.grad(loss, topt.tree_leaves(leaves))
    it = iter(grads)
    return loss.detach(), topt.flatten(topt.tree_map(lambda _: next(it),
                                                     params))


# ----------------------------------------------------------------------
# Loss and gradients
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_jax(arch):
    """``model.loss`` and its gradient for dense, moe, ssm and encdec
    (bf16 activations in both packages)."""
    cfg, jm, jp, tcfg, tp = _pair(arch)
    jb = _jbatch(_batch(cfg))
    lj, gj = jax.jit(jax.value_and_grad(lambda p, b: jm.loss(p, b)),
                     compiler_options=EXACT_ROUNDING)(jp, jb)
    lt, gt = _torch_value_and_grad(build_model(tcfg), tp, _tbatch(jb))
    assert lt.dtype == torch.float32 and lt.shape == ()
    assert abs(float(lt) - float(lj)) <= LOSS_TOL, (float(lt), float(lj))
    _check_grads(gt, _flat_jax(gj, tcfg))


@pytest.mark.parametrize("causal,q_offset,h,hkv,dv", [
    (True, 0, 16, 1, 8), (True, 3, 4, 2, 12), (False, 0, 3, 3, 8)])
def test_attention_grad_f32_matches_jax(causal, q_offset, h, hkv, dv):
    """``attention_backward`` (B7's backward on the card) and autograd of
    the plain version against ``jax.grad`` of the JAX package's
    ``chunked_attention`` in f32: G = 16, 2 and 1, causal with a query
    offset (and Dv != D) and non-causal."""
    rng = np.random.RandomState(1)
    b, sq, skv, d = 2, 6, 9, 8
    q = rng.randn(b, sq, h, d).astype(np.float32)
    k = rng.randn(b, skv, hkv, d).astype(np.float32)
    v = rng.randn(b, skv, hkv, dv).astype(np.float32)
    do = rng.randn(b, sq, h, dv).astype(np.float32)
    if q_offset:
        skv = sq + q_offset
        k, v = k[:, :skv], v[:, :skv]

    def jloss(q, k, v):
        o = jattn.chunked_attention(q, k, v, causal=causal, sm_scale=0.3,
                                    q_offset=q_offset, kv_chunk=4)
        return jnp.sum(o * do)
    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    got = tfa.attention_backward(_t(q), _t(k), _t(v), _t(do), causal=causal,
                                 sm_scale=0.3, q_offset=q_offset)
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal, sm_scale=0.3,
                              q_offset=q_offset)
    auto = torch.autograd.grad(out, (tq, tk, tv), _t(do))
    for w, g, a in zip(want, got, auto):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_TOL)
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **F32_TOL)


def test_attention_backward_blocks_do_not_change_it(monkeypatch):
    """The query-block walk is exact: one row a block gives the gradient
    of the whole block, Dv != D included."""
    g = torch.Generator().manual_seed(2)
    q, k = torch.randn(2, 7, 4, 8, generator=g), torch.randn(2, 9, 2, 8,
                                                             generator=g)
    v, do = torch.randn(2, 9, 2, 12, generator=g), torch.randn(
        2, 7, 4, 12, generator=g)
    whole = tfa.attention_backward(q, k, v, do, causal=True, sm_scale=0.4,
                                   q_offset=2)
    monkeypatch.setattr(tfa, "BACKWARD_BLOCK_ELEMS", 1)
    rows = tfa.attention_backward(q, k, v, do, causal=True, sm_scale=0.4,
                                  q_offset=2)
    for a, b in zip(whole, rows):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_dense_layer_grad_f32_matches_jax():
    """One dense layer (qwen3: qk-norm, GQA, RoPE, SwiGLU) with f32
    weights and activations: its gradient against ``jax.grad`` of the JAX
    ``layer_apply``, tight."""
    cfg, _, jp, tcfg, tp = _pair("qwen3-0.6b")
    jl = jax.tree.map(lambda a: a[0].astype(jnp.float32), jp["layers0"])
    tl = topt.tree_map(lambda a: a.float(), tp["layers0"][0])
    rng = np.random.RandomState(3)
    h = rng.randn(2, 8, cfg.d_model).astype(np.float32)
    w = rng.randn(2, 8, cfg.d_model).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(8)[None], (2, 8))

    def jloss(lp, h):
        out, _ = jlm.layer_apply(lp, cfg, h, pos, mixer="gqa", ffn="dense",
                                 fmt="none", impl="ref", interpret=True,
                                 kv_chunk=1024)
        return jnp.sum(out * w)
    gj_p, gj_h = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jl, h)
    leaves = topt.tree_map(lambda a: a.detach().requires_grad_(True), tl)
    th = _t(h).requires_grad_(True)
    rope = tlm.attn.rope_tables(tcfg, torch.arange(8)[None].expand(2, 8))
    out, _ = tlm.layer_apply(leaves, tcfg, th, rope, mixer="gqa",
                             ffn="dense", fmt="none")
    grads = torch.autograd.grad((out * _t(w)).sum(),
                                [th] + topt.tree_leaves(leaves))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(gj_h),
                               **F32_TOL)
    want = topt.flatten(jax.tree.map(lambda a: _t(np.asarray(a)), gj_p))
    for (k, g) in zip(topt.flatten(leaves), grads[1:]):
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), **F32_TOL,
                                   err_msg=k)


def test_cross_entropy_f32_matches_jax():
    """The loss head on the same f32 logits: masked mean over labels >= 0,
    and its gradient."""
    rng = np.random.RandomState(4)
    logits = rng.randn(2, 5, 11).astype(np.float32) * 3
    labels = rng.randint(0, 11, (2, 5)).astype(np.int32)
    labels[:, -1] = -1
    labels[1, 0] = -1

    def jce(lf):
        logz = jax.nn.logsumexp(lf, axis=-1)
        gold = jnp.take_along_axis(lf, jnp.asarray(labels)[..., None],
                                   axis=-1)[..., 0]
        mask = (jnp.asarray(labels) >= 0).astype(jnp.float32)
        return jnp.sum((logz - gold) * mask) / jnp.maximum(jnp.sum(mask),
                                                           1.0)
    lj, gj = jax.value_and_grad(jce)(logits)
    tl = _t(logits).requires_grad_(True)
    lt = tlayers.cross_entropy(tl, _t(labels))
    (gt,) = torch.autograd.grad(lt, tl)
    np.testing.assert_allclose(float(lt.detach()), float(lj), **F32_TOL)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **F32_TOL)


@pytest.mark.parametrize("remat", ["full", "dots_saveable"])
def test_remat_changes_nothing(remat):
    """The loss and gradients under a remat policy equal those without
    (the recomputed forward is the same function), for a dense and an
    encoder-decoder model."""
    for arch in ("qwen3-0.6b", "whisper-small"):
        cfg, _, _, tcfg, tp = _pair(arch)
        model = build_model(tcfg)
        tb = _tbatch(_jbatch(_batch(cfg)))
        l0, g0 = _torch_value_and_grad(model, tp, tb)
        l1, g1 = _torch_value_and_grad(model, tp, tb, remat=remat)
        assert torch.equal(l0, l1)
        for k in g0:
            assert torch.equal(g0[k], g1[k]), (arch, remat, k)


def test_loss_refuses_act_sharding_and_unknown_remat():
    """``act_sharding`` (a training mesh's residual placements) changes
    no value off a mesh, as ``with_sharding_constraint`` changes none,
    and the encoder-decoder loss drops it as the JAX package's does; an
    unknown remat policy is refused."""
    from torch.distributed.tensor import Replicate, Shard
    act = (Shard(0), Shard(1))
    for arch in ("whisper-small", "qwen3-0.6b"):
        cfg, _, _, tcfg, tp = _pair(arch)
        tb = _tbatch(_jbatch(_batch(cfg)))
        model = build_model(tcfg)
        assert torch.equal(model.loss(tp, tb, act_sharding=act),
                           model.loss(tp, tb))
    assert torch.equal(model.loss(tp, tb, act_sharding=(Replicate(),)),
                       model.loss(tp, tb))
    with pytest.raises(ValueError, match="remat"):
        model.loss(tp, tb, remat="sometimes")


# ----------------------------------------------------------------------
# One train step
# ----------------------------------------------------------------------
def _step_cfg(cls, remat):
    return cls(learning_rate=1e-3, total_steps=10, warmup_steps=2,
               microbatches=2, remat_policy=remat, grad_compression="int8")


@pytest.fixture(scope="module")
def jax_step():
    """The JAX step (microbatches 2, int8 compression) on reduced qwen3:
    (port cfg, port params, port batch, JAX params, opt state, metrics
    after the step). Remat does not change the JAX function, so the
    port's three policies are held against this one step."""
    cfg, jm, jp, tcfg, tp = _pair("qwen3-0.6b")
    jb = _jbatch(_batch(cfg, b=4, s=16, seed=5))
    step = jax.jit(jmake_step(jm, _step_cfg(JTrainConfig, "none")),
                   compiler_options=EXACT_ROUNDING)
    p1, o1, m1 = step(jp, jopt.adamw_init(jp), jb)
    return tcfg, tp, _tbatch(jb), p1, o1, m1


@pytest.mark.parametrize("remat", ["none", "full", "dots_saveable"])
def test_train_step_matches_jax(jax_step, remat):
    """Parameters, m, v, grad_norm and lr after one AdamW step with two
    microbatches and int8 gradient compression."""
    tcfg, tp, tb, jp1, jo1, jm1 = jax_step
    tc = _step_cfg(TrainConfig, remat)
    step = make_train_step(build_model(tcfg), tc)
    p1, o1, m1 = step(tp, topt.adamw_init(tp), tb)
    assert int(o1["step"]) == int(jo1["step"]) == 1
    assert float(m1["lr"]) == float(jm1["lr"])
    assert abs(float(m1["loss"]) - float(jm1["loss"])) <= LOSS_TOL
    assert abs(float(m1["grad_norm"]) / float(jm1["grad_norm"]) - 1) <= 1e-2
    m_t, m_j = topt.flatten(o1["m"]), _flat_jax(jo1["m"], tcfg)
    v_t, v_j = topt.flatten(o1["v"]), _flat_jax(jo1["v"], tcfg)
    for k, m in m_t.items():
        assert m.dtype == v_t[k].dtype == torch.float32, k
        if m.ndim >= 2:
            codes = m / (float(m.abs().max()) / 127)
            assert float((codes - codes.round()).abs().max()) <= 1e-3, k
    for got, want in ((m_t, m_j),
                      ({k: v.sqrt() for k, v in v_t.items()},
                       {k: v.sqrt() for k, v in v_j.items()})):
        num = den = 0.0
        for k, w in want.items():
            assert _rel(got[k], w) <= STEP_LEAF_TOL, (k, _rel(got[k], w))
            num += float((got[k].double() - w.double()).norm()) ** 2
            den += float(w.double().norm()) ** 2
        assert (num / den) ** 0.5 <= STEP_TOL, (num / den) ** 0.5
    lr, wd = float(jm1["lr"]), tc.weight_decay
    p_t, p_j = topt.flatten(p1), _flat_jax(jp1, tcfg)
    flips = total = 0
    for k, w in p_j.items():
        assert p_t[k].dtype == w.dtype, k
        w = w.double()
        ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - 8)
        d = (p_t[k].double() - w).abs()
        assert bool((d <= 2 * lr * (1 + wd) + ulp).all()), k
        flips += int((d > ulp).sum())
        total += d.numel()
    assert flips <= FLIP_SHARE * total, (flips, total)


def test_quantized_training_raises_type_error():
    """quant="q8_0": the integer code planes cannot take a gradient, in
    JAX and in the port; both raise TypeError before any update."""
    cfg, jm, jp, tcfg, tp = _pair("qwen3-0.6b")
    jq = jconvert.quantize_params(jp, "q8_0")
    jb = _jbatch(_batch(cfg))
    with pytest.raises(TypeError):
        jmake_step(jm, JTrainConfig(), quant="q8_0")(
            jq, jopt.adamw_init(jq), jb)
    tq = convert.quantize_params(tp, "q8_0")
    step = make_train_step(build_model(tcfg), TrainConfig(), quant="q8_0")
    with pytest.raises(TypeError, match="integer leaves"):
        step(tq, topt.adamw_init(tq), _tbatch(jb))


# ----------------------------------------------------------------------
# The trainer's system behaviour (tests/test_engine_trainer.py,
# tests/test_system.py)
# ----------------------------------------------------------------------
def _init(tcfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = build_model(tcfg).init(gen)
    return params, topt.adamw_init(params)


def test_loss_decreases_on_copy_task(tmp_path):
    tcfg = get_config("qwen3-0.6b").reduced()
    model = build_model(tcfg)
    tc = TrainConfig(learning_rate=3e-3, total_steps=30, warmup_steps=3,
                     checkpoint_every=1000,
                     checkpoint_dir=str(tmp_path / "ck"))
    data = SyntheticDataset(tcfg.vocab_size, 32, 4, task="copy", pool=2)
    params, state = _init(tcfg)
    step = make_train_step(model, tc)
    losses = []
    for i in range(30):
        params, state, m = step(params, state, data.batch_at(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.9, losses[:3] + losses[-3:]


def test_checkpoint_roundtrip_and_prune(tmp_path):
    """Every leaf, bf16 and f32 and the int32 step, restores bit for bit;
    the container is read with ``weights_only=True`` and needs no
    msgpack."""
    tcfg = get_config("mamba2-1.3b").reduced()
    params, state = _init(tcfg)
    state["m"] = topt.tree_map(lambda m: m + 0.25, state["m"])
    d = str(tmp_path / "ck")
    for s in (1, 2, 3):
        ckpt.save(d, s, params, state, {"data_step": s})
    ckpt.prune(d, keep=2)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "ckpt_00000002.pt", "ckpt_00000003.pt"]
    assert ckpt.latest_checkpoint(d).endswith("ckpt_00000003.pt")
    torch.load(ckpt.latest_checkpoint(d), weights_only=True)
    step, p2, s2, extra = ckpt.restore(ckpt.latest_checkpoint(d), params,
                                       state)
    assert step == 3 and extra["data_step"] == 3
    for a, b in zip(topt.tree_leaves([params, state]),
                    topt.tree_leaves([p2, s2])):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.uint8) if a.dim() else a,
                           b.view(torch.uint8) if b.dim() else b)


def test_checkpoint_without_msgpack(tmp_path, monkeypatch):
    """The checkpoint module never imports msgpack: with it blocked a
    save and a restore still work (the card's machine does not have
    it)."""
    import sys
    monkeypatch.setitem(sys.modules, "msgpack", None)
    params, state = _init(get_config("qwen3-0.6b").reduced())
    path = ckpt.save(str(tmp_path), 7, params, state)
    step, p2, _, _ = ckpt.restore(path, params, state)
    assert step == 7 and torch.equal(p2["embed"]["w"], params["embed"]["w"])


def test_async_writer_and_restore_or_init(tmp_path):
    params, state = _init(get_config("qwen3-0.6b").reduced())
    w = ckpt.AsyncWriter()
    w.submit(str(tmp_path), 4, params, state, {"data_step": 4})
    w.wait()
    assert w.last_path.endswith("ckpt_00000004.pt")
    step, p2, _, extra = ckpt.restore_or_init(
        str(tmp_path), lambda: (0, params, state))
    assert step == 4 and extra == {"data_step": 4}
    assert torch.equal(p2["final_norm"]["g"], params["final_norm"]["g"])
    fresh = ckpt.restore_or_init(str(tmp_path / "none"),
                                 lambda: (0, params, state))
    assert fresh[0] == 0 and fresh[3] == {}


def test_elastic_runner_recovers_from_failure(tmp_path):
    """A mid-run exception (a preempted node): the runner restores from
    the last checkpoint and completes all steps."""
    tcfg = get_config("qwen3-0.6b").reduced()
    model = build_model(tcfg)
    tc = TrainConfig(learning_rate=1e-3, total_steps=10, warmup_steps=1,
                     checkpoint_every=2, checkpoint_dir=str(tmp_path / "ck"),
                     async_checkpoint=False)
    data = SyntheticDataset(tcfg.vocab_size, 16, 2, task="copy")
    raw_step = make_train_step(model, tc)
    fail_at = {"step": 5, "done": False}

    def flaky_step(params, opt_state, batch):
        if not fail_at["done"] and int(opt_state["step"]) + 1 == \
                fail_at["step"]:
            fail_at["done"] = True
            raise RuntimeError("injected node failure")
        return raw_step(params, opt_state, batch)

    runner = ElasticRunner(tc, flaky_step, lambda: _init(tcfg), data)
    result = runner.run(10)
    assert result["step"] == 10
    assert result["restarts"] == 1
    assert ckpt.latest_checkpoint(tc.checkpoint_dir) is not None


def test_elastic_run_is_resumable(tmp_path):
    """A run stopped at step 4 and restarted from its checkpoint ends with
    the same parameters as one run straight to step 8 (the data is a pure
    function of the step)."""
    tcfg = get_config("qwen3-0.6b").reduced()
    model = build_model(tcfg)
    data = SyntheticDataset(tcfg.vocab_size, 16, 2, task="lm", seed=1)

    def run(d, stops):
        tc = TrainConfig(learning_rate=1e-3, total_steps=8, warmup_steps=1,
                         checkpoint_every=4, checkpoint_dir=str(d),
                         async_checkpoint=True)
        for n in stops:
            out = ElasticRunner(tc, make_train_step(model, tc),
                                lambda: _init(tcfg), data).run(n)
        return out, ckpt.restore(ckpt.latest_checkpoint(str(d)),
                                 *_init(tcfg))
    (a, (sa, pa, _, ea)), (b, (sb, pb, _, eb)) = (
        run(tmp_path / "straight", [8]), run(tmp_path / "stopped", [4, 8]))
    assert sa == sb == 8 and ea == eb == {"data_step": 8}
    for x, y in zip(topt.tree_leaves(pa), topt.tree_leaves(pb)):
        assert torch.equal(x, y)


def test_straggler_monitor():
    mon = StepMonitor(straggler_factor=3.0)
    for _ in range(8):
        assert not mon.record(0.1)
    assert mon.record(1.0)          # 10x median -> straggler
    assert mon.stragglers == 1


def test_straggler_forces_a_checkpoint(tmp_path):
    """A step slower than 3x the median checkpoints at once (step 6 is the
    straggler; the periodic checkpoints fall on steps 4 and 8)."""
    tcfg = get_config("qwen3-0.6b").reduced()
    model = build_model(tcfg)
    tc = TrainConfig(learning_rate=1e-3, total_steps=8, warmup_steps=1,
                     checkpoint_every=4, checkpoint_dir=str(tmp_path),
                     async_checkpoint=False, keep_checkpoints=10)
    runner = ElasticRunner(tc, make_train_step(model, tc),
                           lambda: _init(tcfg),
                           SyntheticDataset(tcfg.vocab_size, 8, 2))
    seconds = iter([0.1] * 5 + [1.0] + [0.1] * 2)
    record = runner.monitor.record
    runner.monitor.record = lambda _: record(next(seconds))
    result = runner.run(8)
    assert result["stragglers"] == 1
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["ckpt_00000004.pt", "ckpt_00000006.pt",
                     "ckpt_00000008.pt"]


def test_data_pipeline_deterministic_resume():
    ds = SyntheticDataset(1000, 16, 4, seed=3, task="lm")
    b5a = ds.batch_at(5)
    b5b = next(ds.iterate(start_step=5))
    assert torch.equal(b5a["tokens"], b5b["tokens"])
    assert torch.equal(b5a["labels"][:, :-1], b5a["tokens"][:, 1:])
    assert bool((b5a["labels"][:, -1] == -1).all())
    copy = SyntheticDataset(1000, 9, 2, task="copy", pool=2)
    c = copy.batch_at(3)
    assert torch.equal(c["tokens"][:, :4], c["tokens"][:, 4:8])
    assert bool((c["tokens"][:, 8] == 0).all())
    assert torch.equal(copy.batch_at(1)["tokens"], c["tokens"])
    assert not torch.equal(ds.batch_at(6)["tokens"], b5a["tokens"])


def test_grad_compression_roundtrip():
    g = torch.randn((64, 64), generator=torch.Generator().manual_seed(1)) \
        * 0.01
    q, scale = topt.compress_int8(g)
    assert q.dtype == torch.int8
    back = topt.decompress_int8(q, scale)
    assert float((back - g).norm() / g.norm()) < 0.01
    jq, jscale = jopt.compress_int8(jnp.asarray(g.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)


def test_train_quantize_serve_pipeline():
    """The paper's flow: train (bf16) -> quantize to a recipe -> serve."""
    tcfg = get_config("qwen3-0.6b").reduced()
    model = build_model(tcfg)
    tc = TrainConfig(learning_rate=3e-3, total_steps=20, warmup_steps=2)
    data = SyntheticDataset(tcfg.vocab_size, 32, 4, task="copy", pool=2)
    params, state = _init(tcfg)
    step = make_train_step(model, tc)
    losses = []
    for i in range(20):
        params, state, m = step(params, state, data.batch_at(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    qparams = convert.quantize_params(params, "q3_k_s")
    nbytes = lambda t: sum(x.numel() * x.element_size()  # noqa: E731
                           for x in topt.tree_leaves(t))
    assert nbytes(qparams) < 0.45 * nbytes(params)
    prompt = data.batch_at(99)["tokens"][:2, :8].numpy()
    out_d, _ = Engine(model, params, max_seq=24,
                      device="cpu").generate(prompt, 6)
    out_q, stats = Engine(model, qparams, quant="q3_k_s", max_seq=24,
                          device="cpu").generate(prompt, 6)
    assert tuple(out_d.shape) == tuple(out_q.shape) == (2, 6)
    assert stats.steps > 0 and stats.decode_tokens > 0


def test_train_launcher_runs_and_refuses_without_card(tmp_path, capsys):
    from repro_torch.launch import train
    train.main(["--reduced", "--device", "cpu", "--steps", "3", "--batch",
                "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
                "--log-every", "1"])
    out = capsys.readouterr().out
    assert "step     1 loss=" in out and "done: 3 steps" in out
    assert ckpt.latest_checkpoint(str(tmp_path)).endswith("00000003.pt")
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as e:
            train.main(["--reduced", "--steps", "1"])
        assert e.value.code != 0
        assert "--device cpu" in capsys.readouterr().err
