"""Unit tests of the port's serving-mesh layer against the JAX package's
(in-process; the multi-rank differentials live in
``test_torch_sharded_differential.py``).

The spec rules equal ``repro.parallel.sharding``'s on the same shapes
(through the JAX test's shape-only ``FakeMesh``); mesh validation and
the serve CLI's mesh flag matrix refuse with the JAX messages; the
per-device transfer ledger closes as the JAX ledger's does; per-replica
scheduler stats; ``page_layout()``'s accounting; every rank's
parameter slices concatenate back to the whole leaf bit for bit; and the
paged MLA kernel's whole-call plan on every shard (``MlaPlan``)
against a model of the kernel's split planner.
"""
import argparse

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

torch = pytest.importorskip("torch")

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.parallel import sharding as jax_rules  # noqa: E402
from repro.runtime.scheduler import Scheduler as JaxScheduler  # noqa: E402
from repro.runtime.transfers import TransferLedger as JaxLedger  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.runtime import kvcache  # noqa: E402
from repro_torch.runtime.scheduler import Scheduler  # noqa: E402
from repro_torch.runtime.transfers import TransferLedger  # noqa: E402


class FakeMesh:
    """Shape-only mesh (the JAX test's), plus this rank's coordinates for
    the port's slicing."""

    def __init__(self, dp, tp, d=0, m=0):
        self.shape = {"data": dp, "model": tp}
        self.axis_names = ("data", "model")
        self.coords = {"data": d, "model": m}


WEIGHT_CASES = [
    (("layers", "wq"), (64, 32)), (("layers", "w"), (4, 64, 32)),
    (("embed",), (512, 128)), (("moe", "router"), (8, 128)),
    (("norm", "g"), (128,)), (("w",), (63, 32)), (("lm_head", "qs"),
                                                   (512, 128)),
    (("ffn", "gate", "qs"), (8, 96, 128)), (("q", "b"), (64,))]
CACHE_CASES = [
    (("k",), (4, 20, 8, 2, 32)), (("k", "s"), (4, 20, 8, 2)),
    (("v", "q"), (4, 20, 8, 2, 32)), (("k",), (4, 21, 8, 2, 32)),
    (("ckv",), (4, 20, 8, 64)), (("krope",), (4, 20, 8, 16)),
    (("layers0", "conv"), (4, 2, 3, 48))]
MESHES = [(1, 1), (1, 2), (2, 1), (2, 2), (4, 2)]


@pytest.mark.parametrize("dp,tp", MESHES)
def test_rules_equal_the_jax_rules(dp, tp):
    """serving_weight_spec, serving_cache_spec and slot_sharding give the
    JAX package's specs (trailing Nones dropped, no size-one axis)."""
    m = FakeMesh(dp, tp)
    for keys, shape in WEIGHT_CASES:
        want = jax_rules.serving_weight_spec(keys, shape, m)
        got = sharding.serving_weight_spec(keys, shape, m)
        assert got == tuple(want), (keys, shape)
        assert not got or got[-1] is not None
    for keys, shape in CACHE_CASES:
        want = jax_rules.serving_cache_spec(keys, shape, m)
        got = sharding.serving_cache_spec(keys, shape, m)
        assert got == tuple(want), (keys, shape)
        assert not got or got[-1] is not None
        assert all(a is None or m.shape[a] > 1 for a in got)
    assert sharding.slot_sharding(m, 3) == (() if dp == 1 else ("data",))
    assert sharding.serving_degrees(m) == (dp, tp)
    assert sharding.serving_degrees(None) == (1, 1)


def test_specs_named_as_jax_names_them():
    m = FakeMesh(2, 2)
    assert sharding.serving_weight_spec(("w",), (4, 64, 32), m) == \
        tuple(P(None, "model"))
    assert sharding.serving_cache_spec(("k", "s"), (4, 20, 8, 2), m) == \
        (None, "data", None, "model")
    assert sharding.serving_cache_spec(("ckv",), (4, 20, 8, 64), m) == \
        (None, "data")


def _messages(fn, **kw):
    try:
        fn(**kw)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("dp,tp,heads,kv,vocab,slots", [
    (1, 2, 3, 2, 512, 4), (1, 2, 4, 1, 512, 4), (1, 2, 4, 2, 511, 4),
    (2, 1, 4, 2, 512, 3), (2, 2, 4, 2, 512, 4), (4, 2, 4, 2, 512, 8)])
def test_validate_serving_mesh_messages(monkeypatch, dp, tp, heads, kv,
                                        vocab, slots):
    """The port refuses (or takes) a mesh exactly as the JAX function
    does, message for message (8 devices visible to both)."""
    monkeypatch.setattr(jax, "device_count", lambda: 8)
    kw = dict(num_heads=heads, num_kv_heads=kv, vocab_size=vocab,
              num_slots=slots)
    m = FakeMesh(dp, tp)
    assert _messages(sharding.validate_serving_mesh, mesh=m, devices=8,
                     **kw) == _messages(jax_rules.validate_serving_mesh,
                                        mesh=m, **kw)


def test_validate_serving_mesh_devices_and_axes(monkeypatch):
    monkeypatch.setattr(jax, "device_count", lambda: 2)
    kw = dict(num_heads=4, num_kv_heads=2, vocab_size=512, num_slots=4)
    m = FakeMesh(2, 2)
    want = _messages(jax_rules.validate_serving_mesh, mesh=m, **kw)
    assert "needs 4 devices but only 2" in want
    assert _messages(sharding.validate_serving_mesh, mesh=m, devices=2,
                     **kw) == want
    bad = FakeMesh(1, 1)
    bad.axis_names = ("rows", "cols")
    with pytest.raises(ValueError, match="unknown axes"):
        sharding.validate_serving_mesh(bad, **kw)


# ----------------------------------------------------------------------
# serve CLI mesh flag matrix (the JAX launcher's, message for message)
# ----------------------------------------------------------------------
def _cli_args(**over):
    d = dict(arch="qwen3-0.6b", reduced=True, mode="stream", chunk_size=8,
             block_size=4, num_blocks=0, paged_attn=None, spec="off",
             spec_k=None, spec_draft_model=None, kv_quant="none",
             prefix_cache=False, shared_prefix=0, slots=4, dp=1, tp=1,
             device="cpu", ranks_per_device=8)
    d.update(over)
    return argparse.Namespace(**d)


def _refusal(module, args, capsys):
    ap = argparse.ArgumentParser(prog="serve")
    with pytest.raises(SystemExit):
        module.validate_args(ap, args)
    return capsys.readouterr().err.strip().splitlines()[-1]


@pytest.mark.parametrize("over", [
    dict(dp=0), dict(tp=2, mode="batch", block_size=0), dict(tp=3),
    dict(dp=3), dict(tp=2, arch="granite-moe-3b-a800m", reduced=False)],
    ids=["degrees", "batch", "heads", "slots", "vocab"])
def test_cli_mesh_refusals_match_jax(monkeypatch, capsys, over):
    monkeypatch.setattr(jax, "device_count", lambda: 8)
    want = _refusal(jax_serve, _cli_args(**over), capsys)
    assert _refusal(serve, _cli_args(**over), capsys) == want


def test_cli_mesh_draft_geometry_refused(monkeypatch, capsys):
    """A draft model whose heads the tp does not divide is refused (the
    target's divide): the draft shards over the same mesh."""
    over = dict(tp=2, spec="draft", spec_draft_model="qwen3-0.6b",
                arch="qwen3-1.7b", reduced=False)
    monkeypatch.setattr(jax, "device_count", lambda: 8)
    cfgs = {"qwen3-0.6b": dict(num_kv_heads=3)}

    def patched(get):
        def g(name):
            c = get(name)
            if name in cfgs:
                import dataclasses
                c = dataclasses.replace(c, **cfgs[name])
            return c
        return g
    monkeypatch.setattr(serve, "get_config", patched(serve.get_config))
    monkeypatch.setattr(jax_serve, "get_config",
                        patched(jax_serve.get_config))
    want = _refusal(jax_serve, _cli_args(**over), capsys)
    assert "draft model qwen3-0.6b" in want
    assert _refusal(serve, _cli_args(**over), capsys) == want


def test_cli_mesh_device_count_names_ranks_per_device(capsys):
    """More ranks than devices x --ranks-per-device: refused naming the
    flag (the JAX launcher names XLA_FLAGS); the CPU counts as one
    device."""
    err = _refusal(serve, _cli_args(dp=2, tp=2, ranks_per_device=2), capsys)
    assert "needs 4 devices but only 2 visible" in err
    assert "--ranks-per-device" in err
    err = _refusal(serve, _cli_args(ranks_per_device=0), capsys)
    assert "--ranks-per-device must be >= 1" in err


def test_cli_mesh_accepted():
    ap = argparse.ArgumentParser(prog="serve")
    serve.validate_args(ap, _cli_args())
    serve.validate_args(ap, _cli_args(dp=2, tp=2, ranks_per_device=4))


# ----------------------------------------------------------------------
# Ledger, scheduler, arena accounting
# ----------------------------------------------------------------------
def _charged(cls, cfg, dp, tp):
    led = cls(cfg, "q8_0", dp=dp, tp=tp)
    led.charge_step_weights(prefill_frac=0.25)
    led.charge_chunk("prefill", 8, 8)
    led.charge_chunk("decode", 1, 9)
    led.charge_sampled(2)
    led.charge("decode", "tables", "h2d", 4096)
    led.charge_cache_growth("decode", 1024)
    return led


@pytest.mark.parametrize("dp,tp", [(1, 1), (2, 2), (4, 2)])
def test_ledger_per_device_closure_matches_jax(dp, tp):
    port = _charged(TransferLedger, get_config("qwen3-0.6b").reduced(), dp,
                    tp)
    ref = _charged(JaxLedger, jax_config("qwen3-0.6b").reduced(), dp, tp)
    assert port.breakdown() == ref.breakdown()
    assert port.per_device_breakdown() == ref.per_device_breakdown()
    for phase, cats in port.breakdown().items():
        for cat, by_dir in cats.items():
            shards = tp if cat == "weights" else dp
            for d, b in by_dir.items():
                assert port.per_device_breakdown()[phase][cat][d] * shards \
                    == pytest.approx(b)
    assert port.per_device_bytes_per_token() == pytest.approx(
        ref.per_device_bytes_per_token())


def test_scheduler_replica_stats_match_jax():
    ours, ref = Scheduler(4, 64, dp=2), JaxScheduler(4, 64, dp=2)
    for sched in (ours, ref):
        assert [sched.replica_of(s) for s in range(4)] == [0, 0, 1, 1]
        sched.active = {0: object(), 1: object(), 3: object()}
        sched.record_step()
        sched.active = {0: object()}
        sched.record_step()
    assert ours.stats.replica_occupancy_sums == \
        ref.stats.replica_occupancy_sums == [3.0, 1.0]
    assert ours.stats.replica_max_occupancy == [2, 1]
    with pytest.raises(ValueError, match="not divisible"):
        Scheduler(5, 64, dp=2)


def test_page_layout_local_pages():
    """No mesh: as the JAX arena (every page local); dp = 2 over 8 pages:
    4 a shard, the JAX accounting — each rank really holds all 8 pages
    of its kv-head block."""
    from repro.models.api import build_model as jax_build
    from repro.runtime.kvcache import PagedKVArena as JaxArena
    model = build_model(get_config("qwen3-0.6b").reduced())
    jarena = JaxArena(jax_build(jax_config("qwen3-0.6b").reduced()), 2, 16,
                      block_size=4, num_blocks=6)
    arena = kvcache.PagedKVArena(model, 2, 16, block_size=4, num_blocks=6,
                                 device="cpu")
    for key in ("num_pages", "local_pages", "data_shards", "null_block"):
        assert arena.page_layout()[key] == jarena.page_layout()[key]
    lay = kvcache.PagedKVArena(model, 2, 16, block_size=4, num_blocks=7,
                               device="cpu", mesh=FakeMesh(2, 2)
                               ).page_layout()
    assert (lay["num_pages"], lay["local_pages"], lay["data_shards"]) == \
        (8, 4, 2)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_arena_holds_its_kv_heads(kv_quant):
    """A 'model' rank's GQA pages (and int8 scale pages) hold Hkv / tp
    heads; the byte accounting stays the mesh total; MLA latents and
    per-slot state stay whole."""
    cfg = get_config("qwen3-0.6b").reduced()
    model = build_model(cfg)
    kw = dict(block_size=4, num_blocks=6, device="cpu", kv_quant=kv_quant)
    whole = kvcache.PagedKVArena(model, 2, 16, **kw)
    cut = kvcache.PagedKVArena(model, 2, 16, mesh=FakeMesh(1, 2), **kw)
    for a, b in zip(kvcache._leaves(whole.buffers),
                    kvcache._leaves(cut.buffers)):
        ax = a.ndim - 1 if a.dtype == torch.float16 else a.ndim - 2
        assert b.shape[ax] * 2 == a.shape[ax]
    assert cut.nbytes() == whole.nbytes()
    assert cut.block_bytes() == whole.block_bytes()
    ds = build_model(get_config("deepseek-v3-671b").reduced())
    a = kvcache.PagedKVArena(ds, 2, 16, block_size=4, num_blocks=6,
                             device="cpu", mesh=FakeMesh(1, 2))
    b = kvcache.PagedKVArena(ds, 2, 16, block_size=4, num_blocks=6,
                             device="cpu")
    assert [t.shape for t in kvcache._leaves(a.buffers)] == \
        [t.shape for t in kvcache._leaves(b.buffers)]
    mb = build_model(get_config("mamba2-1.3b").reduced())
    a = kvcache.KVArena(mb, 2, 16, device="cpu", mesh=FakeMesh(2, 2))
    b = kvcache.KVArena(mb, 2, 16, device="cpu")
    assert [t.shape for t in kvcache._leaves(a.buffers)] == \
        [t.shape for t in kvcache._leaves(b.buffers)]


# ----------------------------------------------------------------------
# Parameter slices
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch,quant", [("qwen3-0.6b", "q8_0"),
                                        ("granite-moe-3b-a800m", "q8_0"),
                                        ("qwen2-72b", "q6_k")])
def test_param_slices_concatenate_to_the_whole(arch, quant):
    """Every rank's block of a 'model'-cut plane dict (q8_0 / q6_k
    planes, an MoE expert bank (E, out, in)) concatenates back along the
    out-feature axis to the whole leaf, bit for bit; the embedding,
    routers, norms and biases stay whole."""
    cfg = get_config(arch).reduced()
    params = convert.quantize_params(
        build_model(cfg).init(torch.Generator().manual_seed(0)), quant)
    tp = 2
    ranks = [convert.shard_params(params, FakeMesh(1, tp, m=m))
             for m in range(tp)]
    seen = {"cut": 0, "bank": 0}

    def walk(whole, shards, path):
        if isinstance(whole, dict):
            if sharding.is_model_shard(shards[0]):
                seen["cut"] += 1
                for k, v in whole.items():
                    if v.ndim == 1:
                        assert all(torch.equal(s[k], v) for s in shards)
                        continue
                    if v.ndim == 3:
                        seen["bank"] += 1
                    assert torch.equal(torch.cat([s[k] for s in shards],
                                                 dim=-2), v), path + (k,)
                return
            for k in whole:
                walk(whole[k], [s[k] for s in shards], path + (k,))
        elif isinstance(whole, list):
            for i, w in enumerate(whole):
                walk(w, [s[i] for s in shards], path)
        else:
            assert all(s is whole for s in shards), path
    walk(params, ranks, ())
    assert seen["cut"] > 0
    if arch.startswith("granite"):
        assert seen["bank"] > 0
    assert not sharding.is_model_shard(ranks[0]["embed"])


# ----------------------------------------------------------------------
# The paged MLA kernel's (B9's) page-walk split on a shard
# ----------------------------------------------------------------------
# A model of the tensor-core MLA kernel's planner (csrc/paged_attention.cu,
# ``walk_keys``, ``shard_rows``, ``per_floor`` and the binary search of
# ``paged_mla_tc_kernel``; KT keys a tile, at most MAX_SPLITS splits a
# row tile): the (walk keys, key tiles a split, splits) every row of a
# call takes, keyed by its (slot, chunk entry, head) in the whole call. A
# row's output is fixed by them. A shard of slots [slot0, slot0 + b) and
# heads [g0, g0 + g) plans from the whole call's positions and lengths
# (``MlaPlan``) and walks only the whole call's row tiles that hold its
# rows.
MLA_KT, MLA_MAX_SPLITS = 16, 16


def _mla_shard_rows(tile, c, g, gw, g0, rt):
    """``shard_rows``: the shard's run [x, x + y) of its c * g rows in
    whole-call row tile ``tile``."""
    w0, w1 = tile * rt, min(tile * rt + rt, c * gw)
    first, count = 0, 0
    i = w0 // gw
    while i * gw < w1:
        lo, hi = max(w0, i * gw + g0), min(w1, i * gw + g0 + g)
        if lo < hi:
            if count == 0:
                first = i * g + lo - i * gw - g0
            count += hi - lo
        i += 1
    return first, count


def _mla_row_splits(c, gw, pos, lens, mb, bs, sms, rt, slot0=0, b=None,
                    g=None, g0=0):
    b = len(lens) if b is None else b
    g = gw if g is None else g

    def walk_keys(tile, pos0, n):
        n1 = max(n, 1)
        if tile * rt // gw >= n1:
            return 0
        end = min((tile * rt + rt - 1) // gw + 1, c)
        return min(pos0 + min(end, n1), mb * bs)
    tiles = -(-c * gw // rt)
    walks = [[walk_keys(t, p, n) for t in range(tiles)]
             for p, n in zip(pos, lens)]
    off = [-(-w // MLA_KT) for ws in walks for w in ws]
    maxt = -(-mb * bs // MLA_KT)
    per = min(max(-(-sum(off) // sms), -(-maxt // min(maxt,
                                                       MLA_MAX_SPLITS))),
              maxt)
    hi = maxt
    while per < hi:
        mid = (per + hi) // 2
        if sum(-(-o // mid) for o in off) <= sms:
            hi = mid
        else:
            per = mid + 1
    out = {}
    items = 0
    for bw in range(slot0, slot0 + b):
        for t, w in enumerate(walks[bw]):
            first, count = _mla_shard_rows(t, c, g, gw, g0, rt)
            nt = -(-w // MLA_KT)
            live = -(-nt // per)
            items += live if count else 0
            for r in range(first, first + count):
                key = (bw, r // g, g0 + r % g)
                assert key not in out, key      # every row walked once
                if r // g < max(lens[bw], 1):
                    out[key] = (w, -(-nt // live) if live else 0, live)
    assert items <= sms                 # the cooperative launch's bound
    return out


def test_mla_shard_split_is_the_whole_calls():
    """Random steps (chunks of 1-16 entries, 4-256 heads, 1-8 head
    blocks, 1-4 'data' blocks, 7-132 SMs): every shard launched with the
    whole call's plan inputs splits each of its rows' walk as the whole
    call does, and its row runs cover each of its rows once."""
    from repro_torch.kernels import paged_attention as pa
    rt = pa.mla_tc_row_tile()
    rng = np.random.RandomState(0)
    cases = 0
    for _ in range(300):
        c = int(rng.choice([1, 2, 4, 5, 8, 16]))
        gw = int(rng.choice([4, 8, 20, 32, 64, 128, 256]))
        parts = int(rng.choice([d for d in (1, 2, 4, 8) if gw % d == 0]))
        data = int(rng.choice([1, 2, 4]))
        b, bs = data * int(rng.randint(1, 5)), 16
        mb = int(rng.randint(1, 160))
        lens = rng.randint(0, c + 1, b)
        pos = [int(rng.randint(0, mb * bs - max(n, 1) + 1)) for n in lens]
        sms = int(rng.choice([7, 114, 128, 132]))
        try:
            whole = _mla_row_splits(c, gw, pos, lens, mb, bs, sms, rt)
        except AssertionError:
            continue                    # more items than SMs: no launch
        g, nb = gw // parts, b // data
        shards = {}
        for d in range(data):
            for m in range(parts):
                shards.update(_mla_row_splits(c, gw, pos, lens, mb, bs, sms,
                                              rt, d * nb, nb, g, m * g))
        assert shards == whole, (c, gw, parts, data, sms)
        cases += 1
    assert cases > 200


def test_mla_plan_note():
    """deepseek-v3 (128 heads) on the card's fused path: B9 plans from
    the whole step, so no note on bf16 or int8 pages at any tp or dp
    with chunks; a note on f32 pages (the CUDA-core kernel); none on the
    CPU, on the ref path or for GQA models."""
    from repro_torch.runtime.engine import mla_plan_note
    ds = build_model(get_config("deepseek-v3-671b"))
    qw = build_model(get_config("qwen3-0.6b"))
    cuda = torch.device("cuda")
    kw = dict(device=cuda, paged=True, paged_attn="fused",
              pages_dtype=torch.bfloat16)
    for dp, tp in ((1, 2), (1, 4), (1, 8), (2, 1), (2, 2)):
        assert mla_plan_note(ds, dp=dp, tp=tp, **kw) is None
        assert mla_plan_note(ds, dp=dp, tp=tp, **dict(
            kw, pages_dtype=torch.int8)) is None
    assert mla_plan_note(ds, dp=1, tp=2, **dict(
        kw, pages_dtype=torch.float32)) is not None
    assert mla_plan_note(ds, dp=2, tp=2, **dict(
        kw, device=torch.device("cpu"), pages_dtype=torch.float32)) is None
    assert mla_plan_note(ds, dp=2, tp=1, **dict(
        kw, paged_attn="ref", pages_dtype=torch.float32)) is None
    assert mla_plan_note(qw, dp=2, tp=2, **kw) is None


def test_mla_plan_of_a_shard():
    """``attention._mla_plan``: None on one device; on a 'model' shard
    the whole call's heads and this shard's first; on a 'data' replica
    the whole step's positions and lengths and its first slot."""
    from repro_torch.models.attention import _mla_plan

    class Mesh:
        shape = {"data": 2, "model": 2}
        axis_names = ("data", "model")
        coords = {"data": 1, "model": 1}
    pos = torch.tensor([3, 5], dtype=torch.int32)
    lens = torch.tensor([2, 1], dtype=torch.int32)
    whole = (torch.arange(4, dtype=torch.int32),
             torch.ones(4, dtype=torch.int32))
    assert _mla_plan({"w": None}, pos, lens, 2, 4, 16) is None
    cut = sharding.ModelShard({"w": None}, 2, 1)
    plan = _mla_plan(cut, pos, lens, 2, 4, 16)
    assert (plan.slot0, plan.heads, plan.head0) == (0, 32, 16)
    assert torch.equal(plan.positions, pos)
    with sharding.activation_mesh(Mesh(), data_local=True,
                                  whole_step=whole):
        plan = _mla_plan(cut, pos, lens, 2, 4, 16)
    assert (plan.slot0, plan.heads, plan.head0) == (2, 32, 16)
    assert plan.positions is whole[0] and plan.lengths is whole[1]
    with sharding.activation_mesh(Mesh(), data_local=True):
        with pytest.raises(RuntimeError, match="whole step"):
            _mla_plan(cut, pos, lens, 2, 4, 16)
