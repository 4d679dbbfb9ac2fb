"""The packed serving step against the padded one, on the CPU.

``lm_decode_step(..., rows=(fed, heads))`` runs the embedding and the
token-wise layers on the R rows the step's slots feed and only the
attention core on the (slots, chunk) layout (``models/lm.py``); a model
with an SSM mixer or an MoE FFN runs its layers padded and packs its
head. The engine builds the rows on the host and counts them
(``model_rows``, ``logit_rows`` on every step event). Every fed row's
logits, and every page and state the step writes, must be the padded
step's, and a greedy stream's tokens the unpacked engine's.

On the CPU a product inside the packed step is computed at the padded
step's rows (``kops.planned_rows``), so every comparison is bit for bit.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import _dequant_matmul as dm  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.runtime import sampling, telemetry  # noqa: E402
from repro_torch.runtime.engine import ServingEngine  # noqa: E402

SLOTS, CHUNK, BS = 4, 8, 4
# (pos0, fed) per slot of the mixed step: a prompt chunk of 8, two
# decodes of 1, an inactive slot, and a prompt chunk of 5.
MIX = [(5, 8), (22, 1), (0, 0), (13, 5)]


def _cfg(arch):
    return get_config(arch).reduced()


def _step_inputs(model, cfg, paged, gen):
    """A mixed step's (token, position, lengths, tables, embeds, mask)
    and a random arena: pages of every slot (the null page last) and
    SSM state, so that the step reads history."""
    b = len(MIX)
    pos0 = torch.tensor([p for p, _ in MIX], dtype=torch.int32)
    lens = torch.tensor([n for _, n in MIX], dtype=torch.int32)
    token = torch.randint(0, cfg.vocab_size, (b, CHUNK), generator=gen,
                          dtype=torch.int32)
    max_seq = 32
    mb = max_seq // BS
    if paged:
        shapes = model.paged_cache_shapes(b, b * mb + 1, BS)
        tables = torch.arange(b * mb, dtype=torch.int32).reshape(b, mb)
        tables[lens == 0] = b * mb                    # the null page
    else:
        shapes = model.cache_shapes(b, max_seq)
        tables = None

    def leaf(sh):
        if isinstance(sh, dict):
            return {k: leaf(v) for k, v in sh.items()}
        return torch.randn(sh, generator=gen).to(torch.bfloat16)
    cache = leaf(shapes)
    embeds = mask = None
    if cfg.family == "vlm":
        embeds = torch.randn((b, CHUNK, cfg.d_model),
                             generator=gen).to(torch.bfloat16)
        mask = (pos0[:, None] + torch.arange(CHUNK)) < cfg.vision_tokens
    return token, pos0, lens, tables, cache, embeds, mask


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], path + (k,))]
    return [(path, tree)]


def _fed_rows(lens):
    fed = np.flatnonzero(np.arange(CHUNK)[None, :] < lens.numpy()[:, None])
    return torch.from_numpy(fed)


CASES = [("qwen3-0.6b", True), ("qwen3-0.6b", False), ("qwen2-72b", True),
         ("qwen2-72b", False), ("deepseek-v3-671b", True),
         ("deepseek-v3-671b", False), ("mamba2-1.3b", True),
         ("jamba-v0.1-52b", True), ("qwen2-vl-2b", True)]


@pytest.mark.parametrize("arch,paged", CASES,
                         ids=[f"{a}-{'paged' if p else 'contiguous'}"
                              for a, p in CASES])
def test_packed_step_equals_padded(arch, paged):
    """Every fed row's logits, and every leaf of the arena, bit for bit
    the padded step's: dense and vlm packed throughout, and the MLA,
    MoE, SSM and hybrid models on their padded layers with a packed
    head."""
    torch.manual_seed(0)
    cfg = _cfg(arch)
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(7)
    params = model.init(gen, quant="q8_0")
    token, pos0, lens, tables, cache, embeds, mask = _step_inputs(
        model, cfg, paged, gen)
    extra = {} if embeds is None else {"embeds": embeds,
                                       "embeds_mask": mask}
    c_pad, c_pack = _clone(cache), _clone(cache)
    kw = dict(quant="q8_0", block_tables=tables, lengths=lens, **extra)
    want, _ = model.decode_step(params, token, pos0, c_pad, **kw)
    fed = _fed_rows(lens)
    heads = torch.arange(fed.numel())
    got, _ = model.decode_step(params, token, pos0, c_pack,
                               rows=(fed, heads), **kw)
    assert got.shape == (fed.numel(), cfg.vocab_size)
    assert torch.equal(got, want.reshape(-1, want.shape[-1])[fed])
    for (path, a), (_, b) in zip(_leaves(c_pad), _leaves(c_pack)):
        assert torch.equal(a, b), path
    assert model.packs_layers == (arch in ("qwen3-0.6b", "qwen2-72b",
                                           "qwen2-vl-2b"))


def test_packed_step_heads_pick_rows():
    """``heads`` picks rows of the fed rows: each slot's last one, the
    padded step's row bit for bit (a slot that feeds nothing takes the
    one before it)."""
    cfg = _cfg("qwen3-0.6b")
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(3)
    params = model.init(gen, quant="q8_0")
    token, pos0, lens, tables, cache, _, _ = _step_inputs(model, cfg, True,
                                                          gen)
    kw = dict(quant="q8_0", block_tables=tables, lengths=lens)
    want, _ = model.decode_step(params, token, pos0, _clone(cache), **kw)
    fed = _fed_rows(lens)
    heads = torch.clamp(torch.cumsum(lens.to(torch.long), 0) - 1, min=0)
    got, _ = model.decode_step(params, token, pos0, _clone(cache),
                               rows=(fed, heads), **kw)
    last = torch.clamp(lens.to(torch.long) - 1, min=0)
    ref = want[torch.arange(len(MIX)), last]
    active = lens > 0
    assert got.shape == ref.shape
    assert torch.equal(got[active], ref[active])
    # The inactive slot reads its neighbour's row (slot 1's last).
    assert torch.equal(got[2], got[1])


def _engine(model, params, spec, paged):
    kw = dict(block_size=BS, num_blocks=40) if paged else {}
    return ServingEngine(model, params, quant="q8_0", num_slots=SLOTS,
                         max_seq=40, chunk_size=CHUNK, spec=spec, spec_k=3,
                         telemetry=True, device="cpu", **kw)


def _requests(cfg, seed):
    args = types.SimpleNamespace(prompt_len=20, gen=10, requests=7,
                                 temperature=0.0, shared_prefix=0,
                                 arrival="back2back", rate=8.0)
    reqs = tserve.build_stream(cfg, args, np.random.RandomState(seed))
    for r in reqs[::2]:
        # A repeating prompt, so that n-gram lookups propose and accept.
        r.tokens[:] = np.resize(r.tokens[:3], r.tokens.size)
    return reqs


STREAMS = [("qwen3-0.6b", "off", True), ("qwen3-0.6b", "ngram", True),
           ("qwen3-0.6b", "off", False), ("qwen2-vl-2b", "off", True),
           ("deepseek-v3-671b", "off", True),
           ("jamba-v0.1-52b", "off", True)]


@pytest.mark.parametrize("arch,spec,paged", STREAMS,
                         ids=[f"{a}-{s}-{'paged' if p else 'contiguous'}"
                              for a, s, p in STREAMS])
def test_packed_stream_equals_unpacked(arch, spec, paged):
    """A greedy stream through the packed engine gives the unpacked
    engine's tokens (a model whose decode step takes no rows), and its
    step events count the rows: ``model_rows`` the fed rows where the
    layers pack (else slots x chunk), ``logit_rows`` one a slot, or
    every fed row under speculation."""
    cfg = _cfg(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(5), quant="q8_0")
    out = {}
    for packs in (model.packs_layers, None):
        m = dataclasses.replace(model, packs_layers=packs)
        rep = _engine(m, params, spec, paged).serve(_requests(cfg, 11))
        out[packs] = rep
    got, want = out[model.packs_layers], out[None]
    assert [s.generated for s in got.sequences] \
        == [s.generated for s in want.sequences]
    if spec != "off":
        assert got.stats.spec_accepted > 0
    full = SLOTS * CHUNK
    for ev in got.timeline.events:
        if not ev.slots:
            continue
        fed = sum(n for _, _, _, n, _ in ev.slots)
        assert ev.counters["model_rows"] == (fed if model.packs_layers
                                             else full), ev.step
        assert ev.counters["logit_rows"] == (fed if spec != "off"
                                             else SLOTS), ev.step
    for ev in want.timeline.events:
        if ev.slots:
            assert ev.counters["model_rows"] == full
            assert ev.counters["logit_rows"] == full
    assert set(telemetry.ROW_COUNTERS) <= set(got.timeline.events[0].counters)


QWEN2_72B_NK = [(1024, 8192), (8192, 8192), (29568, 8192), (152064, 8192),
                (8192, 29568)]


@pytest.mark.parametrize("n,k", QWEN2_72B_NK)
def test_plan_rows_fixes_the_split(n, k):
    """Under ``plan_rows(256)`` a call of any row count splits K as the
    256-row call does; the tile still follows its own rows."""
    bf = torch.bfloat16
    want = dm.plan(256, n, k, 132, bf)
    for m in (1, 45, 64, 65, 100, 128, 256):
        tile, k_split, splits = dm.plan(m, n, k, 132, bf, plan_m=256)
        assert (k_split, splits) == want[1:], m
        assert tile == dm.plan(m, n, k, 132, bf)[0]
    # Without it, rows 65-128 would split K otherwise somewhere here.
    if (n, k) == (8192, 8192):
        assert dm.plan(100, n, k, 132, bf)[1:] != want[1:]


def test_plan_rows_scope():
    assert not dm._PLAN_ROWS
    with kops.plan_rows(256):
        assert dm._PLAN_ROWS == [256]
        with kops.plan_rows(None):
            assert dm._PLAN_ROWS == [256]
    assert not dm._PLAN_ROWS


def test_packs_layers_by_layer_type():
    """Packed layers only where no mixer or FFN reads across rows, and
    no MLA mixer (whose one model is MoE)."""
    got = {a: lm.packs_layers(_cfg(a)) for a in (
        "qwen3-0.6b", "qwen2-72b", "llama3.2-3b", "qwen2-vl-2b",
        "deepseek-v3-671b", "granite-moe-3b-a800m", "mamba2-1.3b",
        "jamba-v0.1-52b")}
    assert [a for a, v in got.items() if v] == [
        "qwen3-0.6b", "qwen2-72b", "llama3.2-3b", "qwen2-vl-2b"]
    assert not lm.packs_layers(dataclasses.replace(
        _cfg("deepseek-v3-671b"), moe=None))
    whisper = build_model(get_config("whisper-small").reduced())
    assert whisper.packs_layers is None


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v3-671b"])
def test_idle_slot_head_row_is_zero(arch, monkeypatch):
    """A slot that feeds nothing reads a zero logits row, not its packed
    neighbour's, so each sampled row is its own slot's on any replica."""
    cfg = _cfg(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(5), quant="q8_0")
    seen = []
    sample0 = sampling.sample_slots

    def sample(last, gen, temps, active, **kw):
        seen.append((last.clone(), active.clone()))
        return sample0(last, gen, temps, active, **kw)
    monkeypatch.setattr(sampling, "sample_slots", sample)
    _engine(model, params, "off", True).serve(_requests(cfg, 11))
    idle = [(last, act) for last, act in seen if not act.all()]
    assert idle
    for last, act in idle:
        assert torch.all(last[~act] == 0)
        assert torch.all(last[act].abs().sum(-1) > 0)
