"""Sharded == single-device serving differentials of the port (gloo on the
CPU).

The exactness contract of the serving mesh, as the JAX package's
``test_sharded_differential.py`` holds it: a (data, model) mesh serves
the same tokens as the port's unsharded engine. One gloo world per
architecture group runs its cells on sub-meshes of its ranks (a 1x1
cell on rank 0 alone), so one model build serves every cell. Each rank
runs one torch thread: the plain CPU matmul's column blocks then match
the whole product bit for bit (on 8 threads they do not).

Held, per cell, against the 1x1 run of the same flags: tokens exactly,
and the ledger as the JAX test holds it — the mesh-total cells
degree-invariant, the per-device cells closing (per-device x shards =
total, per category), ``local_pages``, the modeled KV reads (the
aggregate mesh-blind, the busiest replica's at most the total, the ref
gather's exactly 1 / dp of it) — and the collectives a step that the
layer structure gives (``expected_collectives``).

The port's meshes are also held against the JAX package's
(``test_sharded_serving_matches_jax_mesh``): the JAX ``ServingEngine``
on a (data, model) mesh of forced host devices, in a subprocess (as the
JAX package's own test runs it), and the port's gloo world on the same
weights (``params_from_jax``) give the same tokens, ledger (aggregate
and per device), busiest-replica KV reads and ``page_layout()``.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import mesh as meshes  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.lm import layer_groups  # noqa: E402
from repro_torch.runtime.engine import ServingEngine  # noqa: E402
from repro_torch.runtime.request import Request, SamplingParams  # noqa: E402

MESHES = ((1, 1), (1, 2), (2, 1), (2, 2))


def expected_collectives(cfg, dp: int, tp: int, steps: int) -> int:
    """All-gathers a rank makes in ``steps`` unified steps: over
    'model', four a dense GQA layer — attention's output (q/k/v keep
    their heads), o, the SwiGLU's h (gate and up stay columnwise) and
    down — plus the vocab-sharded lm_head; over 'data', the sampled
    tokens and the page-pool sync. Dense attention families only."""
    model = 0
    if tp > 1:
        for _, count, subs in layer_groups(cfg):
            for mixer, ffn in subs:
                assert mixer == "gqa" and ffn == "dense", (mixer, ffn)
                model += count * 4
        model += 0 if cfg.tie_embeddings else 1
    data = 2 if dp > 1 else 0
    return steps * (model + data)


def _requests(cfg, n=3, gen=3, shared=0, temperature=0.0):
    rng = np.random.RandomState(3)
    pre = rng.randint(0, cfg.vocab_size, shared)
    return [Request(rid=i, tokens=np.concatenate(
        [pre, rng.randint(0, cfg.vocab_size, 6 + i)]).astype(np.int64),
        max_new_tokens=gen, sampling=SamplingParams(temperature=temperature))
        for i in range(n)]


def _extras(cfg, reqs):
    """Seeded random frontend inputs (the conditioned families)."""
    rng = np.random.RandomState(7)
    for r in reqs:
        if cfg.family == "vlm":
            r.extras = {"vision_embeds": torch.from_numpy(rng.standard_normal(
                (1, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
            ).to(torch.bfloat16)}
        if cfg.family == "encdec":
            r.extras = {"frames": torch.from_numpy(rng.standard_normal(
                (1, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
            ).to(torch.bfloat16)}
    return reqs


def _build(arch, quant, params_file=None, seed=0):
    """Reduced ``arch``: seeded port weights, or the tree saved at
    ``params_file`` (already in ``quant``)."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    if params_file is not None:
        return cfg, model, torch.load(params_file, weights_only=False)
    params = model.init(torch.Generator().manual_seed(seed))
    if quant != "none":
        from repro_torch.core.convert import quantize_params
        params = quantize_params(params, quant)
    return cfg, model, params


def _cells_worker(ctx, cells):
    """Rank side: every cell on its sub-mesh; rank 0's results."""
    built = {}
    out = {}
    for cell in cells:
        dp, tp = cell["mesh"]
        mesh = meshes.make_host_mesh(
            dp, tp, ranks_per_device=ctx.ranks_per_device) \
            if dp * tp > 1 else None
        if (mesh is None and ctx.rank) or (mesh is not None
                                           and not mesh.member):
            continue
        key = (cell["arch"], cell.get("quant", "q8_0"), cell.get("params"))
        if key not in built:
            built[key] = _build(*key)
        cfg, model, params = built[key]
        kw = dict(num_slots=cell.get("slots", 2),
                  max_seq=cell.get("max_seq", 48),
                  chunk_size=4, block_size=4, num_blocks=cell.get("blocks",
                                                                  15),
                  paged_attn=cell.get("attn", "fused"),
                  quant=key[1], device="cpu", mesh=mesh)
        kw.update(cell.get("engine", {}))
        if kw.get("spec") == "draft":
            # A self-draft (the target's weights): every lane accepted.
            _, dmodel, dparams = _build(cell["draft"], key[1])
            kw.update(spec_draft_model=dmodel, spec_draft_params=dparams)
        if not cell.get("paged", True):
            kw.pop("block_size"), kw.pop("num_blocks"), kw.pop("paged_attn")
        eng = ServingEngine(model, params, **kw)
        reqs = _extras(cfg, _requests(cfg, **cell.get("reqs", {})))
        rep = eng.serve(reqs, seed=0, realtime=False)
        if rep.sequences and cell.get("repeat"):
            rep = eng.serve(_extras(cfg, _requests(cfg, **cell.get(
                "reqs", {}))), seed=0, realtime=False)
        led = rep.ledger
        res = {
            "tokens": [[int(t) for t in s.generated] for s in rep.sequences],
            "steps": rep.stats.steps,
            "prefix_hits": rep.stats.prefix_hits,
            "spec": (rep.stats.spec_proposed, rep.stats.spec_accepted),
            "breakdown": led.breakdown(),
            "per_device": led.per_device_breakdown(),
            "bytes_per_token": led.bytes_per_token(),
            "kv_read": rep.stats.paged_kv_read_bytes,
            "kv_read_dev": rep.stats.paged_kv_read_bytes_per_device,
            "collectives": rep.collectives,
        }
        if eng.paged:
            res["layout"] = eng.arena.page_layout()
        if ctx.rank == 0:
            out[cell["name"]] = res
    return out


def _run(world, cells):
    return meshes.spawn(_cells_worker, world, (cells,), device_type="cpu",
                        ranks_per_device=world, threads=1)[0]


def _matrix(arch, **extra):
    return [dict(name=f"{attn}/{dp}x{tp}", arch=arch, mesh=(dp, tp),
                 attn=attn, **extra)
            for attn in ("fused", "ref") for dp, tp in MESHES]


def _hold_ledger(base, got, dp, tp):
    assert got["breakdown"] == base["breakdown"]
    assert got["bytes_per_token"] == pytest.approx(base["bytes_per_token"])
    assert got["kv_read"] == pytest.approx(base["kv_read"])
    assert 0 < got["kv_read_dev"] <= got["kv_read"]
    for phase, cats in got["breakdown"].items():
        for cat, by_dir in cats.items():
            shards = tp if cat == "weights" else dp
            for d, b in by_dir.items():
                assert got["per_device"][phase][cat][d] * shards \
                    == pytest.approx(b)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v3-671b"],
                         ids=["gqa", "mla"])
def test_sharded_serving_token_identical(arch):
    """GQA and MLA, fused and ref, on 1x2, 2x1 and 2x2: the tokens and
    the ledger of the 1x1 run; the collectives of the layer structure
    (GQA)."""
    res = _run(4, _matrix(arch))
    cfg = get_config(arch).reduced()
    for attn in ("fused", "ref"):
        base = res[f"{attn}/1x1"]
        assert base["collectives"] is None and base["layout"][
            "local_pages"] == base["layout"]["num_pages"] == 16
        for dp, tp in MESHES[1:]:
            got = res[f"{attn}/{dp}x{tp}"]
            assert got["tokens"] == base["tokens"], \
                f"{arch} {attn}/{dp}x{tp} diverged from single-device"
            _hold_ledger(base, got, dp, tp)
            lay = got["layout"]
            assert lay["data_shards"] == dp
            assert lay["local_pages"] == 16 // dp
            if arch == "qwen3-0.6b":
                assert got["collectives"]["collectives"] == \
                    expected_collectives(cfg, dp, tp, got["steps"])
        # The dense gather reads every table row: 1 / dp a replica.
        got = res[f"ref/2x2"]
        assert got["kv_read_dev"] * 2 == pytest.approx(got["kv_read"])


def test_sharded_serving_gqa_features():
    """int8 pages at 1x2, the prefix cache at 2x1 (a second run hits the
    first's pages), n-gram speculation and a draft model at 1x2, a
    sampled (temperature 1) stream and the contiguous arena at 2x2 —
    each the tokens (and prefix hits, speculation counts, ledger) of its
    1x1 run."""
    arch = "qwen3-0.6b"
    cells = []
    for name, meshv, extra in (
            ("int8", (1, 2), dict(engine=dict(kv_quant="int8"))),
            ("prefix", (2, 1), dict(engine=dict(prefix_cache=True),
                                    reqs=dict(shared=8), repeat=True)),
            ("ngram", (1, 2), dict(engine=dict(spec="ngram", spec_k=3),
                                   reqs=dict(gen=8))),
            ("draft", (1, 2), dict(engine=dict(spec="draft", spec_k=3),
                                   draft="qwen3-0.6b", reqs=dict(gen=6))),
            ("sampled", (2, 2), dict(reqs=dict(temperature=1.0))),
            ("contiguous", (2, 2), dict(paged=False))):
        for m in ((1, 1), meshv):
            cells.append(dict(name=f"{name}/{m[0]}x{m[1]}", arch=arch,
                              mesh=m, slots=4, blocks=24, **extra))
    res = _run(4, cells)
    for name in ("int8", "prefix", "ngram", "draft", "sampled",
                 "contiguous"):
        base, = [v for k, v in res.items() if k == f"{name}/1x1"]
        got, = [v for k, v in res.items()
                if k.startswith(name + "/") and k != f"{name}/1x1"]
        assert got["tokens"] == base["tokens"], name
        assert got["prefix_hits"] == base["prefix_hits"], name
        assert got["spec"] == base["spec"], name
        assert got["breakdown"] == base["breakdown"], name
    assert res["prefix/1x1"]["prefix_hits"] > 0
    assert res["ngram/1x1"]["spec"][0] > 0
    assert res["draft/1x1"]["spec"][1] > 0


@pytest.mark.parametrize("group", [
    (2, (2, 1), ("granite-moe-3b-a800m", "whisper-small")),
    (2, (1, 2), ("mamba2-1.3b", "jamba-v0.1-52b", "qwen2-vl-2b"))],
    ids=["dp", "tp"])
def test_sharded_serving_families(group):
    """granite-moe (MoE tokens gathered over 'data') and whisper
    (encoder pass on the owning replica) at 2x1; mamba2, jamba (SSM
    state leaves, MoE banks cut over 'model') and qwen2-vl (vision rows)
    at 1x2: tokens of the 1x1 run."""
    world, meshv, archs = group
    cells = []
    for arch in archs:
        for m in ((1, 1), meshv):
            cells.append(dict(name=f"{arch}/{m[0]}x{m[1]}", arch=arch,
                              mesh=m, reqs=dict(gen=4)))
    res = _run(world, cells)
    for arch in archs:
        base = res[f"{arch}/1x1"]
        got = res[f"{arch}/{meshv[0]}x{meshv[1]}"]
        assert got["tokens"] == base["tokens"], arch
        assert got["breakdown"] == base["breakdown"], arch


# ----------------------------------------------------------------------
# Against the JAX package's mesh

# The JAX side: its ServingEngine on (data, model) meshes of forced host
# devices (XLA reads the flag before jax is imported, so a process of
# its own), the default fused paged attention (Pallas in interpret mode
# on the CPU), the same engine arguments, requests (``_requests``) and
# q8_0 weights the port's cells get. Prints a fingerprint of the weights
# and each mesh's results.
_JAX_WORKER = r"""
import hashlib, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import numpy as np
from repro.configs.registry import get_config
from repro.core import convert
from repro.models.api import build_model
from repro.runtime.engine import ServingEngine
from repro.runtime.request import Request, SamplingParams

arch, meshes, engine = sys.argv[1], json.loads(sys.argv[2]), \
    json.loads(sys.argv[3])
cfg = get_config(arch).reduced()
model = build_model(cfg)
params = jax.jit(lambda key: convert.quantize_params(model.init(key),
                                                     "q8_0"))(
    jax.random.PRNGKey(0))
digest = hashlib.sha256()
for leaf in jax.tree.leaves(params):
    digest.update(np.ascontiguousarray(np.asarray(leaf)).tobytes())


def make_requests():
    rng = np.random.RandomState(3)
    pre = rng.randint(0, cfg.vocab_size, 0)
    return [Request(rid=i, tokens=np.concatenate(
        [pre, rng.randint(0, cfg.vocab_size, 6 + i)]).astype(np.int64),
        max_new_tokens=3, sampling=SamplingParams(temperature=0.0))
        for i in range(3)]


out = {"fingerprint": digest.hexdigest()}
for dp, tp in meshes:
    mesh = None
    if dp * tp > 1:
        devs = np.array(jax.devices()[: dp * tp]).reshape(dp, tp)
        mesh = jax.sharding.Mesh(devs, ("data", "model"))
    eng = ServingEngine(model, params, quant="q8_0", mesh=mesh, **engine)
    rep = eng.serve(make_requests(), seed=0, realtime=False)
    led = rep.ledger
    out[f"{dp}x{tp}"] = {
        "tokens": [[int(t) for t in s.generated] for s in rep.sequences],
        "breakdown": led.breakdown(),
        "per_device": led.per_device_breakdown(),
        "bytes_per_token": led.bytes_per_token(),
        "kv_read": rep.stats.paged_kv_read_bytes,
        "kv_read_dev": rep.stats.paged_kv_read_bytes_per_device,
        "layout": eng.arena.page_layout(),
    }
print("RESULT " + json.dumps(out))
"""

JAX_MESHES = ((1, 1), (1, 2), (2, 2))
JAX_ENGINE = dict(num_slots=2, max_seq=32, chunk_size=4, block_size=4,
                  num_blocks=7)


def _run_jax_meshes(arch, tmp_path):
    worker = tmp_path / "jax_worker.py"
    worker.write_text(_JAX_WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, str(worker), arch, json.dumps(JAX_MESHES),
         json.dumps(JAX_ENGINE)], capture_output=True, text=True,
        timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def _jax_weights(arch, path):
    """The JAX worker's q8_0 weights (built again here, on this
    process's one device; the fingerprint holds them to the worker's),
    saved at ``path`` as the port's tree."""
    jax = pytest.importorskip("jax")
    from repro.configs.registry import get_config as jax_config
    from repro.core import convert as jconvert
    from repro.models.api import build_model as jax_build
    from repro_torch.core.convert import params_from_jax
    jmodel = jax_build(jax_config(arch).reduced())
    jparams = jax.jit(lambda key: jconvert.quantize_params(
        jmodel.init(key), "q8_0"))(jax.random.PRNGKey(0))
    digest = hashlib.sha256()
    for leaf in jax.tree.leaves(jparams):
        digest.update(np.ascontiguousarray(np.asarray(leaf)).tobytes())
    torch.save(params_from_jax(jax.tree.map(np.asarray, jparams),
                               get_config(arch).reduced(), device="cpu"),
               path)
    return digest.hexdigest()


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v3-671b"],
                         ids=["gqa", "mla"])
def test_sharded_serving_matches_jax_mesh(arch, tmp_path):
    """GQA and MLA on 1x1, 1x2 and 2x2, fused, with the JAX package's
    q8_0 weights: the port's tokens, ledger (aggregate and per device),
    busiest-replica KV reads and ``page_layout()`` equal the JAX
    engine's on the same mesh."""
    fingerprint = _jax_weights(arch, tmp_path / "params.pt")
    jres = _run_jax_meshes(arch, tmp_path)
    assert jres["fingerprint"] == fingerprint
    cells = [dict(name=f"{dp}x{tp}", arch=arch, mesh=(dp, tp),
                  params=str(tmp_path / "params.pt"),
                  slots=JAX_ENGINE["num_slots"],
                  max_seq=JAX_ENGINE["max_seq"],
                  blocks=JAX_ENGINE["num_blocks"])
             for dp, tp in JAX_MESHES]
    res = _run(4, cells)
    for dp, tp in JAX_MESHES:
        name = f"{dp}x{tp}"
        got, want = res[name], jres[name]
        assert got["tokens"] == want["tokens"], f"{arch} {name}"
        for key in ("breakdown", "per_device", "bytes_per_token",
                    "kv_read", "kv_read_dev", "layout"):
            assert got[key] == want[key], f"{arch} {name} {key}"
        assert got["tokens"] and got["kv_read_dev"] > 0
    # The meshes cut something: the per-device cells are not the totals.
    assert res["2x2"]["per_device"] != res["2x2"]["breakdown"]
    assert res["2x2"]["kv_read_dev"] < res["2x2"]["kv_read"]
