"""The port stands alone: no JAX, no ``repro`` package, no hidden CPU
fallback, no kernel build on the CPU path.

* Every module of ``repro_torch`` imports in a fresh interpreter in which
  ``import jax`` and ``import repro`` fail (the dry-run and analysis
  modules included), and importing them leaves no process group (the
  dry-run's fake group lives only inside ``make_production_mesh``).
* A source scan finds no JAX import and no import of the ``repro``
  package in ``src/repro_torch`` or ``chip_smoke.py``.
* The CPU path (a reduced model's decode step under every recipe and on
  int8 pages, and its prefill, so every kernel wrapper; the MLA + MoE
  deepseek-v3, the MoE granite-moe, the recurrent mamba2 and jamba and
  the conditioned whisper (encoder pass, cross attention) and qwen2-vl
  (M-RoPE, vision merge) too) never calls the kernel build step
  (``_build``); every wrapper's library has a source.
* Architectures, families and serve flags not ported yet are refused,
  naming their ROADMAP item; the flags ported since (the prefix cache,
  the offload policy, the telemetry exports, speculative decoding) serve
  on the CPU; ``--dp/--tp`` (serving meshes) take a device per rank
  unless ``--ranks-per-device`` lets ranks share one.
* Without a card and without ``--device cpu``, the serve launcher exits
  with an error instead of running on the CPU.
"""
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import (PENDING, family_of,  # noqa: E402
                                          get_config)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|"
    r"from\s+repro(\.|\s)|import\s+ml_dtypes|from\s+ml_dtypes)", re.M)


def test_every_module_imports_with_jax_and_repro_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'jax' not in [k for k, v in sys.modules.items() if v]\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
        "print(' '.join(names))\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20      # the whole package
    names = out.stdout.split()
    for mod in ("repro_torch.core.imax_model", "repro_torch.runtime.telemetry",
                "repro_torch.runtime.kvcache", "repro_torch.launch.serve",
                "repro_torch.launch.train", "repro_torch.train.data",
                "repro_torch.train.optimizer", "repro_torch.train.trainer",
                "repro_torch.train.checkpoint", "repro_torch.train.elastic",
                "repro_torch.configs.llama3_405b",
                "repro_torch.parallel.sharding", "repro_torch.launch.mesh",
                "repro_torch.launch.dryrun", "repro_torch.analysis.roofline",
                "repro_torch.analysis.extrapolate",
                "repro_torch.analysis.report", "repro_torch.analysis.power",
                "repro_torch.configs.shapes", "repro_torch.models.flags",
                "repro_torch.core.qlinear", "repro_torch.core.coalesce"):
        assert mod in names


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in PKG.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_source_imports_no_jax_and_no_repro(path):
    text = (ROOT / path).read_text()
    hits = [m.group(0).strip() for m in FORBIDDEN.finditer(text)]
    assert not hits, f"{path}: {hits}"


def _refuse_builds(monkeypatch, arch="qwen3-0.6b"):
    def refuse(*a, **kw):
        raise AssertionError("kernel builder called on the CPU path")
    monkeypatch.setattr(_build, "build_all", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    return cfg, model, model.init(gen)


def _cpu_step_without_builds(monkeypatch, quant, kv_quant="none",
                             arch="qwen3-0.6b"):
    cfg, model, params = _refuse_builds(monkeypatch, arch)
    from repro_torch.core.convert import quantize_params
    params = quantize_params(params, quant)
    shapes = model.paged_cache_shapes(2, 5, 4, kv_quant=kv_quant)
    dtypes = {"q": torch.int8, "s": torch.float16}
    cache = {n: {k: {p: torch.zeros(sp, dtype=dtypes[p])
                     for p, sp in s.items()} if isinstance(s, dict)
                 else torch.zeros(s, dtype=torch.bfloat16)
                 for k, s in leaves.items()} for n, leaves in shapes.items()}
    logits, _ = model.decode_step(
        params, torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32),
        torch.tensor([0, 4], dtype=torch.int32), cache, quant=quant,
        block_tables=torch.tensor([[0, 1], [2, 3]], dtype=torch.int32),
        lengths=torch.tensor([3, 1], dtype=torch.int32))
    assert logits.shape == (2, 3, cfg.vocab_size)
    assert bool(torch.isfinite(logits.float()).all())


def test_cpu_path_never_builds_kernels(monkeypatch):
    _cpu_step_without_builds(monkeypatch, "q8_0")


@pytest.mark.parametrize("quant", ["fp16", "q6_k", "q3_k_s"])
def test_cpu_recipes_never_build_kernels(monkeypatch, quant):
    _cpu_step_without_builds(monkeypatch, quant)


def test_cpu_int8_pages_never_build_kernels(monkeypatch):
    _cpu_step_without_builds(monkeypatch, "q8_0", kv_quant="int8")


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "granite-moe-3b-a800m"])
def test_cpu_moe_archs_never_build_kernels(monkeypatch, arch, kv_quant):
    _cpu_step_without_builds(monkeypatch, "q8_0", kv_quant=kv_quant,
                             arch=arch)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-v0.1-52b"])
def test_cpu_recurrent_archs_never_build_kernels(monkeypatch, arch):
    """mamba2 and jamba: a chunked decode step over a paged arena (state
    leaves per slot beside jamba's pages) and a prefill, q8_0."""
    from repro_torch.core.convert import quantize_params
    from repro_torch.runtime.kvcache import PagedKVArena
    cfg, model, params = _refuse_builds(monkeypatch, arch)
    params = quantize_params(params, "q8_0")
    arena = PagedKVArena(model, 2, 16, block_size=4, device="cpu")
    for _ in range(2):
        arena.alloc_slot(arena.blocks_needed(3))
    tables, _ = arena.device_tables()
    logits, _ = model.decode_step(
        params, torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32),
        torch.tensor([0, 0], dtype=torch.int32), arena.buffers,
        quant="q8_0", block_tables=tables,
        lengths=torch.tensor([3, 1], dtype=torch.int32))
    assert logits.shape == (2, 3, cfg.vocab_size)
    assert bool(torch.isfinite(logits.float()).all())
    logits, _ = model.prefill(
        params, {"tokens": torch.tensor([[1, 2, 3, 4, 5]],
                                        dtype=torch.int32)}, quant="q8_0")
    assert bool(torch.isfinite(logits.float()).all())


def test_cpu_conditioned_archs_never_build_kernels(monkeypatch):
    """whisper: the admission encoder pass, a chunked decode step over
    its pages and cross K/V, and a prefill; qwen2-vl: a decode step with
    vision rows and a prefill with vision embeddings, q8_0."""
    from repro_torch.core.convert import quantize_params
    from repro_torch.runtime.kvcache import PagedKVArena
    for arch in ("whisper-small", "qwen2-vl-2b"):
        cfg, model, params = _refuse_builds(monkeypatch, arch)
        params = quantize_params(params, "q8_0")
        arena = PagedKVArena(model, 2, 16, block_size=4, device="cpu")
        extra, batch = {}, {"tokens": torch.tensor([[1, 2, 3, 4, 5]],
                                                   dtype=torch.int32)}
        for s in range(2):
            arena.alloc_slot(arena.blocks_needed(3))
        if cfg.family == "encdec":
            frames = torch.ones((1, cfg.encoder_seq_len, cfg.d_model))
            for s in range(2):
                arena.write_prefill(model.encode_cross(params, frames,
                                                       quant="q8_0"), s)
            batch["frames"] = frames
        else:
            extra = {"embeds": torch.ones((2, 3, cfg.d_model)),
                     "embeds_mask": torch.ones((2, 3), dtype=torch.bool)}
            batch["vision_embeds"] = torch.ones((1, 4, cfg.d_model))
        tables, _ = arena.device_tables()
        logits, _ = model.decode_step(
            params, torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32),
            torch.tensor([0, 0], dtype=torch.int32), arena.buffers,
            quant="q8_0", block_tables=tables,
            lengths=torch.tensor([3, 1], dtype=torch.int32), **extra)
        assert logits.shape == (2, 3, cfg.vocab_size)
        assert bool(torch.isfinite(logits.float()).all())
        logits, _ = model.prefill(params, batch, quant="q8_0")
        assert bool(torch.isfinite(logits.float()).all())


def test_cpu_prefill_never_builds_kernels(monkeypatch):
    cfg, model, params = _refuse_builds(monkeypatch)
    logits, cache = model.prefill(
        params, {"tokens": torch.tensor([[1, 2, 3, 4, 5]], dtype=torch.int32)})
    assert logits.shape == (1, 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits.float()).all())


def test_cpu_train_step_never_builds_kernels(monkeypatch):
    """A train step (loss, gradient through the attention's plain version,
    AdamW) on the CPU reaches no kernel build."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.trainer import make_train_step
    cfg, model, params = _refuse_builds(monkeypatch)
    tok = torch.arange(12, dtype=torch.int32).reshape(2, 6)
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    _, _, m = make_train_step(model, TrainConfig(remat_policy="full"))(
        params, adamw_init(params), batch)
    assert bool(torch.isfinite(m["loss"]))


def test_every_kernel_wrapper_has_a_source():
    """Each wrapper loads a library built from ``csrc/<name>.cu``; the
    build step compiles every source, flash_attention.cu included."""
    names = set(_build.sources())
    assert names == {"q8_0_matmul", "fp16_matmul", "q6_k_matmul",
                     "q3_k_matmul", "paged_attention", "flash_attention"}
    assert len(serve.KERNELS) == 6


def test_serve_refuses_to_fall_back_to_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(SystemExit) as e:
        serve.main(["--reduced", "--quant", "q8_0", "--block-size", "4"])
    assert e.value.code != 0
    assert "--device cpu" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [["--dp", "2"]])
def test_serve_refuses_unported_features(argv, capsys):
    """No serve flag is refused as unported since serving meshes (A17)
    were ported; ``--dp 2`` on the CPU (one device) without
    ``--ranks-per-device`` is refused naming that flag, never run on a
    device it does not have."""
    with pytest.raises(SystemExit):
        serve.main(["--reduced", "--device", "cpu", "--block-size", "4"]
                   + argv)
    err = capsys.readouterr().err
    assert "needs 2 devices but only 1 visible" in err
    assert "--ranks-per-device" in err


@pytest.mark.parametrize("argv", [
    ["--prefix-cache"], ["--shared-prefix", "4"], ["--offload-policy"],
    ["--trace", "t.json"], ["--spec", "ngram"]])
def test_serve_accepts_ported_features(argv, capsys, tmp_path):
    """The flags refused until the prefix cache (A13), the IMAX offload
    model (A21a), telemetry (A11) and speculative decoding (A12) were
    ported: the reduced CPU serve takes each one and finishes its
    stream."""
    argv = [str(tmp_path / a) if a.endswith(".json") else a for a in argv]
    serve.main(["--reduced", "--device", "cpu", "--block-size", "4",
                "--quant", "q8_0", "--requests", "3", "--prompt-len", "8",
                "--gen", "3", "--arrival", "back2back"] + argv)
    out = capsys.readouterr().out
    assert "completed 3/3" in out and "bottleneck:" in out
    if "--prefix-cache" in argv:
        assert "prefix cache:" in out
    if "--trace" in argv:
        assert (tmp_path / "t.json").exists()
    if "--spec" in argv:
        assert "speculative[ngram k=4]:" in out


def test_engine_and_registry_refusals_name_the_roadmap():
    """Serving meshes (A17) are ported: the engine takes a mesh and
    refuses one the model cannot honor with the JAX package's message;
    every architecture resolves (``PENDING`` is empty since the dense
    configs, A20) and every family builds (``PENDING_FAMILIES`` is
    empty); an unknown name is a KeyError."""
    from repro_torch.models.api import PENDING_FAMILIES
    assert PENDING == {} and get_config("llama3.2-3b").name == "llama3.2-3b"
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("llama3.2-3b-instruct")
    assert PENDING_FAMILIES == {}
    from repro_torch.runtime.engine import ServingEngine
    class Mesh:                       # a 1x3 mesh, shapes only
        shape = {"data": 1, "model": 3}
        axis_names = ("data", "model")
        devices = 3
    for arch in ("qwen3-0.6b", "whisper-small", "qwen2-vl-2b"):
        model = build_model(get_config(arch).reduced())
        with pytest.raises(ValueError, match="not divisible by tp=3"):
            ServingEngine(model, {}, device="cpu", block_size=4,
                          mesh=Mesh())


@pytest.mark.parametrize("arch", ["llama3-405b", "llama3.2-3b", "qwen2-72b"])
def test_pending_archs_are_refused(arch):
    """The architectures that were pending (the dense configs, A20) are
    ported: nothing is refused any more, each resolves to its dense config
    and builds at full width."""
    assert arch not in PENDING and family_of(arch) == "dense"
    assert build_model(get_config(arch)).cfg.name == arch


@pytest.mark.parametrize("arch,family", [("mamba2-1.3b", "ssm"),
                                         ("jamba-v0.1-52b", "hybrid")])
def test_recurrent_archs_are_ported(arch, family):
    """mamba2 (ssm) and jamba (hybrid) resolve and build, and leave the
    pending list."""
    assert arch not in PENDING and family_of(arch) == family
    assert build_model(get_config(arch)).cfg.name == arch


@pytest.mark.parametrize("arch,family", [("whisper-small", "encdec"),
                                         ("qwen2-vl-2b", "vlm")])
def test_conditioned_archs_are_ported(arch, family):
    """whisper (encdec) and qwen2-vl (vlm) resolve and build at full
    width, and leave the pending lists; whisper's model has the
    admission encoder pass."""
    assert arch not in PENDING and family_of(arch) == family
    model = build_model(get_config(arch))
    assert model.cfg.name == arch
    assert (model.encode_cross is not None) == (family == "encdec")


def test_moe_archs_are_ported():
    """deepseek-v3 (MLA + MoE) and granite-moe resolve and build."""
    for arch in ("deepseek-v3-671b", "granite-moe-3b-a800m"):
        assert arch not in PENDING and family_of(arch) == "moe"
        assert build_model(get_config(arch)).cfg.name == arch
