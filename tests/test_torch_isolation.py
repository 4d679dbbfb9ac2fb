"""The port stands alone: no JAX, no ``repro`` package, no hidden CPU
fallback, no kernel build on the CPU path.

* Every module of ``repro_torch`` imports in a fresh interpreter in which
  ``import jax`` and ``import repro`` fail.
* A source scan finds no JAX import and no import of the ``repro``
  package in ``src/repro_torch`` or ``chip_smoke.py``.
* The CPU path (a reduced model's decode step under every recipe and on
  int8 pages, and its prefill, so every kernel wrapper; the MLA + MoE
  deepseek-v3 and the MoE granite-moe too) never calls the kernel build
  step (``_build``); every wrapper's library has a source.
* Architectures, families and serve flags not ported yet are refused,
  naming their ROADMAP item; the flags ported since (the prefix cache,
  the offload policy, the telemetry exports, speculative decoding) serve
  on the CPU.
* Without a card and without ``--device cpu``, the serve launcher exits
  with an error instead of running on the CPU.
"""
import re
import subprocess
import sys
import types
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
                "repro_torch.runtime.kvcache", "repro_torch.launch.serve"):
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


def test_cpu_prefill_never_builds_kernels(monkeypatch):
    cfg, model, params = _refuse_builds(monkeypatch)
    logits, cache = model.prefill(
        params, {"tokens": torch.tensor([[1, 2, 3, 4, 5]], dtype=torch.int32)})
    assert logits.shape == (1, 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits.float()).all())


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
    with pytest.raises(SystemExit):
        serve.main(["--reduced", "--device", "cpu", "--block-size", "4"]
                   + argv)
    assert "ROADMAP" in capsys.readouterr().err


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
    with pytest.raises(NotImplementedError, match="ROADMAP A16"):
        get_config("jamba-v0.1-52b")
    model = build_model(get_config("qwen3-0.6b").reduced())
    from repro_torch.runtime.engine import ServingEngine
    hybrid = types.SimpleNamespace(cfg=types.SimpleNamespace(
        family="hybrid"))
    for m, kw, item in ((hybrid, dict(block_size=4), "A16"),
                        (model, dict(block_size=4, mesh=object()), "A17")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            ServingEngine(m, {}, device="cpu", **kw)


@pytest.mark.parametrize("arch", sorted(PENDING))
def test_pending_archs_are_refused(arch):
    """Every architecture still to port names its ROADMAP item, and so
    does ``build_model`` for its family (the dense ones only miss their
    config)."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_config(arch)
    family = family_of(arch)
    if family == "dense":
        return
    import dataclasses
    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(),
                              family=family)
    with pytest.raises(NotImplementedError, match="ROADMAP A16"):
        build_model(cfg)


def test_moe_archs_are_ported():
    """deepseek-v3 (MLA + MoE) and granite-moe resolve and build."""
    for arch in ("deepseek-v3-671b", "granite-moe-3b-a800m"):
        assert arch not in PENDING and family_of(arch) == "moe"
        assert build_model(get_config(arch)).cfg.name == arch
