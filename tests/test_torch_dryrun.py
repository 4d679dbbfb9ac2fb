"""The port's dry-run and analysis package (``launch/dryrun.py``,
``analysis/*``, the training half of ``parallel/sharding.py``) and the
modules it reaches, held against the JAX package.

* The training rules (``weight_spec``, ``batch_spec``, ``cache_spec``,
  ``activation_sharding``) give the JAX package's specs on its own rule
  cases and on every leaf of every assigned config's abstract
  parameters, on 16x16 and 2x16x16 (the JAX test's shape-only mesh).
* ``abstract_params`` equals ``jax.eval_shape`` of the JAX init leaf for
  leaf (a layer group's per-layer leaves stacked), shapes and dtypes;
  ``input_specs``, ``SHAPES`` and ``model_flops_for`` equal JAX's.
* The per-group differencing (``extrapolate``) equals the full count on
  reduced deepseek-v3 (dense and MoE groups) and jamba.
* A reduced qwen3 cell on a 2x2 fake mesh writes the JAX cell's keys,
  its collectives include the FSDP all-gathers over 'data', its local
  tensors are fake (no storage), and the fake group is gone after it.
* ``mixed_intermediates`` on the plain chunked and decode attention and
  the SSD against the JAX functions under ``use_mixed_intermediates``
  (f32 tolerance 2e-5: the same bf16 roundings, f32 sums in another
  order); ``coalesce_planes``/``split_planes`` byte-exact and equal to
  JAX's buffer and manifest; ``apply_qlinear`` within 2e-5 of JAX's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

torch = pytest.importorskip("torch")

from repro.analysis import roofline as jroofline  # noqa: E402
from repro.configs.registry import ASSIGNED as JASSIGNED  # noqa: E402
from repro.configs.shapes import SHAPES as JSHAPES  # noqa: E402
from repro.core import coalesce as jcoalesce  # noqa: E402
from repro.core import qlinear as jqlinear  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import flags as jflags  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.api import build_model as jbuild  # noqa: E402
from repro.parallel import sharding as jrules  # noqa: E402
from repro_torch.analysis import extrapolate, report, roofline  # noqa: E402
from repro_torch.configs.registry import ASSIGNED, get_config  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.core import coalesce, qlinear  # noqa: E402
from repro_torch.core.quant import pack  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as meshes  # noqa: E402
from repro_torch.models import attention, flags, ssm  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402

F32_TOL = dict(rtol=2e-5, atol=2e-5)


class _FakeMesh:
    """The JAX test's shape-only mesh."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESH2D = _FakeMesh({"data": 16, "model": 16})
MESH3D = _FakeMesh({"pod": 2, "data": 16, "model": 16})


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------------
# The training rules
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape", [
    (4096, 8192), (128256, 1024), (49155, 1536), (28, 3072, 8192),
    (58, 256, 2048, 7168), (1024,), (28, 7, 128)])
def test_weight_spec_equals_jax(shape):
    """The JAX test's weight cases (tests/test_sharding_offload.py)."""
    for m in (MESH2D, MESH3D):
        assert P(*sharding.weight_spec(shape, m)) == \
            jrules.weight_spec(shape, m)


def test_cache_batch_activation_specs_equal_jax():
    """The JAX test's cache cases, and batch, activation and replicated
    specs on both meshes (a two-axis entry as JAX's tuple)."""
    for key, shape in (("k", (28, 128, 32768, 8, 128)),
                       ("v", (4, 1, 524288, 8, 128)),
                       ("ssm", (48, 128, 64, 128, 64)),
                       ("ckv", (61, 128, 32768, 512)),
                       ("conv", (48, 3, 3, 4096))):
        for m in (MESH2D, MESH3D):
            assert P(*sharding.cache_spec(key, shape, m)) == \
                jrules.cache_spec(key, shape, m), (key, shape)
    for shape in ((256, 4096), (32, 1), (1, 1), (100, 8)):
        for m in (MESH2D, MESH3D):
            assert P(*sharding.batch_spec(shape, m)) == \
                jrules.batch_spec(shape, m)
    for sp in (True, False):
        assert sharding.activation_spec(MESH3D, sp) == \
            (("pod", "data"), "model" if sp else None, None)
        assert sharding.activation_spec(MESH2D, sp) == \
            ("data", "model" if sp else None, None)
    assert sharding.dp_axes(MESH3D) == jrules.dp_axes(MESH3D)


def _jax_leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            (tuple(x.shape), str(x.dtype))
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _stacked(tree):
    """The port's tree in the JAX layout: each layer group's per-layer
    leaves as one (layers, ...) leaf."""
    out = {}

    def walk(node, path, layers=None):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,), layers)
        elif isinstance(node, list):
            walk(node[0], path, len(node))
        else:
            shape = tuple(node.shape) if layers is None else \
                (layers,) + tuple(node.shape)
            out["/".join(path)] = (shape,
                                   str(node.dtype).replace("torch.", ""))
    walk(tree, ())
    return out


@pytest.mark.parametrize("arch", list(JASSIGNED))
def test_rules_equal_jax_on_every_leaf(arch):
    """Every leaf of the config's abstract parameters (each per-layer
    leaf takes its stacked leaf's spec less the layer axis), and every
    cell's batch and cache specs, on 16x16 and 2x16x16."""
    jparams = jbuild(JASSIGNED[arch]).abstract_params()
    model = build_model(ASSIGNED[arch])
    tparams = model.abstract_params()
    for m in (MESH2D, MESH3D):
        for path, (shape, _) in _jax_leaves(jparams).items():
            assert P(*sharding.weight_spec(shape, m)) == \
                jrules.weight_spec(shape, m), (path, shape)
        want = {p: jrules.weight_spec(s, m)
                for p, (s, _) in _jax_leaves(jparams).items()}
        specs = sharding.param_specs(tparams, m)
        groups = {k for k, v in tparams.items() if isinstance(v, list)}
        for path, spec in _leaf_specs(specs).items():
            w = tuple(want[path])
            if path.split("/")[0] in groups:
                w = w[1:]
            assert _trim(spec) == _trim(w), (path, spec, w)
        jmodel = jbuild(JASSIGNED[arch])
        for name, shape in SHAPES.items():
            if shape.kind == "decode":
                tc = model.input_specs(shape)["cache"]
                jc = jmodel.input_specs(JSHAPES[name])["cache"]
                for path, (s, _) in _jax_leaves(jc).items():
                    key = path.split("/")[-1]
                    assert P(*sharding.cache_spec(key, s, m)) == \
                        jrules.cache_spec(key, s, m)
                assert _jax_leaves(jc) == _stacked(tc)


def _trim(spec):
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _leaf_specs(specs):
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, list):
            walk(node[0], path)
        else:
            out["/".join(path)] = node
    walk(specs, ())
    return out


@pytest.mark.parametrize("arch", list(JASSIGNED))
def test_abstract_params_equal_jax(arch):
    """``abstract_params`` (meta tensors) against ``jax.eval_shape`` of
    the JAX init, leaf for leaf, shapes and dtypes, unquantized and in
    q3_k_s (a K-quant: padded planes)."""
    for quant in ("none", "q3_k_s"):
        t = build_model(ASSIGNED[arch]).abstract_params(quant)
        assert all(x.device.type == "meta"
                   for x in _leaf_specs(t).values())
        j = jbuild(JASSIGNED[arch]).abstract_params(quant)
        assert _stacked(t) == _jax_leaves(j), (arch, quant)


def test_shapes_input_specs_and_model_flops_equal_jax():
    """SHAPES, ``shape_applicable``, every cell's ``input_specs`` and
    ``model_flops_for`` against the JAX package's."""
    from repro.configs.shapes import shape_applicable as japplicable
    from repro_torch.configs.shapes import shape_applicable
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JSHAPES.items()}
    for arch, cfg in ASSIGNED.items():
        model, jmodel = build_model(cfg), jbuild(JASSIGNED[arch])
        for name, shape in SHAPES.items():
            assert shape_applicable(cfg.subquadratic, shape) == \
                japplicable(JASSIGNED[arch].subquadratic, JSHAPES[name])
            assert roofline.model_flops_for(cfg, shape) == \
                jroofline.model_flops_for(JASSIGNED[arch], JSHAPES[name])
            if shape.kind == "decode":
                continue               # caches: test_rules_equal_jax_...
            assert _stacked(model.input_specs(shape)) == \
                _jax_leaves(jmodel.input_specs(JSHAPES[name]))


# ----------------------------------------------------------------------
# The dry-run on small fake meshes
# ----------------------------------------------------------------------
SMALL = {"train_4k": ShapeSpec("train_4k", 16, 8, "train"),
         "prefill_32k": ShapeSpec("prefill_32k", 32, 4, "prefill"),
         "decode_32k": ShapeSpec("decode_32k", 32, 8, "decode"),
         "long_500k": ShapeSpec("long_500k", 64, 1, "decode")}


@pytest.fixture
def small(monkeypatch):
    """run_cell on a 2x2 fake mesh, reduced configs, SMALL shapes."""
    monkeypatch.setattr(dryrun, "make_production_mesh",
                        lambda multi_pod=False: meshes.make_fake_mesh(
                            (2, 2, 2) if multi_pod else (2, 2),
                            ("pod", "data", "model") if multi_pod
                            else ("data", "model")))
    monkeypatch.setattr(dryrun, "get_config",
                        lambda a: get_config(a).reduced())
    monkeypatch.setattr(dryrun, "SHAPES", SMALL)


@pytest.mark.parametrize("arch,layers,kind", [
    ("deepseek-v3-671b", 4, "prefill_32k"), ("jamba-v0.1-52b", 16,
                                             "decode_32k")])
def test_extrapolate_equals_full_count(arch, layers, kind):
    """The L/L+1 differencing equals the full config's eager count
    (flops, bytes and every collective) on reduced configs: deepseek-v3's
    prefill (2 dense + 2 MoE layers: two groups) and jamba's decode step
    (2 blocks of 8 sub-layers)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), num_layers=layers)
    if cfg.moe is not None and cfg.family != "hybrid":
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, first_dense_layers=2))
    shape = SMALL[kind]
    with meshes.make_fake_mesh((2, 2), ("data", "model")) as mesh:
        full = dryrun.lower_cell(cfg, shape, mesh).counts
        corr = extrapolate.extrapolate(
            cfg, lambda c: dryrun.lower_cell(c, shape, mesh))
    assert corr["flops"] == full["flops"] > 0
    assert corr["bytes"] == full["bytes"]
    assert corr["collectives"] == full["collectives"]
    assert extrapolate.variant_cfgs(cfg)[2] == (
        {"dense": 2, "moe": 2} if arch.startswith("deepseek") else
        {"blocks": 2})


def test_reduced_cell_writes_the_jax_keys(small, tmp_path):
    """A reduced qwen3 train cell through ``main`` on a 2x2 fake mesh:
    the JSON has the JAX cell's keys, its collectives hold the FSDP
    all-gathers over 'data', its step ran on fake local tensors, and no
    process group outlives it; long_500k is skipped for a full-attention
    arch, as the JAX dry-run's."""
    import json
    keys = {"arch", "shape", "multi_pod", "quant", "seq_parallel", "remat",
            "mixed", "raw", "extrapolate_s", "compile_s", "params_total",
            "params_active"} | set(jroofline.Roofline(
                0, 0, 0, {}, 1).to_dict())
    with pytest.raises(SystemExit) as ex:
        dryrun.main(["--arch", "qwen3-0.6b", "--shape", "train_4k",
                     "--out-dir", str(tmp_path)])
    assert ex.value.code == 0
    (name,) = [f.name for f in tmp_path.glob("*.json")]
    assert name == dryrun.cell_filename("qwen3-0.6b", "train_4k", False,
                                        "none")
    cell = json.loads((tmp_path / name).read_text())
    assert set(cell) == keys, set(cell) ^ keys
    assert cell["n_devices"] == 4 and cell["flops_per_device"] > 0
    assert set(cell["raw"]) == set(jroofline.Roofline(
        0, 0, 0, {}, 1).to_dict())
    assert "skipped" in dryrun.run_cell("qwen3-0.6b", "long_500k")
    assert not torch.distributed.is_initialized()
    cfg = get_config("qwen3-0.6b").reduced()
    with meshes.make_fake_mesh((2, 2), ("data", "model")) as mesh:
        low = dryrun.lower_cell(cfg, SMALL["prefill_32k"], mesh)
        with pytest.raises(RuntimeError, match="process group"):
            with meshes.make_production_mesh():
                pass
    assert low.by_axis["data"]["all-gather"] > 0
    assert low.argument_bytes > 0 and low.temp_bytes > 0
    assert not torch.distributed.is_initialized()


def test_local_shards_are_fake(small):
    """Parameters placed on the mesh are DTensors over fake local
    tensors (nothing allocated), cut as ``param_specs`` says."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    from torch.distributed.tensor import DTensor, Shard
    model = build_model(get_config("qwen3-0.6b").reduced())
    abs_ = model.abstract_params()
    with meshes.make_fake_mesh((2, 2), ("data", "model")) as mesh, \
            FakeTensorMode():
        pl = sharding.param_shardings(abs_, mesh)
        params = dryrun._distribute(abs_, pl, mesh)
        w = params["layers0"][0]["attn"]["q"]["w"]
        assert isinstance(w, DTensor)
        assert isinstance(w.to_local(), FakeTensor)
        assert tuple(w.placements) == (Shard(1), Shard(0))
        assert tuple(w.to_local().shape) == (w.shape[0] // 2,
                                             w.shape[1] // 2)


def test_report_reads_the_ports_cells(small, tmp_path, capsys):
    """``analysis.report`` renders the port's cells (a copy of the JAX
    report's tables)."""
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "mamba2-1.3b", "--shape", "long_500k",
                     "--out-dir", str(tmp_path), "--no-extrapolate"])
    cells = report.load_cells(tmp_path)
    table = report.roofline_table(cells)
    assert "mamba2-1.3b | long_500k" in table
    assert "(missing)" not in report.dryrun_table(cells, False).split(
        "mamba2-1.3b | long_500k")[1].splitlines()[0]


# ----------------------------------------------------------------------
# mixed_intermediates on the plain paths
# ----------------------------------------------------------------------
def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def test_mixed_chunked_attention_matches_jax():
    """The plain chunked attention (B7's plain version) under the flag
    against the JAX function's (one KV block: the same roundings)."""
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(2, 12, 4, 16).astype(np.float32),
               rng.randn(2, 12, 2, 16).astype(np.float32),
               rng.randn(2, 12, 2, 16).astype(np.float32))
    with jflags.use_mixed_intermediates():
        want = jattn.chunked_attention(q, k, v, causal=True, sm_scale=0.25)
    with flags.use_mixed_intermediates():
        got = ref.attention_ref(_t(q), _t(k), _t(v), causal=True,
                                sm_scale=0.25)
    plain = ref.attention_ref(_t(q), _t(k), _t(v), causal=True,
                              sm_scale=0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    assert not torch.equal(got, plain)          # the flag changed it


def test_mixed_decode_attention_matches_jax():
    """``decode_attention`` on a bf16 cache under the flag."""
    rng = np.random.RandomState(1)
    q = rng.randn(3, 2, 4, 16).astype(np.float32)
    k = rng.randn(3, 10, 2, 16).astype(np.float32)
    v = rng.randn(3, 10, 2, 16).astype(np.float32)
    kv_len = np.array([[4, 5], [9, 10], [1, 2]], np.int32)
    jk, jv = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
    with jflags.use_mixed_intermediates():
        want = jattn.decode_attention(q, jk, jv, sm_scale=0.25,
                                      kv_len=kv_len)
    tk, tv = _t(k).to(torch.bfloat16), _t(v).to(torch.bfloat16)
    with flags.use_mixed_intermediates():
        got = attention.decode_attention(_t(q), tk, tv, sm_scale=0.25,
                                         kv_len=torch.from_numpy(kv_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_mixed_ssd_matches_jax():
    """``ssd_chunked`` under the flag: output and final state."""
    rng = np.random.RandomState(2)
    b, l, h, p, g, n = 2, 10, 4, 8, 2, 6
    x = rng.randn(b, l, h, p).astype(np.float32)
    dt = np.abs(rng.randn(b, l, h)).astype(np.float32) * 0.5
    a = -np.abs(rng.randn(h)).astype(np.float32)
    bm, cm = (rng.randn(b, l, g, n).astype(np.float32) for _ in range(2))
    with jflags.use_mixed_intermediates():
        wy, ws = jssm.ssd_chunked(x, dt, a, bm, cm, 4)
    with flags.use_mixed_intermediates():
        gy, gs = ssm.ssd_chunked(_t(x), _t(dt), _t(a), _t(bm), _t(cm), 4)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **F32_TOL)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **F32_TOL)


# ----------------------------------------------------------------------
# core.coalesce and core.qlinear
# ----------------------------------------------------------------------
FORMATS = ("fp16", "q8_0", "q6_k", "q3_k")


@pytest.mark.parametrize("fmt", FORMATS)
def test_coalesce_planes_equal_jax(fmt):
    """The port's buffer and manifest are the JAX package's, and
    ``split_planes`` gives every plane back byte for byte."""
    from repro.core.quant import pack as jpack
    w = np.random.RandomState(3).randn(16, 512).astype(np.float32)
    jplanes = jpack.quantize(jnp.asarray(w), fmt)
    tplanes = pack.quantize(_t(w), fmt)
    jbuf, jman = jcoalesce.coalesce_planes(jplanes)
    tbuf, tman = coalesce.coalesce_planes(tplanes)
    assert tbuf.dtype == torch.uint8
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    assert tman == [dict(e, shape=tuple(e["shape"])) for e in jman]
    back = coalesce.split_planes(tbuf, tman)
    assert set(back) == set(tplanes)
    for k, v in tplanes.items():
        assert back[k].dtype == v.dtype
        assert torch.equal(back[k].view(torch.uint8),
                           v.contiguous().view(torch.uint8))


@pytest.mark.parametrize("fmt", ("none",) + FORMATS)
def test_apply_qlinear_equals_jax(fmt):
    """``apply_qlinear`` (bf16 x, bias, out f32) against JAX's within
    2e-5 (the same dequantized weights, f32 sums in another order)."""
    rng = np.random.RandomState(4)
    w = rng.randn(24, 256).astype(np.float32) * 0.05
    x = rng.randn(3, 5, 256).astype(np.float32)
    bias = rng.randn(24).astype(np.float32)
    jp = jqlinear.quantize_weight(jnp.asarray(w), fmt)
    tp = qlinear.quantize_weight(_t(w), fmt)
    jx = jnp.asarray(x, jnp.bfloat16)
    want = jqlinear.apply_qlinear(jp, jx, fmt, bias=jnp.asarray(bias),
                                  out_dtype=jnp.float32)
    got = qlinear.apply_qlinear(tp, _t(x).to(torch.bfloat16), fmt,
                                bias=_t(bias), out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    spec = qlinear.QLinearSpec("l", 256, 24, fmt)
    assert spec.weight_bytes == jqlinear.QLinearSpec(
        "l", 256, 24, fmt).weight_bytes
