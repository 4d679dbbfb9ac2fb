"""Port vs JAX package: paged decode attention and the paged insert.

The port's paged attention on CPU tensors (the plain version its CUDA
kernel is held against on the card) against the JAX package's Pallas
kernel in interpret mode, in f32, at chunk widths {1, 4, block_size + 1}
with fragmented, permuted and partly null block tables and mixed
per-row lengths. Only valid rows are compared (rows past a slot's length
are garbage by contract on both sides), at
``tests/test_paged_attention_kernel.py``'s ``FP32_TOL``: blocked online
softmax vs one dense softmax is the same math in another order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels.paged_attention import (  # noqa: E402
    paged_decode_attention as jax_paged)
from repro.models import attention as jattn  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_decode_attention)
from repro_torch.models import attention as tattn  # noqa: E402

FP32_TOL = dict(atol=2e-6, rtol=2e-5)
B, H, HKV, D, BS, MB = 3, 8, 2, 16, 4, 6
NB = B * MB


def _tables(rng, owned):
    """Each slot's logical blocks map to a random disjoint subset of the
    physical pages in shuffled order; entries past ``owned[i]`` hold the
    null page id NB."""
    perm = rng.permutation(NB)
    t = np.full((B, MB), NB, np.int32)
    for i in range(B):
        t[i, :owned[i]] = perm[i * MB:i * MB + owned[i]]
    return t


def _case(chunk, seed):
    rng = np.random.RandomState(seed)
    owned = [MB, 3, 2]
    tables = _tables(rng, owned)
    kp = rng.randn(NB + 1, BS, HKV, D).astype(np.float32)
    vp = rng.randn(NB + 1, BS, HKV, D).astype(np.float32)
    q = rng.randn(B, chunk, H, D).astype(np.float32)
    lens = np.array([chunk, max(chunk - 2, 1), 1], np.int32)
    pos = np.array([max(o * BS - chunk, 0) for o in owned], np.int32)
    return q, kp, vp, tables, pos, lens


def _run_both(q, kp, vp, tables, pos, lens):
    sm = D ** -0.5
    out_j = np.asarray(jax_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(pos), sm_scale=sm, lengths=jnp.asarray(lens),
        interpret=True))
    t = torch.from_numpy
    out_t = paged_decode_attention(t(q), t(kp), t(vp), t(tables), t(pos),
                                   sm_scale=sm, lengths=t(lens)).numpy()
    return out_j, out_t


def _assert_valid_rows(out_a, out_b, lens, **tol):
    for b, n in enumerate(lens):
        np.testing.assert_allclose(out_a[b, :n], out_b[b, :n], **tol)


@pytest.mark.parametrize("chunk", [1, 4, 5])          # 5 == block_size + 1
def test_plain_matches_pallas(chunk):
    q, kp, vp, tables, pos, lens = _case(chunk, seed=chunk)
    out_j, out_t = _run_both(q, kp, vp, tables, pos, lens)
    assert out_t.shape == (B, chunk, H, D) and out_t.dtype == np.float32
    _assert_valid_rows(out_t, out_j, lens, **FP32_TOL)


def test_dead_pages_trashed_change_nothing():
    """Huge garbage in every page no valid query can reach (and in the
    null page) leaves the valid rows bit-identical in the port, and the
    port still matches the Pallas kernel on the trashed arena."""
    chunk = 3
    q, kp, vp, tables, pos, lens = _case(chunk, seed=11)
    base_j, base_t = _run_both(q, kp, vp, tables, pos, lens)
    live = set()
    for b in range(B):
        last = (pos[b] + max(lens[b], 1) - 1) // BS
        live.update(int(p) for p in tables[b, :last + 1])
    dead = [p for p in range(NB + 1) if p not in live]
    assert NB in dead and len(dead) > 1
    kt, vt = kp.copy(), vp.copy()
    kt[dead] = 1e9
    vt[dead] = -1e9
    trash_j, trash_t = _run_both(q, kt, vt, tables, pos, lens)
    for b, n in enumerate(lens):
        np.testing.assert_array_equal(trash_t[b, :n], base_t[b, :n])
    _assert_valid_rows(trash_t, trash_j, lens, **FP32_TOL)
    _assert_valid_rows(trash_t, base_j, lens, **FP32_TOL)


@pytest.mark.parametrize("chunk", [1, 4, 5])
def test_paged_insert_matches_jax_drop(chunk):
    """The in-place insert leaves exactly the pages the JAX ``mode="drop"``
    scatter produces: valid entries land through the table, entries past a
    row's length (and every entry of an idle, all-null row) are dropped —
    the null page included."""
    rng = np.random.RandomState(20 + chunk)
    b = 4
    tables = np.full((b, MB), NB, np.int32)
    perm = rng.permutation(NB)
    for i, own in enumerate([MB, 3, 2]):
        tables[i, :own] = perm[i * MB:i * MB + own]
    pos = np.array([MB * BS - chunk, 3, 1, 0], np.int32)
    lens = np.array([chunk, min(chunk, 2), 1, 0], np.int32)
    pages = rng.randn(NB + 1, BS, HKV, D).astype(np.float32)
    new = rng.randn(b, chunk, HKV, D).astype(np.float32)
    want = np.asarray(jattn.paged_insert_token(
        jnp.asarray(pages), jnp.asarray(new), jnp.asarray(pos),
        jnp.asarray(tables), jnp.asarray(lens)))
    got = torch.from_numpy(pages.copy())
    out = tattn.paged_insert_token(got, torch.from_numpy(new),
                                   torch.from_numpy(pos),
                                   torch.from_numpy(tables),
                                   torch.from_numpy(lens))
    assert out is got                                   # in place
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("chunk", [1, 4, 5])
def test_gqa_decode_fused_and_ref_agree(chunk):
    """Layer level on the port: the ``fused`` path (kernel wrapper) and the
    ``ref`` gather path write the same pages and give the same valid rows."""
    cfg = get_config("qwen3-0.6b").reduced()
    gen = torch.Generator().manual_seed(chunk)
    p = tattn.gqa_init(gen, cfg, "q8_0")
    hd, hkv = cfg.resolved_head_dim(), cfg.num_kv_heads
    rng = np.random.RandomState(7)
    tables = torch.from_numpy(_tables(rng, [MB, MB, MB]))
    cache = {k: torch.from_numpy(rng.randn(NB + 1, BS, hkv, hd)
                                 .astype(np.float32)) for k in ("k", "v")}
    x = torch.from_numpy(rng.randn(B, chunk, cfg.d_model).astype(np.float32))
    pos = torch.tensor([5, 9, 2], dtype=torch.int32)
    lens = torch.tensor([chunk, max(chunk - 2, 1), chunk], dtype=torch.int32)
    outs = {}
    for impl in ("fused", "ref"):
        c = {k: v.clone() for k, v in cache.items()}
        outs[impl] = tattn.gqa_decode(p, cfg, x, pos, c, fmt="q8_0",
                                      block_tables=tables, lengths=lens,
                                      paged_impl=impl)
    (of, cf), (orf, cr) = outs["fused"], outs["ref"]
    for leaf in ("k", "v"):
        assert torch.equal(cf[leaf], cr[leaf])
    _assert_valid_rows(of.numpy(), orf.numpy(), lens.tolist(), **FP32_TOL)


def test_wrapper_refuses_bad_operands():
    q, kp, vp, tables, pos, lens = (torch.from_numpy(a) for a in
                                    _case(2, seed=3))
    with pytest.raises(ValueError):
        paged_decode_attention(q, kp, vp[:, :, :1], tables, pos,
                               sm_scale=1.0, lengths=lens)
    with pytest.raises(ValueError):
        paged_decode_attention(q, kp, vp, tables[:2], pos, sm_scale=1.0,
                               lengths=lens)
    meta = [t.to("meta") for t in (q, kp, vp, tables, pos, lens)]
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_attention(*meta[:5], sm_scale=1.0, lengths=meta[5])
    before = paged_decode_attention.launches
    paged_decode_attention(q, kp, vp, tables, pos, sm_scale=1.0,
                           lengths=lens)                 # CPU: plain
    assert paged_decode_attention.launches == before
