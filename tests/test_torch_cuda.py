"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with the CUDA toolkit (the first one
builds the kernels into ``build/``); without a card each one skips. On
the card:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py

Tolerances: the matmuls (fp16, q8_0, q6_k, q3_k) do the plain version's
f32 products in another summation order (the repo's 2e-5 of
tests/test_kernels.py, relative to the output's scale); paged attention
in f32 is the blocked online vs dense softmax reorder (FP32_TOL of
tests/test_paged_attention_kernel.py; the MLA form at full width takes
atol 1e-5, see its test).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.quant import pack  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_decode_attention)
from repro_torch.kernels.ops import MATMUL_KERNELS  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    matmul_ref, paged_attention_ref)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _check_matmul(cuda, fmt, m, n, k, dtype):
    """One wrapper against the plain version: NaN-free, within 2e-5 of the
    output's scale, bf16 output the f32 output rounded once, and exactly
    one launch counted per call."""
    wrapper, layout = MATMUL_KERNELS[fmt]
    gen = torch.Generator(device=cuda).manual_seed(m + n + k)
    x = torch.randn((m, k), generator=gen, device=cuda).to(getattr(torch,
                                                                     dtype))
    planes = pack.quantize(torch.randn((n, k), generator=gen, device=cuda)
                           * 0.05, fmt)
    args = [planes[name] for name in layout]
    before = wrapper.launches
    y = wrapper(x, *args)
    y16 = wrapper(x, *args, out_dtype=torch.bfloat16)
    assert wrapper.launches == before + 2
    ref = matmul_ref(x, planes, fmt)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all())
    tol = 2e-5 * max(1.0, float(ref.abs().max()))
    assert float((y - ref).abs().max()) <= tol
    assert torch.equal(y16, y.to(torch.bfloat16))     # rounded once


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mnk", [(1, 64, 32), (3, 1000, 96), (64, 1024, 1024),
                                 (70, 300, 2048)])
def test_matmul_q8_0_matches_plain(cuda, mnk, dtype):
    _check_matmul(cuda, "q8_0", *mnk, dtype)


# (M, N, K): one sub-block row, a ragged M and N, the serving shape, a
# ragged M with qwen3-0.6b's d_ff, and qwen3-8b's d_ff.
KQUANT_SHAPES = [(1, 64, 256), (3, 1000, 512), (64, 1024, 1024),
                 (70, 300, 3072), (64, 1024, 12288)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mnk", KQUANT_SHAPES)
@pytest.mark.parametrize("fmt", ["q6_k", "q3_k"])
def test_matmul_kquant_matches_plain(cuda, fmt, mnk, dtype):
    _check_matmul(cuda, fmt, *mnk, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mnk", KQUANT_SHAPES + [(5, 200, 104),
                                                 (3, 1000, 100)])
def test_matmul_fp16_matches_plain(cuda, mnk, dtype):
    """Also K % 32 != 0 (a masked K tail), with rows 16-byte aligned
    (K = 104) and not (K = 100, element-wise loads)."""
    _check_matmul(cuda, "fp16", *mnk, dtype)


def _check_paged(cuda, chunk, dtype, h, hkv, d, bs, launches=1):
    """Fragmented, permuted and partly null tables, mixed lengths; the
    kernel against the plain version on the valid rows."""
    b, mb = 3, 6
    nb = b * mb
    rng = np.random.RandomState(chunk)
    perm = rng.permutation(nb)
    owned = [mb, 3, 2]
    tables = np.full((b, mb), nb, np.int32)
    for i in range(b):
        tables[i, :owned[i]] = perm[i * mb:i * mb + owned[i]]
    lens = np.array([chunk, max(chunk - 2, 1), 1], np.int32)
    pos = np.array([max(o * bs - chunk, 0) for o in owned], np.int32)
    dt = getattr(torch, dtype)
    t = lambda a: torch.from_numpy(a).to(cuda)     # noqa: E731
    q = t(rng.randn(b, chunk, h, d).astype(np.float32)).to(dt)
    kp = t(rng.randn(nb + 1, bs, hkv, d).astype(np.float32)).to(dt)
    vp = t(rng.randn(nb + 1, bs, hkv, d).astype(np.float32)).to(dt)
    args = (q, kp, vp, t(tables), t(pos))
    outs = [paged_decode_attention(*args, sm_scale=d ** -0.5, lengths=t(lens))
            for _ in range(launches)]
    ref = paged_attention_ref(*args, sm_scale=d ** -0.5)
    torch.cuda.synchronize()
    tol = dict(rtol=2e-5, atol=2e-6) if dtype == "float32" else \
        dict(rtol=2 ** -7, atol=1e-3)          # one bf16 ulp of the output
    for out in outs:
        for i, n in enumerate(lens):
            torch.testing.assert_close(out[i, :n].float(), ref[i, :n].float(),
                                       **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [1, 4, 5])
def test_paged_attention_matches_plain(cuda, chunk, dtype):
    _check_paged(cuda, chunk, dtype, h=8, hkv=2, d=64, bs=4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_qwen3_8b_widths(cuda, dtype):
    """qwen3-8b's G = 4, D = 128 at chunk 8 and block 16 needs more than
    48 KB of shared memory per block: the kernel's opt-in path, launched
    twice (the opt-in is set once per instantiation)."""
    from repro_torch.kernels.paged_attention import _lib
    assert _lib().paged_attention_gqa_smem(8, 32, 8, 128, 16) > 48 * 1024
    _check_paged(cuda, 8, dtype, h=32, hkv=8, d=128, bs=16, launches=2)


# (B, Sq, Skv, H, Hkv, D, causal, q_offset): qwen3-0.6b's prefill at
# full width, a ragged tile, non-causal, a chunk at an offset, and
# qwen3-8b's widths.
FLASH_SHAPES = [(8, 512, 512, 16, 8, 128, True, 0),
                (8, 500, 500, 16, 8, 128, True, 0),
                (2, 200, 200, 16, 8, 128, False, 0),
                (2, 64, 300, 16, 8, 128, True, 236),
                (1, 2048, 2048, 32, 8, 128, True, 0)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_attention_matches_plain(cuda, shape, dtype):
    """f32: the blocked online vs dense softmax reorder (1e-4 of
    tests/test_kernels.py); bf16: the f32 result rounded once, so one
    bf16 ulp of the output."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_ref
    b, sq, skv, h, hkv, d, causal, off = shape
    gen = torch.Generator(device=cuda).manual_seed(sq + skv)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn((b, s, n, d), generator=gen, device=cuda).to(dt)
               for s, n in ((sq, h), (skv, hkv), (skv, hkv)))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, q_offset=off)
    assert flash_attention.launches == before + 1
    ref = attention_ref(q, k, v, causal=causal, q_offset=off)
    torch.cuda.synchronize()
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else \
        dict(rtol=2 ** -7, atol=1e-3)
    assert out.dtype == dt and bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out.float(), ref.float(), **tol)


def test_flash_attention_value_width_and_unseen_keys(cuda):
    """Dv != D, and keys past the causal horizon (q_offset + Sq - 1) full
    of NaN are never loaded: the output equals attention over the K/V
    cut at the horizon."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_ref
    gen = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn((2, 100, 8, 192), generator=gen, device=cuda)
    k = torch.randn((2, 130, 2, 192), generator=gen, device=cuda)
    v = torch.randn((2, 130, 2, 128), generator=gen, device=cuda)
    k[:, 120:] = float("nan")
    v[:, 120:] = float("nan")
    out = flash_attention(q, k, v, causal=True, q_offset=20)
    ref = attention_ref(q, k[:, :120], v[:, :120], causal=True, q_offset=20)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


def test_flash_attention_refuses_grad(cuda):
    from repro_torch.kernels.flash_attention import flash_attention
    q = torch.randn((1, 8, 2, 16), device=cuda, requires_grad=True)
    k = torch.randn((1, 8, 2, 16), device=cuda)
    with pytest.raises(NotImplementedError, match="backward"):
        flash_attention(q, k, k)


def _int8_pages(cuda, b, chunk, h, hkv, d, bs):
    """The paged case of _check_paged with int8 codes and fp16 scale
    pages quantized from normal K/V."""
    from repro_torch.models.attention import quantize_kv
    mb = 6
    nb = b * mb
    rng = np.random.RandomState(chunk + h)
    perm = rng.permutation(nb)
    owned = [mb] + [int(x) for x in rng.randint(1, mb + 1, size=b - 1)]
    tables = np.full((b, mb), nb, np.int32)
    for i in range(b):
        tables[i, :owned[i]] = perm[i * mb:i * mb + owned[i]]
    lens = np.array([chunk] + [max(chunk - i, 1) for i in range(1, b)],
                    np.int32)
    pos = np.array([max(o * bs - chunk, 0) for o in owned], np.int32)
    t = lambda a: torch.from_numpy(a).to(cuda)     # noqa: E731
    kq, ks = quantize_kv(t(rng.randn(nb + 1, bs, hkv, d).astype(np.float32)))
    vq, vs = quantize_kv(t(rng.randn(nb + 1, bs, hkv, d).astype(np.float32)))
    q = t(rng.randn(b, chunk, h, d).astype(np.float32))
    return dict(q=q, kq=kq, ks=ks, vq=vq, vs=vs, tables=t(tables),
                pos=t(pos), lens=t(lens), np_lens=lens)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [(3, 4, 8, 2, 64, 4),
                                  (8, 8, 16, 8, 128, 16)])
def test_paged_attention_int8_matches_plain(cuda, case, dtype):
    """The int8 form at a small shape and at the serving decode shape
    (B = 8, C = 8, H = 16, Hkv = 8, D = 128, bs = 16)."""
    c = _int8_pages(cuda, *case)
    q = c["q"].to(getattr(torch, dtype))
    args = (q, c["kq"], c["vq"], c["tables"], c["pos"])
    kw = dict(sm_scale=case[4] ** -0.5, k_scales=c["ks"], v_scales=c["vs"])
    out = paged_decode_attention(*args, lengths=c["lens"], **kw)
    ref = paged_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    tol = dict(rtol=2e-5, atol=2e-6) if dtype == "float32" else \
        dict(rtol=2 ** -7, atol=1e-3)
    for i, n in enumerate(c["np_lens"]):
        torch.testing.assert_close(out[i, :n].float(), ref[i, :n].float(),
                                   **tol)


def test_paged_attention_int8_refusals(cuda):
    c = _int8_pages(cuda, 3, 4, 8, 2, 64, 4)
    args = (c["q"], c["kq"], c["vq"], c["tables"], c["pos"])
    with pytest.raises(ValueError, match="need k_scales"):
        paged_decode_attention(*args, sm_scale=1.0)
    with pytest.raises(TypeError, match="float16"):
        paged_decode_attention(*args, sm_scale=1.0,
                               k_scales=c["ks"].float(),
                               v_scales=c["vs"].float())
    with pytest.raises(ValueError, match="v_scales must accompany v_pages"):
        paged_decode_attention(c["q"], c["kq"], None, c["tables"], c["pos"],
                               sm_scale=1.0, k_scales=c["ks"],
                               v_scales=c["vs"])


def _mla_case(cuda, b, chunk, h, rank, rope, bs, mb, pages, seed=0):
    """MLA operands (Hkv = 1) on the card: fragmented, permuted and partly
    null tables, mixed lengths, f32 q_eff/q2, and ckv/krope pages in f32,
    bf16 or int8 (codes + fp16 scales)."""
    from repro_torch.models.attention import quantize_kv
    nb = b * mb
    rng = np.random.RandomState(seed)
    perm = rng.permutation(nb)
    owned = [mb] + [int(x) for x in rng.randint(1, mb + 1, size=b - 1)]
    tables = np.full((b, mb), nb, np.int32)
    for i in range(b):
        tables[i, :owned[i]] = perm[i * mb:i * mb + owned[i]]
    lens = np.array([chunk] + [int(x) for x in rng.randint(
        1, chunk + 1, size=b - 1)], np.int32)
    pos = np.array([rng.randint(0, o * bs - n + 1)
                    for o, n in zip(owned, lens)], np.int32)
    t = lambda a: torch.from_numpy(a).to(cuda)     # noqa: E731
    ckv = t(rng.randn(nb + 1, bs, 1, rank).astype(np.float32))
    kr = t(rng.randn(nb + 1, bs, 1, rope).astype(np.float32))
    c = dict(q=t(rng.randn(b, chunk, h, rank).astype(np.float32)),
             q2=t(rng.randn(b, chunk, h, rope).astype(np.float32)),
             tables=t(tables), pos=t(pos), lens=t(lens), np_lens=lens,
             np_pos=pos, np_tables=tables, bs=bs, nb=nb,
             sm=(128 + rope) ** -0.5)
    if pages == "int8":
        kq, ks = quantize_kv(ckv[:, :, 0])
        k2q, k2s = quantize_kv(kr[:, :, 0])
        c.update(k=kq[:, :, None], k2=k2q[:, :, None],
                 scales=dict(k_scales=ks[:, :, None],
                             k2_scales=k2s[:, :, None]))
    else:
        dt = getattr(torch, pages)
        c.update(k=ckv.to(dt), k2=kr.to(dt), scales={})
    return c


def _mla_run(c, k=None, k2=None, scales=None, q=None):
    return paged_decode_attention(
        c["q"] if q is None else q, c["k"] if k is None else k, None,
        c["tables"], c["pos"], sm_scale=c["sm"], lengths=c["lens"],
        q2=c["q2"] if q is None else c["q2"].to(q.dtype),
        k2_pages=c["k2"] if k2 is None else k2,
        **(c["scales"] if scales is None else scales))


# (B, C, H, rank, rope, bs, MB): deepseek-v3's serve shape (8 slots x
# chunk 8, 128 heads, rank 512, rope 64, block 16, 10 blocks = 160
# positions), a ragged one (rows not a multiple of the row tile: 64 rows
# on bf16 and int8 pages, 32 on f32 pages; a chunk of 5, so a 64-row tile
# spans chunk entries; block 64) and a small one at the reduced
# deepseek-v3's widths (rank 32, rope 16: an output-column tile count
# per warp that is odd).
MLA_SHAPES = [(8, 8, 128, 512, 64, 16, 10), (3, 5, 20, 512, 64, 64, 3),
              (3, 4, 8, 32, 16, 4, 6)]


@pytest.mark.parametrize("pages", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("shape", MLA_SHAPES)
def test_paged_attention_mla_matches_plain(cuda, shape, pages):
    """The MLA form against its plain version on the valid rows (f32
    q_eff, f32 output); launches counted in the MLA counters only.
    Tolerance: rtol 2e-5 and atol 1e-5, the f32 reorder of scores over
    576 features and of a weighted average over up to 160 keys of values
    up to ~4 in magnitude, merged across page splits (worst case ~160 x
    2^-24 x 4 = 4e-5; FP32_TOL's atol 2e-6, set at D = 16, was exceeded
    by 3.2e-6 on 5 of 131,072 elements at the serve's widths). Two
    launches on the same inputs give the same bits (the splits merge in a
    fixed order)."""
    c = _mla_case(cuda, *shape, pages=pages, seed=sum(shape))
    counters = ("launches", "int8_launches", "mla_launches",
                "mla_int8_launches")
    before = [getattr(paged_decode_attention, a) for a in counters]
    out = _mla_run(c)
    after = [getattr(paged_decode_attention, a) for a in counters]
    form = 3 if pages == "int8" else 2
    assert [y - x for x, y in zip(before, after)] == \
        [int(i == form) for i in range(4)]
    again = _mla_run(c)
    ref = paged_attention_ref(c["q"], c["k"], None, c["tables"], c["pos"],
                              sm_scale=c["sm"], q2=c["q2"],
                              k2_pages=c["k2"], **c["scales"])
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    for i, n in enumerate(c["np_lens"]):
        torch.testing.assert_close(out[i, :n], ref[i, :n], rtol=2e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("pages", ["bfloat16", "int8"])
def test_paged_attention_mla_dead_pages_and_garbage_rows(cuda, pages):
    """Pages no slot's walk reaches (the null page included) full of NaN
    (int8: codes +-127, NaN scales) change no bit of the output, and the
    rows of chunk entries past a slot's length are written as 0."""
    c = _mla_case(cuda, 8, 8, 128, 512, 64, 16, 10, pages=pages, seed=3)
    out = _mla_run(c)
    live = set()
    for b, (p, n) in enumerate(zip(c["np_pos"], c["np_lens"])):
        live.update(int(x) for x in
                    c["np_tables"][b, :(int(p) + max(int(n), 1) - 1)
                                   // c["bs"] + 1])
    dead = torch.tensor([x for x in range(c["nb"] + 1) if x not in live],
                        dtype=torch.long, device=cuda)
    assert dead.numel() > 0
    k, k2 = c["k"].clone(), c["k2"].clone()
    scales = {n: v.clone() for n, v in c["scales"].items()}
    if pages == "int8":
        k[dead], k2[dead] = 127, -127
        for v in scales.values():
            v[dead] = float("nan")
    else:
        k[dead], k2[dead] = float("nan"), float("nan")
    out2 = _mla_run(c, k=k, k2=k2, scales=scales)
    torch.cuda.synchronize()
    assert torch.equal(out, out2)
    for i, n in enumerate(c["np_lens"]):
        assert not bool(out[i, n:].any())


def test_paged_attention_mla_refuses_bf16_queries(cuda):
    """The MLA kernel takes the f32 q_eff/q_rope that mla_decode passes;
    bf16 queries on the card are refused, and nothing is launched."""
    c = _mla_case(cuda, 3, 4, 8, 32, 16, 4, 6, pages="bfloat16", seed=9)
    before = paged_decode_attention.mla_launches
    with pytest.raises(TypeError, match="float32 q"):
        _mla_run(c, q=c["q"].to(torch.bfloat16))
    assert paged_decode_attention.mla_launches == before


@pytest.mark.parametrize("pages", ["bfloat16", "int8"])
@pytest.mark.parametrize("entries", ["one", "full", "full-deep"])
def test_paged_attention_mla_split_follows_the_step(cuda, entries, pages):
    """At the serve's shape, every slot with one live chunk entry (steady
    decode: the page walk split finely, then merged), with full chunks
    (fewer splits) or with full chunks ending at position 160 in every
    slot (one split, written by the walk without a merge): each against
    the plain version."""
    c = _mla_case(cuda, 8, 8, 128, 512, 64, 16, 10, pages=pages, seed=5)
    n = 1 if entries == "one" else 8
    c["np_lens"] = np.full(8, n, np.int32)
    c["lens"] = torch.from_numpy(c["np_lens"]).to(cuda)
    if entries == "full-deep":      # every slot owns its 10 pages
        c["np_tables"] = np.arange(80, dtype=np.int32).reshape(8, 10)
        c["tables"] = torch.from_numpy(c["np_tables"]).to(cuda)
    owned = (c["np_tables"] != c["nb"]).sum(axis=1)
    c["np_pos"] = (owned * 16 - n if entries == "full-deep" else np.minimum(
        c["np_pos"], owned * 16 - n)).astype(np.int32)
    c["pos"] = torch.from_numpy(c["np_pos"]).to(cuda)
    out = _mla_run(c)
    ref = paged_attention_ref(c["q"], c["k"], None, c["tables"], c["pos"],
                              sm_scale=c["sm"], q2=c["q2"],
                              k2_pages=c["k2"], **c["scales"])
    torch.cuda.synchronize()
    for i in range(8):
        torch.testing.assert_close(out[i, :n], ref[i, :n], rtol=2e-5,
                                   atol=1e-5)
        assert not bool(out[i, n:].any())


def test_paged_attention_mla_steady_decode_splits_the_walk(cuda):
    """Steady decode at the serve's shape (one valid chunk entry a slot,
    every slot 160 positions deep): the tensor-core kernel splits each
    row tile's page walk (more than one split, planned on the card from
    positions and lengths) and merges the splits inside the one launch;
    against the plain version, rows past each length 0, and two launches
    bit-identical, on bf16 and int8 pages. The split is the one the
    kernel wrote back (``mla_last_plan``)."""
    from repro_torch.kernels.paged_attention import mla_last_plan
    for pages in ("bfloat16", "int8"):
        c = _mla_case(cuda, 8, 8, 128, 512, 64, 16, 10, pages=pages, seed=6)
        c["np_tables"] = np.arange(80, dtype=np.int32).reshape(8, 10)
        c["np_lens"] = np.ones(8, np.int32)
        c["np_pos"] = np.full(8, 159, np.int32)
        for key in ("tables", "lens", "pos"):
            c[key] = torch.from_numpy(c["np_" + key]).to(cuda)
        out = _mla_run(c)
        per, items, most = mla_last_plan()
        assert most > 1 and per < 10 and items >= 2 * most
        again = _mla_run(c)
        ref = paged_attention_ref(c["q"], c["k"], None, c["tables"],
                                  c["pos"], sm_scale=c["sm"], q2=c["q2"],
                                  k2_pages=c["k2"], **c["scales"])
        torch.cuda.synchronize()
        assert torch.equal(out, again)
        torch.testing.assert_close(out[:, :1], ref[:, :1], rtol=2e-5,
                                   atol=1e-5)
        assert not bool(out[:, 1:].any())


def _mla_long_table(c, mb=4096, seed=0):
    """Case ``c`` (4 slots at the serve's widths) on a table 4,096 pages
    wide (65,536 keys): slot 0 decodes at the end of a 2,048-page walk
    (32,768 keys) over pages 0..99 of the pool, reused; slots 1..3 own
    short runs of pages 100..139, the rest of each row null; pages
    140..nb - 1 and the null page are dead."""
    rng = np.random.RandomState(seed)
    nb = c["nb"]
    tables = np.full((4, mb), nb, np.int32)
    tables[0, :2048] = rng.randint(0, 100, size=2048)
    owned = [2048, 17, 9, 3]
    for i, o in enumerate(owned[1:], 1):
        tables[i, :o] = 100 + rng.permutation(40)[:o]
    lens = np.array([1, 8, 3, 8], np.int32)
    pos = np.array([o * c["bs"] - n for o, n in zip(owned, lens)], np.int32)
    t = lambda a: torch.from_numpy(a).to(c["q"].device)     # noqa: E731
    c.update(tables=t(tables), pos=t(pos), lens=t(lens), np_tables=tables,
             np_pos=pos, np_lens=lens)
    return c


@pytest.mark.parametrize("pages", ["bfloat16", "int8"])
def test_paged_attention_mla_long_table(cuda, pages):
    """A 4,096-page table (65,536 keys a slot; the kernel's shared memory
    does not grow with the table's width) with one slot decoding 32,768
    keys deep: the walk split across blocks (more than one split of a
    row tile, as the kernel wrote back) and merged in the launch, against
    the plain version; two launches bit-identical; dead pages full of
    garbage change no bit; rows past each length 0."""
    from repro_torch.kernels.paged_attention import mla_last_plan
    c = _mla_long_table(_mla_case(cuda, 4, 8, 128, 512, 64, 16, 40,
                                  pages=pages, seed=21))
    out = _mla_run(c)
    per, items, most = mla_last_plan()
    again = _mla_run(c)
    dead = torch.arange(140, c["nb"] + 1, device=cuda)
    k, k2 = c["k"].clone(), c["k2"].clone()
    scales = {n: v.clone() for n, v in c["scales"].items()}
    if pages == "int8":
        k[dead], k2[dead] = 127, -127
        for v in scales.values():
            v[dead] = float("nan")
    else:
        k[dead], k2[dead] = float("nan"), float("nan")
    out2 = _mla_run(c, k=k, k2=k2, scales=scales)
    ref = paged_attention_ref(c["q"], c["k"], None, c["tables"], c["pos"],
                              sm_scale=c["sm"], q2=c["q2"],
                              k2_pages=c["k2"], **c["scales"])
    torch.cuda.synchronize()
    assert most > 1
    assert torch.equal(out, again) and torch.equal(out, out2)
    for i, n in enumerate(c["np_lens"]):
        torch.testing.assert_close(out[i, :n], ref[i, :n], rtol=2e-5,
                                   atol=1e-5)
        assert not bool(out[i, n:].any())


@pytest.mark.parametrize("pages", ["float32", "bfloat16", "int8"])
def test_paged_attention_mla_kernel_follows_the_pages(cuda, pages,
                                                      monkeypatch):
    """The page dtype alone picks the MLA kernel: f32 pages run the
    CUDA-core kernel, bf16 and int8 pages the tensor-core kernel, never
    the other (no fallback)."""
    from repro_torch.kernels import paged_attention as pa
    calls = {"tc": 0, "cc": 0}

    def counting(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run
    monkeypatch.setattr(pa, "_launch_mla_tc",
                        counting("tc", pa._launch_mla_tc))
    monkeypatch.setattr(pa, "_launch_mla_cc",
                        counting("cc", pa._launch_mla_cc))
    c = _mla_case(cuda, 3, 4, 8, 32, 16, 4, 6, pages=pages, seed=12)
    _mla_run(c)
    torch.cuda.synchronize()
    assert calls == ({"tc": 0, "cc": 1} if pages == "float32"
                     else {"tc": 1, "cc": 0})
    assert pa.mla_row_tile(c["k"].dtype) == (32 if pages == "float32"
                                             else 64)


def test_flash_attention_deepseek_prefill_widths(cuda):
    """deepseek-v3's MLA prefill: D = 192 (nope 128 + rope 64), Dv = 128,
    H = Hkv = 128, bf16, B = 2 x S = 256 (the serve's prefill is 8 x 512
    in chip_smoke.py)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_ref
    gen = torch.Generator(device=cuda).manual_seed(11)
    q, k = (torch.randn((2, 256, 128, 192), generator=gen,
                        device=cuda).to(torch.bfloat16) for _ in range(2))
    v = torch.randn((2, 256, 128, 128), generator=gen,
                    device=cuda).to(torch.bfloat16)
    out = flash_attention(q, k, v, causal=True, sm_scale=192 ** -0.5)
    ref = attention_ref(q.float(), k.float(), v.float(), causal=True,
                        sm_scale=192 ** -0.5)
    torch.cuda.synchronize()
    assert out.shape == (2, 256, 128, 128)
    torch.testing.assert_close(out.float(), ref, rtol=2 ** -7, atol=1e-3)


# --- The bf16 tensor-core kernels (bf16 q on bf16 or int8 pages, bf16
# flash attention) at the widths and edges their designs must cover.

@pytest.mark.parametrize("chunk", [1, 8])
@pytest.mark.parametrize("bs", [4, 16, 64])
def test_paged_attention_tc_granite_widths(cuda, bs, chunk):
    """granite-moe's G = 3, D = 64: C * G = 24 query rows, two 16-row
    tiles at chunk 8; a 16-key tile spans four pages at bs = 4 and a
    quarter page at bs = 64 (the 384-key table of slot 0 walks two
    splits of 256 keys, eight warps of two tiles, merged by the last
    block)."""
    _check_paged(cuda, chunk, "bfloat16", h=24, hkv=8, d=64, bs=bs,
                 launches=2)


def _dead_pages(c_tables, c_pos, c_lens, bs, nb):
    live = set()
    for b in range(len(c_pos)):
        last = (int(c_pos[b]) + max(int(c_lens[b]), 1) - 1) // bs
        live.update(int(p) for p in c_tables[b, :last + 1])
    return [p for p in range(nb + 1) if p not in live]


@pytest.mark.parametrize("pages", ["bfloat16", "int8"])
@pytest.mark.parametrize("case", [(8, 8, 16, 8, 128, 16),
                                  (3, 8, 24, 8, 64, 64)])
def test_paged_attention_tc_repeatable_and_dead_pages(cuda, case, pages):
    """bf16 q: two launches give the same bits, and pages no slot's walk
    reaches (the null page included) full of NaN (int8: codes +-127 and
    NaN scales) change no bit; int8 against the f32 plain version within
    its f32 tolerance plus one bf16 ulp of the output."""
    b, chunk, h, hkv, d, bs = case
    c = _int8_pages(cuda, b, chunk, h, hkv, d, bs)
    q = c["q"].to(torch.bfloat16)
    if pages == "int8":
        kp, vp = c["kq"], c["vq"]
        kw = dict(k_scales=c["ks"], v_scales=c["vs"])
    else:
        from repro_torch.models.attention import dequantize_kv
        kp = dequantize_kv(c["kq"], c["ks"]).to(torch.bfloat16)
        vp = dequantize_kv(c["vq"], c["vs"]).to(torch.bfloat16)
        kw = {}
    args = (q, kp, vp, c["tables"], c["pos"])
    run = lambda *a, **k: paged_decode_attention(  # noqa: E731
        *a, sm_scale=d ** -0.5, lengths=c["lens"], **k)
    out, out2 = run(*args, **kw), run(*args, **kw)
    nb = kp.shape[0] - 1
    dead = torch.tensor(_dead_pages(c["tables"].cpu().numpy(),
                                    c["pos"].cpu().numpy(), c["np_lens"], bs,
                                    nb), dtype=torch.long, device=cuda)
    assert dead.numel() > 0
    kd, vd = kp.clone(), vp.clone()
    kwd = {n: v.clone() for n, v in kw.items()}
    if pages == "int8":
        kd[dead], vd[dead] = 127, -127
        for v in kwd.values():
            v[dead] = float("nan")
    else:
        kd[dead], vd[dead] = float("nan"), float("nan")
    out3 = run(q, kd, vd, c["tables"], c["pos"], **kwd)
    ref = paged_attention_ref(q.float(), *args[1:], sm_scale=d ** -0.5,
                              **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(out, out3)
    for i, n in enumerate(c["np_lens"]):
        o, r = out[i, :n].float(), ref[i, :n]
        ulp = torch.ldexp(torch.ones_like(r), torch.frexp(r).exponent - 8)
        ulp = torch.where(r == 0, torch.zeros_like(r), ulp)
        assert bool(((o - r).abs() <= ulp + 2e-6 + 2e-5 * r.abs()).all())


def test_paged_attention_tc_refuses_head_dim(cuda):
    """bf16 q on bf16 pages needs D % 16 == 0 (the tensor-core kernel);
    nothing is launched otherwise."""
    q = torch.zeros((1, 1, 2, 72), dtype=torch.bfloat16, device=cuda)
    kp = torch.zeros((2, 4, 1, 72), dtype=torch.bfloat16, device=cuda)
    idx = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    pos = torch.zeros((1,), dtype=torch.int32, device=cuda)
    before = paged_decode_attention.launches
    with pytest.raises(ValueError, match="multiple of 16"):
        paged_decode_attention(q, kp, kp, idx, pos, sm_scale=1.0)
    assert paged_decode_attention.launches == before


# (B, Sq, Skv, H, Hkv, D, Dv, causal, q_offset): granite-moe's D = 64, a
# ragged query tile (Sq = 77), Dv != D (deepseek-v3's 192 / 128) with GQA.
FLASH_TC_SHAPES = [(2, 256, 256, 24, 8, 64, 64, True, 0),
                   (3, 77, 77, 16, 8, 128, 128, True, 0),
                   (2, 100, 160, 8, 2, 192, 128, True, 60),
                   (2, 130, 130, 4, 4, 64, 128, False, 0),
                   # D = Dv = 256 (64-key tiles); a ragged last 128-row
                   # item (200 = 3 x 64 positions of 2 folded heads + 8),
                   # and one with G = 16 > 8 heads (no fold, 128
                   # positions an item).
                   (1, 200, 200, 4, 2, 256, 256, True, 0),
                   (2, 200, 200, 16, 8, 128, 128, True, 0),
                   (1, 150, 150, 32, 2, 128, 128, True, 0)]


@pytest.mark.parametrize("shape", FLASH_TC_SHAPES)
def test_flash_attention_tc_matches_plain(cuda, shape):
    """bf16 through the tensor-core kernel: within 1e-4 of the f32 plain
    version plus one bf16 ulp of the output, and two launches give the
    same bits."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_ref
    b, sq, skv, h, hkv, d, dv, causal, off = shape
    gen = torch.Generator(device=cuda).manual_seed(sq + d)
    q, k = (torch.randn((b, s, n, d), generator=gen,
                        device=cuda).to(torch.bfloat16)
            for s, n in ((sq, h), (skv, hkv)))
    v = torch.randn((b, skv, hkv, dv), generator=gen,
                    device=cuda).to(torch.bfloat16)
    out = flash_attention(q, k, v, causal=causal, q_offset=off)
    out2 = flash_attention(q, k, v, causal=causal, q_offset=off)
    ref = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                        q_offset=off)
    torch.cuda.synchronize()
    assert out.shape == (b, sq, h, dv) and torch.equal(out, out2)
    ulp = torch.ldexp(torch.ones_like(ref), torch.frexp(ref).exponent - 8)
    ulp = torch.where(ref == 0, torch.zeros_like(ref), ulp)
    assert bool(((out.float() - ref).abs()
                 <= ulp + 1e-4 + 1e-4 * ref.abs()).all())


def test_flash_attention_tc_unseen_keys(cuda):
    """bf16: keys past the causal horizon (q_offset + Sq - 1) full of NaN
    are never loaded: the output is bit-identical to the one with finite
    values there."""
    from repro_torch.kernels.flash_attention import flash_attention
    gen = torch.Generator(device=cuda).manual_seed(8)
    q = torch.randn((2, 100, 8, 128), generator=gen,
                    device=cuda).to(torch.bfloat16)
    k, v = (torch.randn((2, 200, 2, 128), generator=gen,
                        device=cuda).to(torch.bfloat16) for _ in range(2))
    out = flash_attention(q, k, v, causal=True, q_offset=20)
    k[:, 120:], v[:, 120:] = float("nan"), float("nan")
    out2 = flash_attention(q, k, v, causal=True, q_offset=20)
    torch.cuda.synchronize()
    assert torch.equal(out, out2)


def test_flash_attention_tc_refuses_head_dim(cuda):
    from repro_torch.kernels.flash_attention import flash_attention
    q = torch.zeros((1, 8, 2, 72), dtype=torch.bfloat16, device=cuda)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="multiples of 16"):
        flash_attention(q, q, q)
    assert flash_attention.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mnk", [(1, 64, 256), (64, 1024, 1024),
                                 (70, 300, 3072)])
def test_matmul_q3_k_approx_cvt53_matches_plain(cuda, mnk, dtype):
    """The approx_cvt53 form (scales sc & ~1) against its plain version at
    2e-5 of the output's scale; it counts on matmul_q3_k's launches."""
    from repro_torch.kernels.q3_k_matmul import LAYOUT, matmul_q3_k
    m, n, k = mnk
    gen = torch.Generator(device=cuda).manual_seed(m + n + k)
    x = torch.randn((m, k), generator=gen, device=cuda).to(getattr(torch,
                                                                     dtype))
    planes = pack.quantize(torch.randn((n, k), generator=gen, device=cuda)
                           * 0.05, "q3_k")
    args = [planes[name] for name in LAYOUT]
    before = matmul_q3_k.launches
    y = matmul_q3_k(x, *args, approx_cvt53=True)
    assert matmul_q3_k.launches == before + 1
    ref = matmul_ref(x, planes, "q3_k", approx_cvt53=True)
    exact = matmul_ref(x, planes, "q3_k")
    torch.cuda.synchronize()
    tol = 2e-5 * max(1.0, float(ref.abs().max()))
    assert float((y - ref).abs().max()) <= tol
    assert not torch.equal(ref, exact)


# (M, N, K) of qwen3-0.6b's up/gate and down projections in an 8 x 512
# prefill: the tensor-core kernel's 128 x 128 tiles, K not split.
PREFILL_MNK = [(4096, 3072, 1024), (4096, 1024, 3072)]


@pytest.mark.parametrize("mnk", PREFILL_MNK)
@pytest.mark.parametrize("fmt", ["q8_0", "fp16", "q6_k", "q3_k"])
def test_matmul_prefill_shapes_repeatable(cuda, fmt, mnk):
    """bf16 x at the prefill's M = 4,096: within 2e-5 of the output's
    scale, the bf16 output the f32 one rounded once, one launch counted
    per call, and two launches give the same bits in both dtypes."""
    _check_matmul(cuda, fmt, *mnk, "bfloat16")
    wrapper, layout = MATMUL_KERNELS[fmt]
    m, n, k = mnk
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
    planes = pack.quantize(torch.randn((n, k), generator=gen, device=cuda)
                           * 0.05, fmt)
    args = [planes[name] for name in layout]
    for dt in (torch.float32, torch.bfloat16):
        a = wrapper(x, *args, out_dtype=dt)
        b = wrapper(x, *args, out_dtype=dt)
        torch.cuda.synchronize()
        assert torch.equal(a, b)


def test_paged_attention_bf16_q_refuses_f32_pages(cuda):
    """bf16 q runs the tensor-core kernel only, which takes bf16 or int8
    pages; nothing is launched for f32 pages."""
    q = torch.zeros((1, 1, 2, 64), dtype=torch.bfloat16, device=cuda)
    kp = torch.zeros((2, 4, 1, 64), dtype=torch.float32, device=cuda)
    idx = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    pos = torch.zeros((1,), dtype=torch.int32, device=cuda)
    before = paged_decode_attention.launches
    with pytest.raises(TypeError, match="bf16 or int8 pages"):
        paged_decode_attention(q, kp, kp, idx, pos, sm_scale=1.0)
    assert paged_decode_attention.launches == before
