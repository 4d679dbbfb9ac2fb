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
    """The raw launch refuses an input that requires grad while grad mode
    is on (no gradient may vanish at the ctypes call); the wrapper takes
    such inputs through FlashAttention, whose launch is counted."""
    from repro_torch.kernels import flash_attention as fa
    q = torch.randn((1, 8, 2, 16), device=cuda, requires_grad=True)
    k = torch.randn((1, 8, 2, 16), device=cuda)
    with pytest.raises(RuntimeError, match="FlashAttention"):
        fa._launch(q, k, k, causal=True, sm_scale=0.25, q_offset=0)
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, k)
    assert out.requires_grad and out.grad_fn is not None
    assert fa.flash_attention.launches == before + 1


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


# --- The recurrent families at full width: the card's path (matmul
# kernels, and B1 at jamba's G = 4) against the plain path on the CPU.

def _to(tree, d):
    if isinstance(tree, dict):
        return {k: _to(v, d) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, d) for v in tree]
    return tree.to(d)


def test_mamba2_full_width_steps_match_cpu(cuda):
    """mamba2-1.3b at full width cut to 2 layers (q8_0): two chunked
    steps on a paged arena (the state per slot, SSM state f32; the second
    step reads the state the first left), valid rows' logits within 1e-2
    of max|logit| of the CPU path's (bf16 activations in another
    summation order, as chip_smoke.py's step checks), and the first
    layer's state within 1e-2 of its scale (the second layer's is held
    through the second step's logits: see chip_smoke.py's
    ``check_mamba_steps_vs_cpu``)."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.core.convert import quantize_params
    from repro_torch.models.api import build_model
    from repro_torch.runtime.kvcache import PagedKVArena
    model = build_model(dataclasses.replace(get_config("mamba2-1.3b"),
                                            num_layers=2))
    params = quantize_params(model.init(
        torch.Generator(device=cuda).manual_seed(0)), "q8_0")
    gen = torch.Generator().manual_seed(1)
    i32 = torch.int32
    steps = [(torch.randint(0, model.cfg.vocab_size, (2, 8), generator=gen,
                            dtype=i32), torch.tensor([0, 0], dtype=i32),
              torch.tensor([8, 3], dtype=i32)),
             (torch.randint(0, model.cfg.vocab_size, (2, 8), generator=gen,
                            dtype=i32), torch.tensor([8, 3], dtype=i32),
              torch.tensor([8, 1], dtype=i32))]
    got = {}
    for d in ("cpu", cuda):
        arena = PagedKVArena(model, 2, 32, block_size=16, device=d)
        for _ in range(2):
            arena.alloc_slot(1)
        tables, _ = arena.device_tables()
        logits = [model.decode_step(
            _to(params, d), tok.to(d), pos.to(d), arena.buffers,
            quant="q8_0", block_tables=tables, lengths=lens.to(d))[0]
            .float().cpu() for tok, pos, lens in steps]
        got[str(d)] = (logits, {k: v.float().cpu() for k, v in
                                arena.buffers["layers0"].items()})
        assert arena.buffers["layers0"]["ssm"].dtype == torch.float32
    (la, sa), (lr, sr) = got[str(cuda)], got["cpu"]
    for a, r, (_, _, lens) in zip(la, lr, steps):
        for b, n in enumerate(lens):
            err = float((a[b, :n] - r[b, :n]).abs().max())
            assert err <= 1e-2 * float(r.abs().max())
    for k in sa:
        assert float((sa[k][0] - sr[k][0]).abs().max()) <= \
            1e-2 * float(sr[k][0].abs().max())


def test_jamba_attention_layer_g4_matches_cpu(cuda):
    """jamba's attention layer at full width (H 32, Hkv 8, D 128: B1's
    tensor-core kernel at G = 4, one launch) with its dense FFN (q8_0),
    one chunked step over bf16 pages: valid rows within 1e-2 of max|out|
    of the CPU path's."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"), num_layers=8)
    lp = lm.layer_init(torch.Generator(device=cuda).manual_seed(0), cfg,
                       "gqa", "dense", "q8_0")
    gen = torch.Generator().manual_seed(2)
    h = torch.randn((2, 8, cfg.d_model), generator=gen).to(torch.bfloat16)
    pages = {k: torch.randn((9, 16, 8, 128), generator=gen).to(
        torch.bfloat16) for k in "kv"}
    pos = torch.tensor([0, 5], dtype=torch.int32)
    lens = torch.tensor([8, 3], dtype=torch.int32)
    tables = torch.tensor([[3, 1, 8, 8], [0, 2, 8, 8]], dtype=torch.int32)
    got = {}
    for d in ("cpu", cuda):
        before = paged_decode_attention.launches
        out = lm.layer_decode(_to(lp, d), cfg, h.to(d), pos.to(d),
                              _to(pages, d), mixer="gqa", ffn="dense",
                              fmt="q8_0", block_tables=tables.to(d),
                              lengths=lens.to(d))
        got[str(d)] = out.float().cpu()
    assert paged_decode_attention.launches == before + 1
    a, r = got[str(cuda)], got["cpu"]
    for b, n in enumerate(lens):
        assert float((a[b, :n] - r[b, :n]).abs().max()) <= \
            1e-2 * float(r.abs().max())


# --- The conditioned families at full width: B7 non-causal at whisper's
# encoder and cross shapes, B1 at whisper's G = 1 / D = 64 and qwen2-vl's
# G = 6 / D = 128, and a 2-layer step of each model against the CPU path.

# (B, Sq, Skv, H, Hkv, D, causal): whisper's encoder over 1,500 frames,
# its prefill's cross attention (128 decoder tokens over 1,500 frames),
# and qwen2-vl's causal prefill (12 heads over 2 KV heads).
FLASH_CONDITIONED = [(8, 1500, 1500, 12, 12, 64, False),
                     (8, 128, 1500, 12, 12, 64, False),
                     (8, 512, 512, 12, 2, 128, True)]


@pytest.mark.parametrize("shape", FLASH_CONDITIONED,
                         ids=["whisper-encoder", "whisper-cross",
                              "qwen2-vl-prefill"])
def test_flash_attention_conditioned_shapes(cuda, shape):
    """bf16 through the tensor-core kernel at B7's 1e-4 of the f32 plain
    version plus one bf16 ulp of the output, one launch a call."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_ref
    b, sq, skv, h, hkv, d, causal = shape
    gen = torch.Generator(device=cuda).manual_seed(sq + skv)
    q, k, v = (torch.randn((b, s, n, d), generator=gen,
                           device=cuda).to(torch.bfloat16)
               for s, n in ((sq, h), (skv, hkv), (skv, hkv)))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1
    ref = attention_ref(q.float(), k.float(), v.float(), causal=causal)
    torch.cuda.synchronize()
    ulp = torch.ldexp(torch.ones_like(ref), torch.frexp(ref).exponent - 8)
    ulp = torch.where(ref == 0, torch.zeros_like(ref), ulp)
    assert out.shape == (b, sq, h, d)
    assert bool(((out.float() - ref).abs()
                 <= ulp + 1e-4 + 1e-4 * ref.abs()).all())


@pytest.mark.parametrize("chunk", [1, 8])
@pytest.mark.parametrize("heads", [(12, 12, 64), (12, 2, 128)],
                         ids=["whisper-g1", "qwen2-vl-g6"])
def test_paged_attention_conditioned_widths(cuda, heads, chunk):
    """whisper's MHA decoder (G = 1, D = 64: C rows a kv-head) and
    qwen2-vl's G = 6, D = 128 (48 rows at chunk 8, three 16-row tiles),
    bf16 at block 16, twice."""
    h, hkv, d = heads
    _check_paged(cuda, chunk, "bfloat16", h=h, hkv=hkv, d=d, bs=16,
                 launches=2)


def _conditioned_step(cuda, arch):
    """``arch`` at full width cut to 2 layers (whisper: 2 encoder and 2
    decoder layers), q8_0: the admission pass (whisper: cross K/V of
    random frames written into both slots) and one chunked step on bf16
    pages (lengths 8 / 3 at bases 0 / 5; qwen2-vl: vision rows at
    positions below 256, the second slot's chunk straddling the vision /
    text boundary at base 250), on the CPU and on the card. Returns
    {device: (logits, launches)}."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.core.convert import quantize_params
    from repro_torch.launch import serve
    from repro_torch.models.api import build_model
    from repro_torch.runtime.kvcache import PagedKVArena
    cfg = get_config(arch)
    cut = dict(num_layers=2)
    if cfg.family == "encdec":
        cut["encoder_layers"] = 2
    model = build_model(dataclasses.replace(cfg, **cut))
    params = quantize_params(model.init(
        torch.Generator(device=cuda).manual_seed(0)), "q8_0")
    gen = torch.Generator().manual_seed(3)
    tok = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen,
                        dtype=torch.int32)
    vlm = cfg.family == "vlm"
    pos = torch.tensor([0, 250 if vlm else 5], dtype=torch.int32)
    lens = torch.tensor([8, 3], dtype=torch.int32)
    frames = torch.randn((1, cfg.encoder_seq_len, cfg.d_model),
                         generator=gen).to(torch.bfloat16)
    vis = torch.randn((2, 8, cfg.d_model), generator=gen).to(torch.bfloat16)
    mask = (pos[:, None] + torch.arange(8)) < cfg.vision_tokens
    got = {}
    for d in ("cpu", cuda):
        arena = PagedKVArena(model, 2, 272, block_size=16, device=d)
        for _ in range(2):
            arena.alloc_slot(arena.blocks_needed(272))
        serve.reset_launches()
        w = _to(params, d)
        if not vlm:
            for s in range(2):
                arena.write_prefill(model.encode_cross(
                    w, frames.to(d), quant="q8_0"), s)
        extra = dict(embeds=vis.to(d), embeds_mask=mask.to(d)) if vlm \
            else {}
        tables, _ = arena.device_tables()
        logits, _ = model.decode_step(w, tok.to(d), pos.to(d), arena.buffers,
                                      quant="q8_0", block_tables=tables,
                                      lengths=lens.to(d), **extra)
        got[str(d)] = (logits.float().cpu(), serve.launch_counts())
    return cfg, lens, got


@pytest.mark.parametrize("arch", ["whisper-small", "qwen2-vl-2b"])
def test_conditioned_full_width_step_matches_cpu(cuda, arch):
    """Valid rows' logits within 1e-2 of max|logit| of the CPU path's
    (chip_smoke.py's step-check bound: bf16 activations in another
    summation order), every linear through matmul_q8_0 and every self
    attention through paged_decode_attention on the card (whisper's
    admission: 2 x (12 encoder + 4 cross K/V) linears and 2 x 2 flash
    launches; the step: 2 x 8 linears, 2 paged launches and the
    lm_head; qwen2-vl: 2 x 7 + 1 linears, 2 paged launches)."""
    cfg, lens, got = _conditioned_step(cuda, arch)
    (a, launches), (r, cpu_launches) = got[str(cuda)], got["cpu"]
    assert not any(cpu_launches.values())
    want = {"matmul_q8_0": 15, "paged_decode_attention": 2} \
        if cfg.family == "vlm" else \
        {"matmul_q8_0": 2 * 16 + 17, "paged_decode_attention": 2,
         "flash_attention": 4}
    assert {k: v for k, v in launches.items() if v} == want
    assert a.shape == (2, 8, cfg.vocab_size) and bool(torch.isfinite(a).all())
    for b, n in enumerate(lens):
        assert float((a[b, :n] - r[b, :n]).abs().max()) <= \
            1e-2 * float(r.abs().max())


# ----------------------------------------------------------------------
# llama3-405b's G = 16 (and the other dense configs' G = 3, 8), B7's
# backward, and the matmul and paged wrappers' grad refusal
# ----------------------------------------------------------------------
@pytest.mark.parametrize("chunk", [1, 8])
@pytest.mark.parametrize("heads", [(128, 8), (24, 8), (64, 8)],
                         ids=["llama3-405b-g16", "llama3.2-3b-g3",
                              "qwen2-72b-g8"])
def test_paged_attention_dense_config_groups(cuda, heads, chunk):
    """bf16 q and pages at D = 128, block 16: G = 16 (C x 16 = 128 query
    rows a (slot, kv-head) at chunk 8), G = 3 and G = 8, twice."""
    h, hkv = heads
    _check_paged(cuda, chunk, "bfloat16", h=h, hkv=hkv, d=128, bs=16,
                 launches=2)


@pytest.mark.parametrize("chunk", [1, 8])
def test_paged_attention_int8_group_16(cuda, chunk):
    """B8 at llama3-405b's G = 16, D = 128, bs = 16, bf16 q: within the f32
    tolerance of the plain version plus one bf16 ulp of the output."""
    c = _int8_pages(cuda, 3, chunk, 128, 8, 128, 16)
    q = c["q"].to(torch.bfloat16)
    args = (q, c["kq"], c["vq"], c["tables"], c["pos"])
    kw = dict(sm_scale=128 ** -0.5, k_scales=c["ks"], v_scales=c["vs"])
    before = paged_decode_attention.int8_launches
    out = paged_decode_attention(*args, lengths=c["lens"], **kw)
    ref = paged_attention_ref(q.float(), *args[1:], **kw)
    torch.cuda.synchronize()
    assert paged_decode_attention.int8_launches == before + 1
    for i, n in enumerate(c["np_lens"]):
        o, r = out[i, :n].float(), ref[i, :n]
        ulp = torch.ldexp(torch.ones_like(r), torch.frexp(r).exponent - 8)
        ulp = torch.where(r == 0, torch.zeros_like(r), ulp)
        assert bool(((o - r).abs() <= ulp + 2e-6 + 2e-5 * r.abs()).all())


@pytest.mark.parametrize("heads", [(128, 8), (24, 8), (64, 8)],
                         ids=["g16", "g3", "g8"])
def test_flash_attention_dense_config_groups(cuda, heads):
    """bf16 causal prefill shapes at G = 16 (one head an item), 3 and 8:
    1e-4 of the f32 plain version plus one bf16 ulp."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_ref
    h, hkv = heads
    gen = torch.Generator(device=cuda).manual_seed(h)
    q = torch.randn((2, 300, h, 128), generator=gen,
                    device=cuda).to(torch.bfloat16)
    k, v = (torch.randn((2, 300, hkv, 128), generator=gen,
                        device=cuda).to(torch.bfloat16) for _ in range(2))
    out = flash_attention(q, k, v, causal=True)
    ref = attention_ref(q.float(), k.float(), v.float(), causal=True)
    torch.cuda.synchronize()
    ulp = torch.ldexp(torch.ones_like(ref), torch.frexp(ref).exponent - 8)
    ulp = torch.where(ref == 0, torch.zeros_like(ref), ulp)
    assert bool(((out.float() - ref).abs()
                 <= ulp + 1e-4 + 1e-4 * ref.abs()).all())


@pytest.mark.parametrize("shape", [(2, 64, 64, 16, 8, 128, 128, True, 0),
                                   (2, 40, 72, 128, 8, 128, 128, True, 32),
                                   (1, 50, 50, 8, 2, 192, 128, True, 0),
                                   (2, 33, 47, 4, 4, 64, 64, False, 0)])
def test_flash_attention_backward_matches_autograd(cuda, shape):
    """B7 under autograd: the forward is the kernel (one counted launch),
    dq, dk and dv are autograd of the plain version on the same bf16
    inputs: equal within 1e-4 + 1e-2 of each gradient's max (both sum
    f32 products, in other orders, over up to Skv keys; rounded once to
    bf16), at qwen3's G = 2, llama3-405b's G = 16 with a query offset,
    Dv != D, and non-causal."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_ref
    b, sq, skv, h, hkv, d, dv, causal, off = shape
    gen = torch.Generator(device=cuda).manual_seed(sq + h)
    mk = lambda *s: torch.randn(s, generator=gen, device=cuda).to(  # noqa
        torch.bfloat16).requires_grad_(True)
    q, k, v = mk(b, sq, h, d), mk(b, skv, hkv, d), mk(b, skv, hkv, dv)
    do = torch.randn((b, sq, h, dv), generator=gen, device=cuda).to(
        torch.bfloat16)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, q_offset=off)
    got = torch.autograd.grad(out, (q, k, v), do)
    assert flash_attention.launches == before + 1
    ref = attention_ref(q, k, v, causal=causal, q_offset=off)
    want = torch.autograd.grad(ref, (q, k, v), do)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        err = float((g.float() - w.float()).abs().max())
        assert err <= 1e-4 + 1e-2 * float(w.float().abs().max()), err


def test_matmul_refuses_grad(cuda):
    """A matmul wrapper refuses an input that requires grad while grad
    mode is on (the kernels have no backward); under no_grad it
    launches."""
    wrapper, layout = MATMUL_KERNELS["q8_0"]
    x = torch.randn((4, 64), device=cuda, requires_grad=True)
    planes = pack.quantize(torch.randn((32, 64), device=cuda), "q8_0")
    args = [planes[name] for name in layout]
    before = wrapper.launches
    with pytest.raises(RuntimeError, match="no backward"):
        wrapper(x, *args)
    assert wrapper.launches == before
    with torch.no_grad():
        wrapper(x, *args)
    assert wrapper.launches == before + 1


def test_paged_attention_refuses_grad(cuda):
    """The paged wrapper refuses a query that requires grad while grad
    mode is on; under no_grad it launches."""
    c = _int8_pages(cuda, 3, 4, 8, 2, 64, 4)
    q = c["q"].clone().requires_grad_(True)
    args = (q, c["kq"], c["vq"], c["tables"], c["pos"])
    kw = dict(sm_scale=0.125, k_scales=c["ks"], v_scales=c["vs"],
              lengths=c["lens"])
    before = paged_decode_attention.int8_launches
    with pytest.raises(RuntimeError, match="no backward"):
        paged_decode_attention(*args, **kw)
    with torch.no_grad():
        paged_decode_attention(*args, **kw)
    assert paged_decode_attention.int8_launches == before + 1


# ----------------------------------------------------------------------
# Shard-invariant launch plans (serving meshes)
# ----------------------------------------------------------------------
# (M, N, K): decode rows of qwen3-0.6b's q projection, and shapes at
# which a half shard would plan another tile (M = 128 cut to 64) or
# another split of K (N = 3072 at M = 512, 96 tiles of 132 SMs) than
# the whole call if it planned from its own shape.
SHARD_MNK = [(64, 2048, 1024), (128, 3072, 1024), (512, 3072, 1024)]


def _matmul_shards(dev, fmt, m, n, k):
    """(whole (M, N) bf16, [(rows, cols, shard output)]): one call and
    its column blocks of 2 and 4 and row blocks of 2, each planned from
    the whole call's shape (``plan_parts``)."""
    wrapper, layout = MATMUL_KERNELS[fmt]
    gen = torch.Generator(device=dev).manual_seed(m + n + k)
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    planes = pack.quantize(torch.randn((n, k), generator=gen, device=dev)
                           * 0.05, fmt)
    full = [planes[p] for p in layout]
    whole = wrapper(x, *full, out_dtype=torch.bfloat16)
    out = []
    for parts in (2, 4):
        w = n // parts
        for i in range(parts):
            cut = [p[i * w:(i + 1) * w].contiguous() for p in full]
            out.append((slice(None), slice(i * w, (i + 1) * w), wrapper(
                x, *cut, out_dtype=torch.bfloat16, plan_parts=(1, parts))))
    h = m // 2
    for i in range(2):
        out.append((slice(i * h, (i + 1) * h), slice(None), wrapper(
            x[i * h:(i + 1) * h].contiguous(), *full,
            out_dtype=torch.bfloat16, plan_parts=(2, 1))))
    return whole, out


@pytest.mark.parametrize("mnk", SHARD_MNK)
@pytest.mark.parametrize("fmt", ["q8_0", "fp16", "q6_k", "q3_k"])
def test_matmul_shards_match_whole_call(cuda, fmt, mnk):
    """B2 (and B4/B5/B6, which share ``plan``) on a column block of 2 or
    4 and a row block of 2, planned from the unsharded shape: bit for bit
    the whole call's rows and columns."""
    whole, shards = _matmul_shards(cuda, fmt, *mnk)
    torch.cuda.synchronize()
    for rows, cols, y in shards:
        assert torch.equal(y, whole[rows, cols])


def test_matmul_shard_plan_differs_without_parts():
    """The shapes above are ones where a shard planned from its own shape
    would tile or split K differently: what ``plan_parts`` prevents."""
    from repro_torch.kernels import _dequant_matmul as dm
    bf = torch.bfloat16
    assert dm.plan(64, 3072, 1024, 132, bf) != dm.plan(128, 3072, 1024, 132,
                                                       bf)
    assert dm.plan(512, 1536, 1024, 132, bf) != dm.plan(512, 3072, 1024,
                                                        132, bf)


def _paged_shards(dev, dtype, kv, parts=2):
    """(whole, [(slot rows, heads, shard output)]) of the GQA form at the
    serving shape (B 8, C 8, H 16, Hkv 8, D 128, bs 16): kv-head blocks
    of ``parts`` (their query heads, pages and scales) and slot blocks
    of 2, each launched with ``plan_parts``."""
    c = _int8_pages(dev, 8, 8, 16, 8, 128, 16)
    q = c["q"].to(dtype)
    if kv == "int8":
        k, v, ks, vs = c["kq"], c["vq"], c["ks"], c["vs"]
    else:
        from repro_torch.models.attention import dequantize_kv
        k = dequantize_kv(c["kq"], c["ks"]).to(torch.bfloat16)
        v = dequantize_kv(c["vq"], c["vs"]).to(torch.bfloat16)
        ks = vs = None

    def run(qq, kk, vv, kss, vss, tb, pos, ln, plan_parts=(1, 1)):
        return paged_decode_attention(qq, kk, vv, tb, pos, sm_scale=0.0884,
                                      lengths=ln, k_scales=kss,
                                      v_scales=vss, plan_parts=plan_parts)
    tb, pos, ln = c["tables"], c["pos"], c["lens"]
    whole = run(q, k, v, ks, vs, tb, pos, ln)
    out = []
    g, hk = 16 // parts, 8 // parts
    cut = lambda t, i, ax: None if t is None else t.narrow(  # noqa: E731
        ax, i * (t.shape[ax] // parts), t.shape[ax] // parts).contiguous()
    for i in range(parts):
        out.append((slice(None), slice(i * g, (i + 1) * g), run(
            cut(q, i, 2), cut(k, i, 2), cut(v, i, 2), cut(ks, i, 2),
            cut(vs, i, 2), tb, pos, ln, (1, parts))))
    for i in range(2):
        s = slice(i * 4, (i + 1) * 4)
        out.append((s, slice(None), run(
            q[s].contiguous(), k, v, ks, vs, tb[s].contiguous(),
            pos[s].contiguous(), ln[s].contiguous(), (2, 1))))
    return whole, out


@pytest.mark.parametrize("dtype,kv", [("bfloat16", "bfloat16"),
                                      ("bfloat16", "int8"),
                                      ("float32", "bfloat16")])
def test_paged_attention_shards_match_whole_call(cuda, dtype, kv):
    """B1/B8 on a kv-head shard (its query heads) and on a slot shard:
    bit for bit the whole call's heads and slots (bf16 q: the
    tensor-core plan depends on G, not on H; f32 q: the CUDA-core split
    is planned for the whole B * Hkv)."""
    whole, shards = _paged_shards(cuda, getattr(torch, dtype), kv)
    torch.cuda.synchronize()
    for rows, heads, y in shards:
        assert torch.equal(y, whole[rows][:, :, heads])


# (slots, chunk entries, head blocks, 'data' blocks) of deepseek-v3's 128
# heads, each shard launched with the whole call's plan inputs
# (``MlaPlan``): decode cut in 8 head blocks, every slot walking 2,048
# keys (the SM count sets the split); 2 slots of chunks of 8 cut in 2, 4
# and of chunks of 4 in 8 (a shard's rows then share a 64-row tile of the
# whole call with other shards' rows, or fill half or a quarter of one);
# and two 'data' halves of 8 slots of chunks of 8 at unequal depths (the
# split follows every slot's depth).
MLA_SHARD_CASES = [(8, 1, 8, 1), (2, 8, 2, 1), (2, 8, 4, 1), (2, 4, 8, 1),
                   (8, 8, 1, 2)]


def _mla_shards(dev, pages, slots, chunk, parts, data):
    """(whole, [(slots, heads, shard output)]) of the MLA form at
    deepseek-v3's widths, every slot owning 128 pages of 16 and its
    chunk ending at its depth (2,048 keys on one 'data' block, unequal
    depths on more), cut into ``data`` slot blocks x ``parts`` head
    blocks over the same latent pages, each launched with the whole
    call's ``MlaPlan``."""
    from repro_torch.kernels.paged_attention import MlaPlan
    c = _mla_case(dev, slots, chunk, 128, 512, 64, 16, 128, pages=pages,
                  seed=7)
    c["tables"] = torch.arange(slots * 128, dtype=torch.int32,
                               device=dev).reshape(slots, 128)
    depth = np.full(slots, 2048) if data == 1 else \
        np.random.RandomState(slots + chunk).randint(chunk, 2049, slots)
    c["pos"] = torch.from_numpy((depth - c["np_lens"]).astype(
        np.int32)).to(dev)
    whole = _mla_run(c)
    g, nb = 128 // parts, slots // data
    out = []
    for d in range(data):
        rows = slice(d * nb, (d + 1) * nb)
        part = lambda t: t[rows].contiguous()      # noqa: E731
        for i in range(parts):
            heads = slice(i * g, (i + 1) * g)
            y = paged_decode_attention(
                part(c["q"])[:, :, heads].contiguous(), c["k"], None,
                part(c["tables"]), part(c["pos"]), sm_scale=c["sm"],
                lengths=part(c["lens"]),
                q2=part(c["q2"])[:, :, heads].contiguous(),
                k2_pages=c["k2"],
                mla_plan=MlaPlan(c["pos"], c["lens"], d * nb, 128, i * g),
                **c["scales"])
            out.append((rows, heads, y))
    return whole, c["np_lens"], out


@pytest.mark.parametrize("pages", ["bfloat16", "int8"])
@pytest.mark.parametrize("slots,chunk,parts,data", MLA_SHARD_CASES)
def test_paged_attention_mla_shards_match_whole_call(cuda, pages, slots,
                                                     chunk, parts, data):
    """B9 on a head shard (its query heads over the replicated latent
    pages) or a 'data' block of slots, launched with the whole call's
    ``MlaPlan``: its valid rows bit for bit the whole call's."""
    whole, lens, shards = _mla_shards(cuda, pages, slots, chunk, parts,
                                      data)
    torch.cuda.synchronize()
    for rows, heads, y in shards:
        for b, n in enumerate(lens[rows]):
            assert torch.equal(y[b, :n], whole[rows][b, :n, heads])


# qwen2-72b's B2 shapes (N, K): k/v, q/o, gate/up, lm_head, down.
QWEN2_72B_NK = [(1024, 8192), (8192, 8192), (29568, 8192), (152064, 8192),
                (8192, 29568)]


@pytest.mark.parametrize("nk", QWEN2_72B_NK,
                         ids=[f"{n}x{k}" for n, k in QWEN2_72B_NK])
def test_matmul_q8_0_rows_do_not_follow_the_row_count(cuda, nk):
    """B2 inside ``plan_rows(256)`` (a packed serving step of 32 slots x
    chunk 8): each row's output bit for bit the 256-row call's, whether
    the call carries 1, 45, 64, 100 or 256 of the rows, in any order."""
    from repro_torch.kernels import ops as kops
    n, k = nk
    gen = torch.Generator(device=cuda).manual_seed(n + k)
    x = torch.randn((256, k), generator=gen, device=cuda).to(torch.bfloat16)
    planes = pack.quantize(torch.randn((n, k), generator=gen, device=cuda)
                           * 0.05, "q8_0")
    with kops.plan_rows(256):
        full = kops.quantized_matmul(x, planes, "q8_0")
        for m in (1, 45, 64, 100, 256):
            idx = torch.randperm(256, generator=gen, device=cuda)[:m]
            y = kops.quantized_matmul(x[idx], planes, "q8_0")
            assert torch.equal(y, full[idx]), m


def test_packed_qwen2_step_gives_the_padded_tokens(cuda):
    """qwen2-72b at full width cut to 2 layers (q8_0, bf16 pages of 16):
    a mixed step of 32 slots x chunk 8 (prompt chunks of 8, decodes of 1,
    idle slots) run on its fed rows (``rows``) against the same step
    padded: each active slot's greedy token and logits, and every page,
    bit for bit."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.core.convert import quantize_params
    from repro_torch.models.api import build_model
    model = build_model(dataclasses.replace(get_config("qwen2-72b"),
                                            num_layers=2))
    assert model.packs_layers
    params = quantize_params(model.init(
        torch.Generator(device=cuda).manual_seed(0)), "q8_0")
    slots, chunk, bs, mb = 32, 8, 16, 16
    gen = torch.Generator(device=cuda).manual_seed(1)
    i32 = torch.int32
    lens = torch.tensor([8] * 4 + [1] * 24 + [0] * 4, dtype=i32, device=cuda)
    pos0 = torch.randint(0, 120, (slots,), generator=gen, device=cuda,
                         dtype=i32)
    token = torch.randint(0, model.cfg.vocab_size, (slots, chunk),
                          generator=gen, device=cuda, dtype=i32)
    tables = torch.arange(slots * mb, dtype=i32, device=cuda).reshape(
        slots, mb)
    tables[lens == 0] = slots * mb                        # the null page
    shapes = model.paged_cache_shapes(slots, slots * mb + 1, bs)

    def leaf(sh):
        if isinstance(sh, dict):
            return {k: leaf(v) for k, v in sh.items()}
        return torch.randn(sh, generator=gen, device=cuda).to(torch.bfloat16)
    cache = leaf(shapes)
    copy = lambda t: {k: copy(v) for k, v in t.items()} \
        if isinstance(t, dict) else t.clone()              # noqa: E731
    c_pad, c_pack = copy(cache), copy(cache)
    kw = dict(quant="q8_0", block_tables=tables, lengths=lens)
    want, _ = model.decode_step(params, token, pos0, c_pad, **kw)
    fed = torch.nonzero((torch.arange(chunk, device=cuda)[None, :]
                         < lens[:, None]).reshape(-1)).flatten()
    heads = torch.clamp(torch.cumsum(lens.long(), 0) - 1, min=0)
    got, _ = model.decode_step(params, token, pos0, c_pack,
                               rows=(fed, heads), **kw)
    torch.cuda.synchronize()
    active = lens > 0
    last = want[torch.arange(slots, device=cuda),
                torch.clamp(lens.long() - 1, min=0)]
    assert torch.equal(got[active].argmax(-1), last[active].argmax(-1))
    assert torch.equal(got[active], last[active]), \
        float((got[active].float() - last[active].float()).abs().max())

    def leaves(t):
        return [x for k in sorted(t) for x in leaves(t[k])] \
            if isinstance(t, dict) else [t]
    for a, b in zip(leaves(c_pad), leaves(c_pack)):
        assert torch.equal(a, b)
