"""Fused paged decode attention: wrapper of ``csrc/paged_attention.cu``.

The port of ``repro.kernels.paged_attention.paged_decode_attention`` in
all its forms: GQA over bf16/f32 pages, or int8 code pages with fp16
scale pages (the ``k_scales``/``v_scales`` form); and the MLA form
(``v_pages=None``: the K pages double as V; optional RoPE side
``q2``/``k2_pages``, whose score joins the first before ``sm_scale``;
int8 with ``k_scales``/``k2_scales``), which has its own entry point in
the CUDA source because its C * 128 query rows per slot are tiled across
blocks. Layout contract (``PagedKVArena.page_layout``,
docs/kernel-contracts.md):

  q         (B, C, H, D)      C >= 1 chunk queries per slot
  k_pages   (NP, bs, Hkv, D)  physical pages incl. the trailing null page
  v_pages   (NP, bs, Hkv, D)
  tables    (B, MB) int32     logical block -> physical page
  positions (B,) int32        chunk base: query i sits at base + i and
                              attends kv positions <= base + i
  lengths   (B,) int32        valid queries per row (default C)
  k_scales  (NP, bs, Hkv) f16 with int8 pages: one scale per (in-page
  v_scales  (NP, bs, Hkv) f16 position, kv-head); element = code * scale
  q2        (B, C, H, D2)     MLA only: the RoPE-side queries, with
  k2_pages  (NP, bs, Hkv, D2) its pages (and ``k2_scales`` when int8)

On a CPU tensor the wrapper computes the plain version
(``ref.paged_attention_ref``); on a CUDA tensor it launches a
hand-written kernel or raises. In the GQA form q's dtype alone picks
the kernel: bf16 q (every serving path: the models' activations are
bf16), on bf16 or int8 pages, runs the tensor-core kernel (``mma.sync``
products, a ``cp.async`` ring per warp; D a multiple of 16; f32 pages
are refused); f32 q runs the CUDA-core kernel, whose f32 products meet
the f32 tolerance that tensor cores cannot. The MLA form takes f32
q_eff/q_rope (what ``mla_decode`` passes) and the page dtype alone picks
its kernel: bf16 or int8 pages (every serving path) run the tensor-core
kernel (``mma.sync`` on the queries split into three bf16 parts, one
cooperative launch of one block per SM that plans the step's page-walk
split and merges it; ``rank`` 32 or 512, the ported configurations'
(deepseek-v3 reduced and at full width), ``rope`` a multiple of 16 up
to 256; its shared memory does not grow with the table's width); f32
pages, on no serving path, keep the CUDA-core kernel. There is no
fallback from one to the other, and no backward: a CUDA input that
requires grad while grad mode is on is refused. Rows past a slot's
valid length are garbage by contract on every path; the MLA kernels
write a row tile (``mla_row_tile``: 64 rows on bf16 or int8 pages, 32
on f32 pages) whose rows all belong to chunk entries at or past
``max(len, 1)`` as 0 without reading a page (with 128 heads, every row
of such an entry).
"""
from __future__ import annotations

import ctypes
import functools
import re
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {**_DTYPES, torch.int8: 2}
MAX_HEAD_DIM = 256
MAX_BLOCK_SIZE = 64
# MLA ranks (kv_lora_rank) the tensor-core MLA kernel is built for:
# deepseek-v3's 512, and its reduced configuration's 32.
MLA_TC_RANKS = (32, 512)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("paged_attention")
    lib.paged_attention_gqa.restype = ctypes.c_int
    lib.paged_attention_gqa.argtypes = (
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
        + [ctypes.c_float, ctypes.c_void_p])
    lib.paged_attention_gqa_smem.restype = ctypes.c_longlong
    lib.paged_attention_gqa_smem.argtypes = [ctypes.c_int] * 5
    lib.paged_attention_gqa_tc.restype = ctypes.c_int
    lib.paged_attention_gqa_tc.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 9
        + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])
    lib.paged_attention_gqa_tc_plan.restype = None
    lib.paged_attention_gqa_tc_plan.argtypes = (
        [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)])
    lib.paged_attention_mla.restype = ctypes.c_int
    lib.paged_attention_mla.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
        + [ctypes.c_float, ctypes.c_void_p])
    lib.paged_attention_mla_splits.restype = ctypes.c_int
    lib.paged_attention_mla_splits.argtypes = [ctypes.c_int]
    lib.paged_attention_mla_smem.restype = ctypes.c_longlong
    lib.paged_attention_mla_smem.argtypes = [ctypes.c_int] * 3
    lib.paged_attention_mla_row_tile.restype = ctypes.c_int
    lib.paged_attention_mla_row_tile.argtypes = [ctypes.c_int]
    lib.paged_attention_mla_max_d1.restype = ctypes.c_int
    lib.paged_attention_mla_tc.restype = ctypes.c_int
    lib.paged_attention_mla_tc.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 10
        + [ctypes.c_int] * 14 + [ctypes.c_float, ctypes.c_void_p])
    lib.paged_attention_mla_tc_smem.restype = ctypes.c_longlong
    lib.paged_attention_mla_tc_smem.argtypes = [ctypes.c_int] * 7
    lib.paged_attention_mla_tc_scratch.restype = None
    lib.paged_attention_mla_tc_scratch.argtypes = (
        [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_longlong)])
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _splits(slot_heads: int, max_blocks: int, sms: int):
    """(pages_per_split, splits): split each (slot, kv-head)'s page walk
    into contiguous runs when the slots alone would leave SMs idle."""
    want = min(max_blocks, max(1, -(-2 * sms // slot_heads)))
    per = -(-max_blocks // want)
    return per, -(-max_blocks // per)


@functools.lru_cache(maxsize=None)
def _smem_limit(device: torch.device) -> int:
    props = torch.cuda.get_device_properties(device)
    return int(getattr(props, "shared_memory_per_block_optin", 227 * 1024))


def _pages_and_scales(name, pages, scales, scale_name, shape3) -> None:
    """int8 pages come with fp16 (NP, bs, Hkv) scale pages, other pages
    with none."""
    if (scales is not None) != (pages.dtype == torch.int8):
        raise ValueError(f"{pages.dtype} {name} with "
                         f"{'no ' if scales is None else ''}{scale_name}: "
                         f"int8 pages need {scale_name}, other pages take "
                         "none")
    if scales is not None and (scales.dtype != torch.float16
                               or tuple(scales.shape) != shape3):
        raise TypeError(f"{scale_name} must be float16 {shape3}; got "
                        f"{scales.dtype} {tuple(scales.shape)}")


def _check(q, k_pages, v_pages, block_tables, positions, lengths, k_scales,
           v_scales, q2, k2_pages, k2_scales) -> None:
    if q.ndim != 4 or k_pages.ndim != 4:
        raise ValueError(f"q (B,C,H,D) and pages (NP,bs,Hkv,D) expected; "
                         f"got {tuple(q.shape)}, {tuple(k_pages.shape)}")
    b, c, h, d = q.shape
    _, bs, hkv, dk = k_pages.shape
    if dk != d or (v_pages is not None
                   and tuple(v_pages.shape) != tuple(k_pages.shape)):
        vs = None if v_pages is None else tuple(v_pages.shape)
        raise ValueError(f"k/v pages must both be (NP, bs, Hkv, {d}); got "
                         f"{tuple(k_pages.shape)}, {vs}")
    if h % hkv:
        raise ValueError(f"H={h} is not a multiple of Hkv={hkv}")
    if block_tables.ndim != 2 or block_tables.shape[0] != b:
        raise ValueError(f"tables must be (B={b}, MB); got "
                         f"{tuple(block_tables.shape)}")
    for name, t in (("positions", positions), ("lengths", lengths)):
        if tuple(t.shape) != (b,):
            raise ValueError(f"{name} must be ({b},); got {tuple(t.shape)}")
    # The JAX kernel's asserts: v_scales travels with v_pages, k2_scales
    # with k2_pages, each scale page with int8 pages only.
    if v_pages is None and v_scales is not None:
        raise ValueError("v_scales must accompany v_pages (with "
                         "v_pages=None the K pages and scales are V)")
    if v_pages is not None and (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must accompany each other")
    if (q2 is None) != (k2_pages is None):
        raise ValueError("q2 and k2_pages must accompany each other")
    if q2 is not None and v_pages is not None:
        raise ValueError("the RoPE side (q2/k2_pages) is the MLA form: "
                         "pass v_pages=None (the K pages are V)")
    shape3 = tuple(k_pages.shape[:3])
    _pages_and_scales("pages", k_pages, k_scales, "k_scales", shape3)
    if v_pages is not None:
        _pages_and_scales("pages", v_pages, v_scales, "v_scales", shape3)
    if k2_pages is None:
        if k2_scales is not None:
            raise ValueError("k2_scales must accompany k2_pages")
        return
    if q2.ndim != 4 or tuple(q2.shape[:3]) != (b, c, h) \
            or k2_pages.ndim != 4 or tuple(k2_pages.shape[:3]) != shape3 \
            or k2_pages.shape[3] != q2.shape[3]:
        raise ValueError(f"q2 must be ({b}, {c}, {h}, D2) and k2_pages "
                         f"{shape3 + ('D2',)}; got {tuple(q2.shape)}, "
                         f"{tuple(k2_pages.shape)}")
    if k2_pages.dtype != k_pages.dtype:
        raise TypeError(f"k2_pages {k2_pages.dtype} must match the K pages' "
                        f"{k_pages.dtype}")
    _pages_and_scales("k2_pages", k2_pages, k2_scales, "k2_scales", shape3)


class MlaPlan(NamedTuple):
    """The whole call a tensor-core MLA call is a shard of: its
    ``positions`` and ``lengths`` (int32, one per slot of the whole call,
    on the call's device), the shard's first slot ``slot0`` in them, the
    whole call's query ``heads`` and the shard's first head ``head0``
    (within each kv head's group). The kernel plans the step, and splits
    every row's page walk, as that call does, so the shard's rows are
    its rows bit for bit."""
    positions: torch.Tensor
    lengths: torch.Tensor
    slot0: int
    heads: int
    head0: int


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages, block_tables: torch.Tensor,
                           positions: torch.Tensor, *, sm_scale: float,
                           lengths=None, k_scales=None, v_scales=None,
                           q2=None, k2_pages=None,
                           k2_scales=None, plan_parts=(1, 1),
                           mla_plan: Optional[MlaPlan] = None
                           ) -> torch.Tensor:
    """Fused paged decode attention over a chunk of C queries per slot.

    Returns (B, C, H, D) in q's dtype. ``v_pages=None`` is the MLA form
    (the K pages are V), which takes the RoPE side ``q2``/``k2_pages``
    (and ``k2_scales`` on int8 pages); its launches are counted apart.

    ``plan_parts`` (the GQA form): (slot blocks, head blocks) of the
    unsharded call this one is a shard of, so the launch splits each
    page walk as that call does. The tensor-core GQA plan depends on C,
    G = H / Hkv, D, the table width and the block size only, so a
    kv-head or slot shard keeps it as is; the CUDA-core GQA split is
    planned for the unsharded B * Hkv. ``mla_plan`` (the MLA form): the
    whole call this one is a shard of (``MlaPlan``; None: the call is
    whole). The tensor-core MLA kernel picks its split on the card from
    the whole call's row tiles and depths and walks only the tiles that
    hold the shard's rows, so a slot or head shard's rows are the whole
    call's bit for bit; the CUDA-core MLA kernel (f32 pages, on no
    serving path) plans from its own rows and refuses a plan."""
    b, c = q.shape[:2]
    if lengths is None:
        lengths = torch.full((b,), c, dtype=torch.int32, device=q.device)
    _check(q, k_pages, v_pages, block_tables, positions, lengths, k_scales,
           v_scales, q2, k2_pages, k2_scales)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   positions, sm_scale=sm_scale,
                                   k_scales=k_scales, v_scales=v_scales,
                                   q2=q2, k2_pages=k2_pages,
                                   k2_scales=k2_scales)
    dev = q.device
    tensors = [t for t in (q, q2, k_pages, k2_pages, v_pages, k_scales,
                           k2_scales, v_scales) if t is not None]
    index = (block_tables, positions, lengths)
    if dev.type != "cuda" or any(t.device != dev
                                 for t in tensors + list(index)):
        raise ValueError("paged_decode_attention needs every operand on one "
                         "CUDA device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("paged_decode_attention has no backward: an "
                           "input that requires grad would lose its "
                           "gradient at the kernel launch")
    if not all(t.is_contiguous() for t in tensors + list(index)):
        raise ValueError("paged_decode_attention needs contiguous operands")
    if q.dtype not in _DTYPES or k_pages.dtype not in _KV_DTYPES \
            or (v_pages is not None and v_pages.dtype != k_pages.dtype) \
            or (q2 is not None and q2.dtype != q.dtype):
        raise TypeError(f"q {q.dtype}, pages {k_pages.dtype}: f32 or bf16 q "
                        "(and q2), and f32, bf16 or int8 pages expected")
    if any(t.dtype != torch.int32 for t in index):
        raise TypeError("tables, positions and lengths must be int32")
    if k_pages.shape[1] > MAX_BLOCK_SIZE:
        raise ValueError(f"block_size {k_pages.shape[1]} > {MAX_BLOCK_SIZE} "
                         "is not supported")
    tables = (block_tables, positions, lengths)
    if v_pages is None:
        out = _launch_mla(q, q2, k_pages, k2_pages, k_scales, k2_scales,
                          *tables, sm_scale, mla_plan)
        if k_scales is None:
            paged_decode_attention.mla_launches += 1
        else:
            paged_decode_attention.mla_int8_launches += 1
        return out
    out = _launch_gqa(q, k_pages, v_pages, k_scales, v_scales, *tables,
                      sm_scale, plan_parts)
    if k_scales is None:
        paged_decode_attention.launches += 1
    else:
        paged_decode_attention.int8_launches += 1
    return out


def _launch_gqa(q, k_pages, v_pages, k_scales, v_scales, block_tables,
                positions, lengths, sm_scale, plan_parts=(1, 1)):
    """One launch of the GQA form, the kernel picked by q's dtype: bf16 q
    (on bf16 or int8 pages) the tensor-core kernel, f32 q the CUDA-core
    kernel. Counts nothing."""
    dev = q.device
    b, c, h, d = q.shape
    _, bs, hkv, _ = k_pages.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} > {MAX_HEAD_DIM} is not supported")
    if q.dtype == torch.bfloat16:
        return _launch_gqa_tc(q, k_pages, v_pages, k_scales, v_scales,
                              block_tables, positions, lengths, sm_scale)
    lib = _lib()
    smem = lib.paged_attention_gqa_smem(c, h, hkv, d, bs)
    if smem > _smem_limit(dev):
        raise ValueError(f"chunk {c} x group {h // hkv} x head_dim {d} needs "
                         f"{smem} B of shared memory; the card allows "
                         f"{_smem_limit(dev)}")
    out = torch.empty_like(q)
    mb = block_tables.shape[1]
    per, splits = _splits(b * hkv * plan_parts[0] * plan_parts[1], mb,
                          _sm_count(dev))
    rows = c * (h // hkv)
    part_acc = part_ml = out
    if splits > 1:      # per-split partials for the merge pass
        part_acc = torch.empty((b * hkv * splits * rows * d,),
                               dtype=torch.float32, device=dev)
        part_ml = torch.empty((b * hkv * splits * 2 * rows,),
                              dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.paged_attention_gqa(
            q.data_ptr(), _DTYPES[q.dtype], k_pages.data_ptr(),
            v_pages.data_ptr(), _KV_DTYPES[k_pages.dtype],
            None if k_scales is None else k_scales.data_ptr(),
            None if v_scales is None else v_scales.data_ptr(),
            block_tables.data_ptr(), positions.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
            part_ml.data_ptr(), b, c, h, hkv, d, bs, mb, per, splits,
            float(sm_scale), stream)
    if err:
        raise RuntimeError(f"paged_attention_gqa launch failed: "
                           f"cudaError {err}")
    return out


@functools.lru_cache(maxsize=None)
def _tc_plan(c, h, hkv, d, kv, mb, bs):
    """(rows per block, row groups, key tiles per split, splits, shared
    bytes) of the tensor-core kernel (``paged_attention_gqa_tc_plan``)."""
    plan = (ctypes.c_int * 5)()
    _lib().paged_attention_gqa_tc_plan(c, h, hkv, d, kv, mb, bs, plan)
    return tuple(plan)


def _launch_gqa_tc(q, k_pages, v_pages, k_scales, v_scales, block_tables,
                   positions, lengths, sm_scale):
    dev = q.device
    b, c, h, d = q.shape
    _, bs, hkv, _ = k_pages.shape
    if q.dtype != torch.bfloat16 or k_pages.dtype == torch.float32:
        raise TypeError(f"the tensor-core kernel takes bf16 q on bf16 or "
                        f"int8 pages; got {q.dtype}, {k_pages.dtype}")
    if d % 16:
        raise ValueError(f"head_dim {d}: bf16 queries need a multiple of 16")
    if not all(t.data_ptr() % 16 == 0 for t in (q, k_pages, v_pages)):
        raise ValueError("q and pages must be 16-byte aligned")
    kv = _KV_DTYPES[k_pages.dtype]
    mb = block_tables.shape[1]
    rows, groups, tps, splits, smem = _tc_plan(c, h, hkv, d, kv, mb, bs)
    if smem > _smem_limit(dev):
        raise ValueError(f"chunk {c} x group {h // hkv} x head_dim {d} needs "
                         f"{smem} B of shared memory; the card allows "
                         f"{_smem_limit(dev)}")
    lib = _lib()
    out = torch.empty_like(q)
    units = b * hkv * groups
    part_acc = part_ml = tickets = out
    if splits > 1:      # per-split partials, merged by the last block
        part_acc = torch.empty((units * splits * rows * d,),
                               dtype=torch.float32, device=dev)
        part_ml = torch.empty((units * splits * 2 * rows,),
                              dtype=torch.float32, device=dev)
        # Zeroed on this launch's stream for this launch alone, so no
        # earlier launch (aborted, on another stream, or in a CUDA graph)
        # can leave a count behind that keeps the merge from firing.
        tickets = torch.zeros((units,), dtype=torch.int32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.paged_attention_gqa_tc(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), kv,
            ptr(k_scales), ptr(v_scales), block_tables.data_ptr(),
            positions.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            part_acc.data_ptr(), part_ml.data_ptr(), tickets.data_ptr(), b,
            c, h, hkv, d, bs, mb, splits, groups, tps, float(sm_scale),
            stream)
    if err:
        raise RuntimeError(f"paged_attention_gqa_tc launch failed: "
                           f"cudaError {err}")
    return out


def _launch_mla(q, q2, k_pages, k2_pages, k_scales, k2_scales, block_tables,
                positions, lengths, sm_scale, mla_plan=None):
    """One launch of the MLA form: f32 q_eff/q_rope in (what
    ``mla_decode`` passes), f32 out. bf16 or int8 pages (every serving
    path) run the tensor-core kernel; f32 pages, on no serving path, the
    CUDA-core kernel. Counts nothing."""
    if q.dtype != torch.float32:
        raise TypeError(f"the MLA form takes float32 q (and q2); got "
                        f"{q.dtype}")
    if k_pages.dtype == torch.float32:
        if mla_plan is not None:
            raise ValueError("the CUDA-core MLA kernel (f32 pages) plans "
                             "from its own rows: it takes no whole-call "
                             "plan")
        return _launch_mla_cc(q, q2, k_pages, k2_pages, k_scales, k2_scales,
                              block_tables, positions, lengths, sm_scale)
    return _launch_mla_tc(q, q2, k_pages, k2_pages, k_scales, k2_scales,
                          block_tables, positions, lengths, sm_scale,
                          mla_plan)


def mla_row_tile(pages_dtype: torch.dtype) -> int:
    """Query rows of the MLA kernel's row tile on pages of
    ``pages_dtype``: a tile whose rows all lie past a slot's valid length
    is written as 0 without reading a page."""
    return _lib().paged_attention_mla_row_tile(_KV_DTYPES[pages_dtype])


@functools.lru_cache(maxsize=None)
def mla_parts():
    """(bf16 parts of the f32 queries, bf16 parts of p) of the
    tensor-core MLA kernel: ``mtc::NQ`` and ``mtc::NP``, read from its
    source (their one definition), so a CPU emulation of the kernel's
    arithmetic holds the counts the kernel is built with."""
    src = (_build.CSRC / "paged_attention.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {n} = (\d+);", src).group(1))
                 for n in ("NQ", "NP"))


# The plan the last tensor-core MLA launch took, on the card: (key tiles
# of 16 keys a split, the step's (row tile, split) items, the most splits
# of a row tile); see ``mla_last_plan``.
_last_plan = None


def mla_last_plan():
    """The page-walk split the last tensor-core MLA launch took, as the
    kernel wrote it (read back from the card): (key tiles of 16 keys a
    split, the step's (row tile, split) items, the most splits of a row
    tile)."""
    if _last_plan is None:
        raise RuntimeError("no tensor-core MLA launch yet")
    return tuple(int(x) for x in _last_plan.tolist())


@functools.lru_cache(maxsize=None)
def mla_tc_row_tile() -> int:
    """Query rows of the tensor-core MLA kernel's row tile (``mtc::RT``),
    read from its source (its one definition), so the shard rules below
    hold on the CPU too."""
    src = (_build.CSRC / "paged_attention.cu").read_text()
    return int(re.search(r"constexpr int RT = (\d+);", src).group(1))


@functools.lru_cache(maxsize=None)
def _mla_tc_scratch(b, c, h, hkv, d1, bs, mb):
    """(splits the launch has room for, floats of the partials, floats of
    their (max, sum), tickets) of the tensor-core MLA kernel."""
    n = (ctypes.c_longlong * 4)()
    _lib().paged_attention_mla_tc_scratch(b, c, h, hkv, d1, bs, mb, n)
    return tuple(n)


def _launch_mla_tc(q, q2, k_pages, k2_pages, k_scales, k2_scales,
                   block_tables, positions, lengths, sm_scale,
                   plan: Optional[MlaPlan] = None):
    """The tensor-core kernel (bf16 or int8 pages): one cooperative
    launch of one block per SM walking the step's (64-row tile,
    page-walk split) items; the card picks the split from the whole
    call's positions and lengths (``plan``; the call's own when None),
    and the splits of a tile merge inside the launch."""
    dev = q.device
    b, c, h, d1 = q.shape
    _, bs, hkv, _ = k_pages.shape
    if plan is None:
        plan = MlaPlan(positions, lengths, 0, h, 0)
    bw = plan.positions.shape[0]
    if plan.heads % hkv or plan.head0 < 0 \
            or plan.head0 + h // hkv > plan.heads // hkv \
            or plan.slot0 < 0 or plan.slot0 + b > bw \
            or tuple(plan.lengths.shape) != (bw,) \
            or any(t.dtype != torch.int32 or t.device != dev
                   or not t.is_contiguous()
                   for t in (plan.positions, plan.lengths)):
        raise ValueError(f"plan {plan.slot0}+{b} of {bw} slots, heads "
                         f"{plan.head0}+{h // hkv} of {plan.heads // hkv}: "
                         "not a shard of it (int32 positions and lengths "
                         "on the call's device)")
    d2 = 0 if q2 is None else q2.shape[3]
    if d1 not in MLA_TC_RANKS or d2 % 16 or d2 > 256:
        raise ValueError(f"MLA widths D={d1}, D2={d2}: the tensor-core "
                         f"kernel takes D in {MLA_TC_RANKS} and D2 a "
                         "multiple of 16 up to 256")
    if not all(t.data_ptr() % 16 == 0
               for t in (q, q2, k_pages, k2_pages) if t is not None):
        raise ValueError("q, q2 and pages must be 16-byte aligned")
    lib = _lib()
    kv = _KV_DTYPES[k_pages.dtype]
    mb = block_tables.shape[1]
    smem = lib.paged_attention_mla_tc_smem(bw, c, plan.heads, hkv, d1, d2,
                                           kv)
    if smem > _smem_limit(dev):
        raise ValueError(f"D={d1} + D2={d2} for {b} x {c} x {h} rows needs "
                         f"{smem} B of shared memory; the card allows "
                         f"{_smem_limit(dev)}")
    splits, n_acc, n_ml, n_tickets = _mla_tc_scratch(b, c, plan.heads,
                                                     hkv, d1, bs, mb)
    out = torch.empty_like(q)
    part_acc = part_ml = tickets = out
    if splits > 1:      # per-split partials, merged inside the launch
        part_acc = torch.empty((n_acc,), dtype=torch.float32, device=dev)
        part_ml = torch.empty((n_ml,), dtype=torch.float32, device=dev)
        # Zeroed on this launch's stream for this launch alone (as the
        # GQA form's tickets).
        tickets = torch.zeros((n_tickets,), dtype=torch.int32, device=dev)
    took = torch.empty((3,), dtype=torch.int32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.paged_attention_mla_tc(
            q.data_ptr(), ptr(q2), k_pages.data_ptr(), ptr(k2_pages), kv,
            ptr(k_scales), ptr(k2_scales), block_tables.data_ptr(),
            plan.positions.data_ptr(), plan.lengths.data_ptr(),
            out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
            tickets.data_ptr(), took.data_ptr(), b, c, h, hkv, d1, d2, bs,
            mb, splits, _sm_count(dev), bw, plan.slot0, plan.heads,
            plan.head0, float(sm_scale), stream)
    if err:
        raise RuntimeError(f"paged_attention_mla_tc launch failed: "
                           f"cudaError {err}")
    global _last_plan
    _last_plan = took
    return out


def _launch_mla_cc(q, q2, k_pages, k2_pages, k_scales, k2_scales,
                   block_tables, positions, lengths, sm_scale):
    """The CUDA-core kernel (f32 pages): rows tiled ``row_tile`` at a
    time across blocks; the launch has room for the most page splits a
    step can take, and the card takes as many as the pages the step's
    live rows walk need (a second kernel merges them)."""
    dev = q.device
    b, c, h, d1 = q.shape
    _, bs, hkv, _ = k_pages.shape
    d2 = 0 if q2 is None else q2.shape[3]
    if k_pages.dtype != torch.float32 or k_scales is not None:
        raise TypeError(f"the CUDA-core MLA kernel takes f32 pages; got "
                        f"{k_pages.dtype}")
    lib = _lib()
    if d1 % 4 or d2 % 4 or d1 > lib.paged_attention_mla_max_d1():
        raise ValueError(f"MLA widths D={d1}, D2={d2} must be multiples of "
                         f"4, D at most {lib.paged_attention_mla_max_d1()}")
    if not all(t.data_ptr() % 16 == 0
               for t in (q, q2, k_pages, k2_pages) if t is not None):
        raise ValueError("q, q2 and pages must be 16-byte aligned")
    smem = lib.paged_attention_mla_smem(d1, d2, bs)
    if smem > _smem_limit(dev):
        raise ValueError(f"D={d1} + D2={d2} at block_size {bs} needs {smem} "
                         f"B of shared memory; the card allows "
                         f"{_smem_limit(dev)}")
    rt = lib.paged_attention_mla_row_tile(_KV_DTYPES[torch.float32])
    row_tiles = -(-c * (h // hkv) // rt)
    mb = block_tables.shape[1]
    splits = lib.paged_attention_mla_splits(mb)
    out = torch.empty_like(q)
    part_acc = part_ml = out
    if splits > 1:
        tiles = b * hkv * row_tiles * splits
        part_acc = torch.empty((tiles * rt * d1,), dtype=torch.float32,
                               device=dev)
        part_ml = torch.empty((tiles * 2 * rt + 1,), dtype=torch.float32,
                              device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.paged_attention_mla(
            q.data_ptr(), ptr(q2), k_pages.data_ptr(), ptr(k2_pages),
            block_tables.data_ptr(), positions.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
            part_ml.data_ptr(), b, c, h, hkv, d1, d2, bs, mb, splits,
            _sm_count(dev), float(sm_scale), stream)
    if err:
        raise RuntimeError(f"paged_attention_mla launch failed: "
                           f"cudaError {err}")
    return out


# Launches of each form, counted apart: GQA bf16/f32, GQA int8, MLA
# bf16/f32 and MLA int8.
paged_decode_attention.launches = 0
paged_decode_attention.int8_launches = 0
paged_decode_attention.mla_launches = 0
paged_decode_attention.mla_int8_launches = 0
