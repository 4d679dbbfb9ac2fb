"""Fused paged decode attention, GQA forms: wrapper of ``csrc/paged_attention.cu``.

The port of ``repro.kernels.paged_attention.paged_decode_attention`` for
bf16/f32 pages, and for int8 code pages with fp16 scale pages (the
``k_scales``/``v_scales`` form); the MLA form (shared K/V, the RoPE side
``q2``/``k2_pages``) is ROADMAP B9 and refused.
Layout contract (``PagedKVArena.page_layout``, docs/kernel-contracts.md):

  q         (B, C, H, D)      C >= 1 chunk queries per slot
  k_pages   (NP, bs, Hkv, D)  physical pages incl. the trailing null page
  v_pages   (NP, bs, Hkv, D)
  tables    (B, MB) int32     logical block -> physical page
  positions (B,) int32        chunk base: query i sits at base + i and
                              attends kv positions <= base + i
  lengths   (B,) int32        valid queries per row (default C)
  k_scales  (NP, bs, Hkv) f16 with int8 pages: one scale per (in-page
  v_scales  (NP, bs, Hkv) f16 position, kv-head); element = code * scale

On a CPU tensor the wrapper computes the plain version
(``ref.paged_attention_ref``); on a CUDA tensor it launches the
hand-written kernel or raises. Rows past a slot's valid length are
garbage by contract on both paths.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {**_DTYPES, torch.int8: 2}
MAX_HEAD_DIM = 256
MAX_BLOCK_SIZE = 64


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


def _check(q, k_pages, v_pages, block_tables, positions, lengths, k_scales,
           v_scales) -> None:
    if v_pages is None:
        raise NotImplementedError("shared K/V pages (v_pages=None) are the "
                                  "MLA form, ROADMAP B9")
    if q.ndim != 4 or k_pages.ndim != 4:
        raise ValueError(f"q (B,C,H,D) and pages (NP,bs,Hkv,D) expected; "
                         f"got {tuple(q.shape)}, {tuple(k_pages.shape)}")
    b, c, h, d = q.shape
    _, bs, hkv, dk = k_pages.shape
    if tuple(v_pages.shape) != tuple(k_pages.shape) or dk != d:
        raise ValueError(f"k/v pages must both be (NP, bs, Hkv, {d}); got "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    if h % hkv:
        raise ValueError(f"H={h} is not a multiple of Hkv={hkv}")
    if block_tables.ndim != 2 or block_tables.shape[0] != b:
        raise ValueError(f"tables must be (B={b}, MB); got "
                         f"{tuple(block_tables.shape)}")
    for name, t in (("positions", positions), ("lengths", lengths)):
        if tuple(t.shape) != (b,):
            raise ValueError(f"{name} must be ({b},); got {tuple(t.shape)}")
    # Scale pages travel with int8 pages, both or neither (the JAX
    # kernel's asserts), each fp16 (NP, bs, Hkv).
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must accompany each other")
    if (k_scales is not None) != (k_pages.dtype == torch.int8):
        raise ValueError(f"{k_pages.dtype} pages with "
                         f"{'no ' if k_scales is None else ''}scale pages: "
                         "int8 pages need k_scales/v_scales, other pages "
                         "take none")
    for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
        if t is None:
            continue
        if t.dtype != torch.float16 or tuple(t.shape) != \
                tuple(k_pages.shape[:3]):
            raise TypeError(f"{name} must be float16 "
                            f"{tuple(k_pages.shape[:3])}; got {t.dtype} "
                            f"{tuple(t.shape)}")


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           positions: torch.Tensor, *, sm_scale: float,
                           lengths=None, k_scales=None, v_scales=None,
                           q2=None, k2_pages=None,
                           k2_scales=None) -> torch.Tensor:
    """Fused paged decode attention over a chunk of C queries per slot.

    Returns (B, C, H, D) in q's dtype. ``q2``/``k2_pages``/``k2_scales``
    (the MLA RoPE side) are refused: that form is ROADMAP B9."""
    if q2 is not None or k2_pages is not None or k2_scales is not None:
        raise NotImplementedError("the MLA RoPE side (q2/k2_pages) is "
                                  "ROADMAP B9")
    b, c = q.shape[:2]
    if lengths is None:
        lengths = torch.full((b,), c, dtype=torch.int32, device=q.device)
    _check(q, k_pages, v_pages, block_tables, positions, lengths, k_scales,
           v_scales)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   positions, sm_scale=sm_scale,
                                   k_scales=k_scales, v_scales=v_scales)
    dev = q.device
    tensors = (q, k_pages, v_pages, block_tables, positions, lengths) + (
        () if k_scales is None else (k_scales, v_scales))
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("paged_decode_attention needs every operand on one "
                         "CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_decode_attention needs contiguous operands")
    if q.dtype not in _DTYPES or k_pages.dtype not in _KV_DTYPES \
            or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"q {q.dtype}, pages {k_pages.dtype}/{v_pages.dtype}:"
                        " f32 or bf16 q, and f32, bf16 or int8 pages "
                        "expected")
    if any(t.dtype != torch.int32 for t in tensors[3:6]):
        raise TypeError("tables, positions and lengths must be int32")
    _, _, h, d = q.shape
    _, bs, hkv, _ = k_pages.shape
    if d > MAX_HEAD_DIM or bs > MAX_BLOCK_SIZE:
        raise ValueError(f"head_dim {d} > {MAX_HEAD_DIM} or block_size {bs} "
                         f"> {MAX_BLOCK_SIZE} is not supported")
    lib = _lib()
    smem = lib.paged_attention_gqa_smem(c, h, hkv, d, bs)
    if smem > _smem_limit(dev):
        raise ValueError(f"chunk {c} x group {h // hkv} x head_dim {d} needs "
                         f"{smem} B of shared memory; the card allows "
                         f"{_smem_limit(dev)}")
    out = torch.empty_like(q)
    mb = block_tables.shape[1]
    per, splits = _splits(b * hkv, mb, _sm_count(dev))
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
    if k_scales is None:
        paged_decode_attention.launches += 1
    else:
        paged_decode_attention.int8_launches += 1
    return out


# Launches of the bf16/f32 form and of the int8 form, counted apart.
paged_decode_attention.launches = 0
paged_decode_attention.int8_launches = 0
