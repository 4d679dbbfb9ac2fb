"""Blocked online-softmax attention: wrapper of ``csrc/flash_attention.cu``.

The port of ``repro.kernels.flash_attention.flash_attention`` (the
prefill / full-sequence attention; the models reach it through
``attention.chunked_attention``, as the JAX package's models reach its
XLA twin). It works in the model's layout, so no call transposes:

  q   (B, Sq, H, D)      f32 or bf16
  k   (B, Skv, Hkv, D)   same dtype, H % Hkv == 0
  v   (B, Skv, Hkv, Dv)  same dtype (Dv may differ from D: MLA prefill)
  out (B, Sq, H, Dv)     q's dtype, rounded once from f32

Key j < Skv is visible to query i iff, when ``causal``,
j <= ``q_offset`` + i; a row that sees no key is 0.

On a CPU tensor the wrapper computes the plain version
(``ref.attention_ref``); on a CUDA tensor it launches a hand-written
kernel or raises. The dtype alone picks the kernel: bf16 q, k, v (every
prefill and forward path of the models) run the tensor-core kernel
(``mma.sync`` bf16 products, ``cp.async`` staging; D and Dv multiples
of 16), f32 the CUDA-core kernel (D and Dv multiples of 4), whose f32
products meet the f32 tolerance that tensor cores cannot. It has no
backward: a CUDA tensor that requires grad is refused (training is
ROADMAP A18).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("flash_attention")
    for fn in (lib.flash_attention, lib.flash_attention_cuda_cores):
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_smem.restype = ctypes.c_longlong
    lib.flash_attention_smem.argtypes = [ctypes.c_int] * 3
    return lib


@functools.lru_cache(maxsize=None)
def _smem_limit(device: torch.device) -> int:
    props = torch.cuda.get_device_properties(device)
    return int(getattr(props, "shared_memory_per_block_optin", 227 * 1024))


def _check(q, k, v) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"q (B,Sq,H,D), k (B,Skv,Hkv,D), v (B,Skv,Hkv,Dv) "
                         f"expected; got {tuple(q.shape)}, {tuple(k.shape)},"
                         f" {tuple(v.shape)}")
    b, _, h, d = q.shape
    bk, skv, hkv, dk = k.shape
    if bk != b or dk != d or tuple(v.shape[:3]) != (b, skv, hkv):
        raise ValueError(f"k must be ({b}, Skv, Hkv, {d}) and v (B, Skv, "
                         f"Hkv, Dv); got {tuple(k.shape)}, {tuple(v.shape)}")
    if h % hkv:
        raise ValueError(f"H={h} is not a multiple of Hkv={hkv}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale=None,
                    q_offset: int = 0) -> torch.Tensor:
    """Attention of q against k/v; returns (B, Sq, H, Dv) in q's dtype."""
    _check(q, k, v)
    d = q.shape[-1]
    if sm_scale is None:
        sm_scale = d ** -0.5
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, sm_scale=sm_scale,
                             q_offset=q_offset)
    return _launch(q, k, v, causal=causal, sm_scale=sm_scale,
                   q_offset=q_offset, tensor_cores=q.dtype == torch.bfloat16)


def _launch(q, k, v, *, causal, sm_scale, q_offset, tensor_cores,
            count=True):
    """Check CUDA operands and launch one kernel: the tensor-core one
    (bf16 only) or the CUDA-core one. ``flash_attention`` picks by dtype;
    ``chip_smoke.py`` also times the CUDA-core kernel on bf16 operands
    (the earlier design) beside it, with ``count=False``. A launch adds
    one to ``flash_attention.launches`` when ``count``; an empty Sq
    launches nothing."""
    dev = q.device
    tensors = (q, k, v)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("flash_attention needs q, k, v on one CUDA device")
    if any(t.requires_grad for t in tensors):
        raise NotImplementedError("flash_attention has no backward "
                                  "(training is ROADMAP A18)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q {q.dtype}, k {k.dtype}, v {v.dtype}: one dtype, "
                        "f32 or bf16, expected")
    if tensor_cores and q.dtype != torch.bfloat16:
        raise TypeError(f"the tensor-core kernel takes bf16; got {q.dtype}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError("flash_attention needs contiguous, 16-byte "
                         "aligned q, k, v")
    b, sq, h, d = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    mult = 16 if tensor_cores else 4
    if d % mult or dv % mult or max(d, dv) > MAX_HEAD_DIM:
        raise ValueError(f"head dims D={d}, Dv={dv} must be multiples of "
                         f"{mult} ({q.dtype}) and at most {MAX_HEAD_DIM}")
    lib = _lib()
    smem = lib.flash_attention_smem(int(tensor_cores), d, dv)
    if smem > _smem_limit(dev):
        raise ValueError(f"D={d}, Dv={dv} needs {smem} B of shared memory; "
                         f"the card allows {_smem_limit(dev)}")
    out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=dev)
    if sq == 0:
        return out
    fn = lib.flash_attention if tensor_cores else \
        lib.flash_attention_cuda_cores
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _DTYPES[q.dtype], b, sq, skv, h, hkv, d, dv, int(q_offset),
                 int(bool(causal)), float(sm_scale), stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    if count:
        flash_attention.launches += 1
    return out


flash_attention.launches = 0
