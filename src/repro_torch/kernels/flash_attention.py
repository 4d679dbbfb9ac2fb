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
(``ref.attention_ref``, differentiable under ordinary autograd); on a
CUDA tensor it launches a hand-written kernel or raises. The dtype alone
picks the kernel: bf16 q, k, v (every prefill and forward path of the
models) run the tensor-core kernel (``wgmma`` products on TMA-staged
tiles; D and Dv multiples of 16), f32 the CUDA-core kernel (D and Dv
multiples of 4), whose f32 products meet the f32 tolerance that tensor
cores cannot.

Training: with grad mode on and an input that requires grad, a CUDA
call goes through ``FlashAttention`` (a ``torch.autograd.Function``):
its forward is the same kernel launch, counted the same way; its
backward is plain PyTorch in f32 (``attention_backward``), the port of
XLA's autodiff of the JAX package's ``chunked_attention`` (the JAX
trainer reaches no Pallas kernel; a hand-written backward kernel is
later work). The raw launch refuses an input that requires grad while
grad mode is on, so no gradient can vanish at the ctypes call.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import NEG_INF, attention_ref

_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("flash_attention")
    for fn in (lib.flash_attention, lib.flash_attention_f32):
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, bool(causal), float(sm_scale),
                                    int(q_offset))
    return _launch(q, k, v, causal=causal, sm_scale=sm_scale,
                   q_offset=q_offset)


class FlashAttention(torch.autograd.Function):
    """The kernel's forward with a plain-PyTorch f32 backward that
    recomputes the scores from the saved q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, sm_scale, q_offset)
        return _launch(q.detach(), k.detach(), v.detach(), causal=causal,
                       sm_scale=sm_scale, q_offset=q_offset)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        causal, sm_scale, q_offset = ctx.args
        dq, dk, dv = attention_backward(q, k, v, dout, causal=causal,
                                        sm_scale=sm_scale, q_offset=q_offset)
        return dq, dk, dv, None, None, None


# Score elements (B x H x query rows x Skv, f32) the backward holds at a
# time; it walks the queries in blocks of that many rows.
BACKWARD_BLOCK_ELEMS = 1 << 25


def attention_backward(q, k, v, dout, *, causal: bool, sm_scale: float,
                       q_offset: int = 0):
    """(dq, dk, dv) of ``ref.attention_ref`` at (q, k, v) for the output
    gradient ``dout`` (B, Sq, H, Dv), each in its input's dtype: the
    softmax recomputed in f32 a block of query rows at a time (the
    scores of one block, ``BACKWARD_BLOCK_ELEMS`` elements at most, are
    never all kept), dk and dv summed over the blocks and over each
    kv-head's G = H / Hkv query heads. Masked keys and rows that see no
    key get zero gradient, as autograd of the plain version gives."""
    b, sq, h, d = q.shape
    skv, hkv, dv_ = k.shape[1], k.shape[2], v.shape[-1]
    g = h // hkv
    kf, vf = k.float(), v.float()
    dq = torch.empty((b, sq, h, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros((b, skv, hkv, d), dtype=torch.float32, device=q.device)
    dvf = torch.zeros((b, skv, hkv, dv_), dtype=torch.float32,
                      device=q.device)
    rows = max(1, BACKWARD_BLOCK_ELEMS // max(1, b * h * skv))
    ki = torch.arange(skv, device=q.device)[None, :]
    for i0 in range(0, sq, rows):
        i1 = min(sq, i0 + rows)
        qb = q[:, i0:i1].float().reshape(b, i1 - i0, hkv, g, d)
        ob = dout[:, i0:i1].float().reshape(b, i1 - i0, hkv, g, dv_)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kf) * sm_scale
        qi = torch.arange(i0, i1, device=q.device)[:, None]
        vis = (ki <= q_offset + qi) if causal else (ki >= 0).expand(
            i1 - i0, skv)
        s = torch.where(vis, s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1) * vis.any(-1, keepdim=True)
        del s
        dp = torch.einsum("bqhgd,bkhd->bhgqk", ob, vf)
        ds = p * (dp - (p * dp).sum(-1, keepdim=True))
        del dp
        dq[:, i0:i1] = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf).reshape(
            b, i1 - i0, h, d) * sm_scale
        dk += torch.einsum("bhgqk,bqhgd->bkhd", ds, qb) * sm_scale
        dvf += torch.einsum("bhgqk,bqhgd->bkhd", p, ob)
        del p, ds
    return dq.to(q.dtype), dk.to(k.dtype), dvf.to(v.dtype)


def _launch(q, k, v, *, causal, sm_scale, q_offset):
    """Check CUDA operands and launch the kernel of their dtype (bf16: the
    tensor-core kernel, f32: the CUDA-core kernel), counted on
    ``flash_attention.launches``; an empty Sq launches nothing."""
    dev = q.device
    tensors = (q, k, v)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("flash_attention needs q, k, v on one CUDA device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("flash_attention's raw launch does not record a "
                           "gradient: inputs that require grad go "
                           "through FlashAttention")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q {q.dtype}, k {k.dtype}, v {v.dtype}: one dtype, "
                        "f32 or bf16, expected")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError("flash_attention needs contiguous, 16-byte "
                         "aligned q, k, v")
    bf16 = q.dtype == torch.bfloat16
    b, sq, h, d = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    mult = 16 if bf16 else 4
    if d % mult or dv % mult or max(d, dv) > MAX_HEAD_DIM:
        raise ValueError(f"head dims D={d}, Dv={dv} must be multiples of "
                         f"{mult} ({q.dtype}) and at most {MAX_HEAD_DIM}")
    lib = _lib()
    smem = lib.flash_attention_smem(int(bf16), d, dv)
    if smem > _smem_limit(dev):
        raise ValueError(f"D={d}, Dv={dv} needs {smem} B of shared memory; "
                         f"the card allows {_smem_limit(dev)}")
    out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=dev)
    if sq == 0:
        return out
    fn = lib.flash_attention if bf16 else lib.flash_attention_f32
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, sq, skv, h, hkv, d, dv, int(q_offset),
                 int(bool(causal)), float(sm_scale), stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
