"""Q8_0 fused dequant-matmul: wrapper of ``csrc/q8_0_matmul.cu``.

The port of ``repro.kernels.q8_0_matmul.matmul_q8_0`` (paper Fig. 5/7:
int8 quants scaled per 32-element block by an fp16 scale, one shared
f32 MAC back-end). On a CPU tensor the wrapper computes the plain
version (``ref.matmul_ref``); on a CUDA tensor it launches the
hand-written kernel or raises.

Planes: {"qs": int8 (N, K), "d": float16 (N, K/32)}; K % 32 == 0.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import matmul_ref

_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TILE = 64                     # the kernel's BM == BN


def _check(x: torch.Tensor, qs: torch.Tensor, d: torch.Tensor) -> None:
    if x.ndim != 2 or qs.ndim != 2 or d.ndim != 2:
        raise ValueError(f"expected 2-D x, qs, d; got {tuple(x.shape)}, "
                         f"{tuple(qs.shape)}, {tuple(d.shape)}")
    m, k = x.shape
    n, k2 = qs.shape
    if k != k2 or k % 32:
        raise ValueError(f"K mismatch or K % 32 != 0: x {tuple(x.shape)}, "
                         f"qs {tuple(qs.shape)}")
    if tuple(d.shape) != (n, k // 32):
        raise ValueError(f"d must be (N, K/32) = {(n, k // 32)}, got "
                         f"{tuple(d.shape)}")
    if x.dtype not in _X_DTYPES or qs.dtype != torch.int8 \
            or d.dtype != torch.float16:
        raise TypeError(f"dtypes x {x.dtype} (f32|bf16), qs {qs.dtype} "
                        f"(int8), d {d.dtype} (f16)")


def _splits(m: int, n: int, k: int, sms: int):
    """(k_split, splits): split K across the grid when the output tiles
    alone would leave most SMs idle (each split is a whole number of
    q8_0 blocks)."""
    tiles = -(-n // _TILE) * -(-m // _TILE)
    nkb = k // 32
    splits = 1 if tiles >= sms else min(nkb, -(-2 * sms // tiles))
    per = -(-nkb // splits)
    return per * 32, -(-nkb // per)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("q8_0_matmul").q8_0_matmul
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def matmul_q8_0(x: torch.Tensor, qs: torch.Tensor, d: torch.Tensor, *,
                out_dtype=torch.float32) -> torch.Tensor:
    """x: (M, K) f32|bf16; qs: (N, K) int8; d: (N, K//32) f16.
    Returns (M, N) in ``out_dtype`` (f32, or bf16 rounded from the f32
    result)."""
    _check(x, qs, d)
    if out_dtype not in _X_DTYPES:
        raise TypeError(f"out_dtype {out_dtype}: f32 or bf16 expected")
    if x.device.type == "cpu":
        return matmul_ref(x, {"qs": qs, "d": d}, "q8_0").to(out_dtype)
    if x.device.type != "cuda" or qs.device != x.device \
            or d.device != x.device:
        raise ValueError(f"matmul_q8_0 needs x, qs, d on one CUDA device; "
                         f"got {x.device}, {qs.device}, {d.device}")
    if not (x.is_contiguous() and qs.is_contiguous() and d.is_contiguous()):
        raise ValueError("matmul_q8_0 needs contiguous x, qs, d")
    if qs.data_ptr() % 16:
        raise ValueError("qs must be 16-byte aligned (vector loads)")
    m, k = x.shape
    n = qs.shape[0]
    y = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return y
    k_split, splits = _splits(m, n, k, _sm_count(x.device))
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=x.device) \
        if splits > 1 else x          # unused without a split
    fn = _kernel()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), _X_DTYPES[x.dtype], qs.data_ptr(),
                 d.data_ptr(), y.data_ptr(), _X_DTYPES[out_dtype],
                 ws.data_ptr(), m, n, k, k_split, splits, stream)
    if err:
        raise RuntimeError(f"q8_0_matmul launch failed: cudaError {err}")
    matmul_q8_0.launches += 1
    return y


matmul_q8_0.launches = 0
