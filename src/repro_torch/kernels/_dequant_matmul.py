"""Launch plumbing shared by the fused dequant-matmul wrappers
(``fp16_matmul``, ``q8_0_matmul``, ``q6_k_matmul``, ``q3_k_matmul``).

Each of their ``csrc/<fmt>_matmul.cu`` sources exposes one C function
over the tile loop of ``csrc/dequant_matmul.cuh``:

    int <fmt>_matmul(x, x_dtype, <plane pointers...>, y, y_dtype,
                     workspace, M, N, K, k_split, splits, stream)

This module builds its ctypes signature, picks the split of K, checks
the operands of a CUDA call, allocates the output and the split-K
workspace, launches, and counts the launch on the wrapper.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build

X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 64                      # the kernel's BM == BN
K_STEP = 32                    # the kernel's BK: splits are multiples of it


def check(name: str, x: torch.Tensor, planes: Dict[str, torch.Tensor],
          layout: Dict[str, Tuple[int, torch.dtype]], k_mult: int,
          out_dtype: torch.dtype) -> None:
    """Shapes and dtypes of one call. ``layout``: {plane: (K elements per
    plane column, dtype)}; every plane is (N, K / that)."""
    if x.ndim != 2 or any(p.ndim != 2 for p in planes.values()):
        raise ValueError(f"{name}: expected 2-D x and planes; got x "
                         f"{tuple(x.shape)}, " + ", ".join(
                             f"{key} {tuple(p.shape)}"
                             for key, p in planes.items()))
    m, k = x.shape
    n = next(iter(planes.values())).shape[0]
    if k % k_mult:
        raise ValueError(f"{name}: K = {k} is not a multiple of {k_mult}")
    for key, (per, dtype) in layout.items():
        want = (n, k // per)
        if tuple(planes[key].shape) != want:
            raise ValueError(f"{name}: {key} must be (N, K/{per}) = {want} "
                             f"for x {tuple(x.shape)}; got "
                             f"{tuple(planes[key].shape)}")
    if x.dtype not in X_DTYPES or any(planes[key].dtype != dtype
                                      for key, (_, dtype) in layout.items()):
        raise TypeError(f"{name}: dtypes x {x.dtype} (f32|bf16), " + ", ".join(
            f"{key} {planes[key].dtype} ({dtype})"
            for key, (_, dtype) in layout.items()))
    if out_dtype not in X_DTYPES:
        raise TypeError(f"{name}: out_dtype {out_dtype}: f32 or bf16 "
                        "expected")


def splits(m: int, n: int, k: int, sms: int):
    """(k_split, splits): split K across the grid when the output tiles
    alone would leave most SMs idle (each split is a whole number of
    32-wide K steps; the last may hold a ragged tail)."""
    tiles = -(-n // TILE) * -(-m // TILE)
    steps = max(1, -(-k // K_STEP))   # K = 0: one empty step, y = 0
    count = 1 if tiles >= sms else min(steps, -(-2 * sms // tiles))
    per = -(-steps // count)
    return per * K_STEP, -(-steps // per)


@functools.lru_cache(maxsize=None)
def kernel(name: str, n_planes: int, entry: str) -> Callable:
    """The C entry point ``entry`` of library ``csrc/<name>.cu``."""
    fn = getattr(_build.load(name), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * n_planes
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch(wrapper: Callable, name: str, x: torch.Tensor,
           planes: Sequence[torch.Tensor], n: int,
           out_dtype: torch.dtype, *, vector_planes: Sequence[int] = (),
           entry: Optional[str] = None) -> torch.Tensor:
    """Launch ``csrc/<name>.cu`` on CUDA operands and count it on
    ``wrapper.launches``. ``vector_planes``: positions in ``planes`` of
    the planes the kernel reads as 16-byte vectors (they must be 16-byte
    aligned). ``entry``: the C entry point, if not ``name``."""
    if x.device.type != "cuda" or any(p.device != x.device for p in planes):
        raise ValueError(
            f"{wrapper.__name__} needs x and its planes on one CUDA device; "
            f"got {x.device}, {[str(p.device) for p in planes]}")
    if not (x.is_contiguous() and all(p.is_contiguous() for p in planes)):
        raise ValueError(f"{wrapper.__name__} needs contiguous operands")
    for i in vector_planes:
        if planes[i].data_ptr() % 16:
            raise ValueError(f"{wrapper.__name__}: plane {i} must be 16-byte "
                             "aligned (vector loads)")
    m, k = x.shape
    y = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return y
    k_split, count = splits(m, n, k, _sm_count(x.device))
    ws = torch.empty((count, m, n), dtype=torch.float32, device=x.device) \
        if count > 1 else y           # unused without a split
    fn = kernel(name, len(planes), entry or name)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), X_DTYPES[x.dtype],
                 *[p.data_ptr() for p in planes], y.data_ptr(),
                 X_DTYPES[out_dtype], ws.data_ptr(), m, n, k, k_split, count,
                 stream)
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    wrapper.launches += 1
    return y
