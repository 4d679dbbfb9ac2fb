"""Launch plumbing shared by the fused dequant-matmul wrappers
(``fp16_matmul``, ``q8_0_matmul``, ``q6_k_matmul``, ``q3_k_matmul``).

Each of their ``csrc/<fmt>_matmul.cu`` sources exposes one C function
over the tile loop of ``csrc/dequant_matmul.cuh``:

    int <fmt>_matmul(x, x_dtype, <plane pointers...>, y, y_dtype,
                     workspace, M, N, K, tile, k_split, splits, stream)

x's dtype picks the kernel: bf16 (every model layer) the tensor-core
one, f32 the CUDA-core one. This module builds the ctypes signature,
plans the output tiles and the split of K (``plan``; a sharded call
plans from the unsharded shape, so a shard of the rows or columns
splits K exactly as the whole call does; a packed serving step plans
its split from the rows it would carry unpacked, ``plan_rows``), checks
the operands of a CUDA call (and refuses one that requires grad while grad
mode is on: the kernels have no backward), allocates the output and the split-K
workspace, launches, and counts the launch on the wrapper.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build

X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# K steps of a block: the tensor-core kernel's (bf16 x) and the CUDA-core
# kernel's (f32 x). A split is a whole number of them.
K_STEP = {torch.bfloat16: 64, torch.float32: 32}
# Output tiles (BM == BN): the tensor-core kernel's 64 x 64 (one consumer
# warpgroup) up to M = 64 (decode), 128 x 128 (two) above it; the
# CUDA-core kernel's 64 x 64.
SMALL_M = 64
# The tensor-core kernel's splits keep at least this many K steps each
# (a split's partial tile, BM x BN f32, should not outweigh its planes),
# and a tile's splits are one thread-block cluster, at most 8 blocks.
MIN_TC_STEPS = 4
MAX_TC_SPLITS = 8
# The rows every launch inside ``plan_rows`` plans its split of K from.
_PLAN_ROWS: List[int] = []


@contextlib.contextmanager
def plan_rows(rows: Optional[int]):
    """Plan the split of K of every launch inside from ``rows`` rows (the
    shard's row parts times that, under a mesh), not from the call's
    own: a packed serving step's calls carry the R rows its slots feed
    of the ``rows`` = slots x chunk it plans for, and a row's sum then
    never depends on how many rows the step packs. The tile still
    follows the call's own rows. None: no change."""
    if rows is None:
        yield
        return
    _PLAN_ROWS.append(rows)
    try:
        yield
    finally:
        _PLAN_ROWS.pop()


def planned_rows(x2: torch.Tensor, product) -> torch.Tensor:
    """``product(x2)`` of the (M, K) rows ``x2``; off the card, inside
    ``plan_rows(n)`` with M < n, computed at n rows (zero rows appended,
    their outputs dropped). The CPU's BLAS sums a row in an order that
    follows the call's row count, so on the CPU a packed step's row reads
    what the padded step gives it. On the card the hand-written kernels
    fix the order by their plan; a cuBLAS ``product`` (the bf16
    ``linear_apply`` and tied head) runs at the call's M and does not."""
    m = x2.shape[0]
    if x2.is_cuda or not _PLAN_ROWS or _PLAN_ROWS[-1] <= m:
        return product(x2)
    pad = torch.nn.functional.pad(x2, (0, 0, 0, _PLAN_ROWS[-1] - m))
    return product(pad)[:m]


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


def _tile(m: int, x_dtype: torch.dtype) -> int:
    return 128 if x_dtype == torch.bfloat16 and m > SMALL_M else 64


def plan(m: int, n: int, k: int, sms: int, x_dtype: torch.dtype,
         plan_m: Optional[int] = None):
    """(tile, k_split, splits) of one call: output tiles of tile x tile,
    and K cut into ``splits`` ranges of ``k_split`` elements (a whole
    number of the kernel's K steps; the last range may hold a ragged tail
    or, at K = 0, nothing). K is split only when the output tiles alone
    would leave most SMs idle: up to two blocks per SM. ``plan_m``: the
    rows the split is planned from, if not the call's own ``m``."""
    step = K_STEP[x_dtype]
    tile = _tile(m, x_dtype)
    pm = m if plan_m is None else plan_m
    pt = _tile(pm, x_dtype)
    tiles = -(-n // pt) * -(-pm // pt)
    steps = max(1, -(-k // step))     # K = 0: one empty step, y = 0
    most = steps if x_dtype == torch.float32 else \
        min(MAX_TC_SPLITS, max(1, steps // MIN_TC_STEPS))
    count = 1 if tiles >= sms else min(most, -(-2 * sms // tiles))
    per = -(-steps // count)
    return tile, per * step, -(-steps // per)


@functools.lru_cache(maxsize=None)
def kernel(name: str, n_planes: int, entry: str) -> Callable:
    """The C entry point ``entry`` of library ``csrc/<name>.cu``."""
    fn = getattr(_build.load(name), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * n_planes
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch(wrapper: Callable, name: str, x: torch.Tensor,
           planes: Sequence[torch.Tensor], n: int,
           out_dtype: torch.dtype, *, vector_planes: Sequence[int] = (),
           entry: Optional[str] = None,
           plan_parts: Tuple[int, int] = (1, 1)) -> torch.Tensor:
    """Launch ``csrc/<name>.cu`` on CUDA operands and count it on
    ``wrapper.launches``. ``vector_planes``: positions in ``planes`` of
    the planes the kernel reads as 16-byte vectors (they must be 16-byte
    aligned). ``entry``: the C entry point, if not ``name``.
    ``plan_parts``: (row blocks, column blocks) of an unsharded call
    this one is one block of; the tiles and the split of K are planned
    for the unsharded (M, N), so every output element is summed in the
    same order as there (the rows and columns of a tile are
    independent)."""
    if x.device.type != "cuda" or any(p.device != x.device for p in planes):
        raise ValueError(
            f"{wrapper.__name__} needs x and its planes on one CUDA device; "
            f"got {x.device}, {[str(p.device) for p in planes]}")
    if torch.is_grad_enabled() and (x.requires_grad or any(
            p.requires_grad for p in planes)):
        raise RuntimeError(f"{wrapper.__name__} has no backward: an input "
                           "that requires grad would lose its gradient at "
                           "the kernel launch")
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
    tile, k_split, count = plan(
        m * plan_parts[0], n * plan_parts[1], k, _sm_count(x.device),
        x.dtype, _PLAN_ROWS[-1] * plan_parts[0] if _PLAN_ROWS else None)
    # The CUDA-core kernel's split-K partials (the tensor-core kernel sums
    # its splits inside their cluster).
    ws = torch.empty((count, m, n), dtype=torch.float32, device=x.device) \
        if count > 1 and x.dtype == torch.float32 else y
    fn = kernel(name, len(planes), entry or name)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), X_DTYPES[x.dtype],
                 *[p.data_ptr() for p in planes], y.data_ptr(),
                 X_DTYPES[out_dtype], ws.data_ptr(), m, n, k, tile, k_split,
                 count, stream)
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    wrapper.launches += 1
    return y
