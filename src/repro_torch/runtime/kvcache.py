"""KV cache management for the serving engine, ported from
``repro.runtime.kvcache``. Two arenas, one scheduler-facing contract
(alloc/free slots, write prefill, account bytes):

``KVArena`` — the contiguous slot arena: one preallocated cache tree
sized (num_slots, max_seq), each slot hosting one live sequence for its
whole lifetime (the lockstep ``Engine`` and ``block_size=None`` serve on
it).

``PagedKVArena`` — paged/block KV allocation. Cache storage is
(layers, num_blocks + 1, block_size, Hkv, D) page tensors on the device,
managed by a ``BlockAllocator`` free list; each sequence holds a growable
**block table** (logical block -> physical block) instead of a contiguous
stripe. The trailing page (id ``num_blocks``) is the null page:
unassigned table entries point at it, and its contents are never read as
live KV (``page_layout`` and docs/kernel-contracts.md).

The decode step writes the page tensors in place (the JAX engine donates
them to its jitted step instead). Block allocation mid-decode never
changes a tensor shape: the tables ride into the step as a
(num_slots, max_blocks) int32 tensor.

With ``kv_quant="int8"`` every paged leaf stores int8 code pages plus
fp16 scale pages (``page_layout``).

Not ported yet: the prefix cache and copy-on-write with the refcounted
allocator (ROADMAP A13) and speculative rollback (A12).
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.api import ModelAPI
from repro_torch.models.attention import KV_QUANT_SCALE_DTYPE

#: Supported paged-KV storage quantization modes.
KV_QUANT_MODES = ("none", "int8")


def _map(fn, tree):
    """``fn`` over the leaves (shape tuples or tensors) of a nested dict."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree) -> list:
    """Leaves of a nested dict, in key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def allocate(model: ModelAPI, batch: int, max_seq: int,
             dtype=torch.bfloat16, device="cuda") -> Dict:
    """Zero-filled cache tree sized for ``max_seq`` (the arena storage)."""
    return _map(lambda s: torch.zeros(s, dtype=dtype, device=device),
                model.cache_shapes(batch, max_seq))


def step_leaf_dtypes(model: ModelAPI, batch: int, max_seq: int, dtype,
                     const_flags: Tuple[bool, ...]) -> Tuple:
    """Per-leaf arena storage dtypes (leaf order). Seq-indexed KV leaves
    store the requested cache ``dtype``. The JAX package probes the
    decode step for the dtype its constant-size *state* leaves (SSM
    state, enc-dec cross KV) come back in; the port has no such family
    yet (ROADMAP A16), so it refuses them."""
    if any(const_flags):
        raise NotImplementedError("constant-size state leaves (ssm/hybrid/"
                                  "encdec) are ROADMAP A16")
    return tuple(dtype for _ in const_flags)


def cache_nbytes(tree) -> int:
    """Device bytes of a cache tree."""
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


class _FreeHeap:
    """Min-heap free list with O(log n) alloc/free and a membership set
    guarding double-frees."""

    def __init__(self, n: int):
        self.n = n
        self._heap: List[int] = list(range(n))   # already heap-ordered
        self._free_set = set(self._heap)

    def __len__(self) -> int:
        return len(self._free_set)

    def pop(self) -> Optional[int]:
        while self._heap:
            i = heapq.heappop(self._heap)
            if i in self._free_set:
                self._free_set.discard(i)
                return i
        return None

    def push(self, i: int) -> None:
        if i in self._free_set or not (0 <= i < self.n):
            raise ValueError(f"bad free: {i}")
        heapq.heappush(self._heap, i)
        self._free_set.add(i)


class BlockAllocator:
    """Free-list allocator over ``num_blocks`` physical KV blocks of
    ``block_size`` tokens each. All-or-nothing multi-block allocation (an
    admission either gets its whole reservation or stays queued). Blocks
    are exclusively owned: the refcounted sharing of the JAX package
    comes with the prefix cache (ROADMAP A13)."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 1 or block_size < 1:
            raise ValueError(
                f"need num_blocks >= 1 and block_size >= 1, got "
                f"{num_blocks}/{block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free = _FreeHeap(num_blocks)

    @property
    def free_blocks(self) -> int:
        """Blocks currently on the free list."""
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        """Blocks held by a sequence."""
        return self.num_blocks - len(self._free)

    def blocks_for(self, tokens: int) -> int:
        """Blocks needed to cover ``tokens`` cache positions."""
        return max(1, -(-int(tokens) // self.block_size))

    def alloc(self, n: int) -> Optional[List[int]]:
        """Claim ``n`` blocks (lowest ids first) or None if < n are free."""
        if n < 0:
            raise ValueError(f"bad alloc count: {n}")
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, blocks: List[int]) -> None:
        """Return ``blocks`` to the free list."""
        for b in blocks:
            self._free.push(b)


class KVArena:
    """Fixed-size slot arena over the model's cache tree: leaves
    (layers, num_slots, max_seq, Hkv, D). The arena owns the storage and
    the free list; the scheduler decides which request gets a freed slot.
    Every step runs over the full (num_slots, ...) buffers with per-slot
    positions and lengths, so slot turnover never changes a shape."""

    def __init__(self, model: ModelAPI, num_slots: int, max_seq: int,
                 dtype=torch.bfloat16, device="cuda"):
        self.model = model
        self.num_slots = num_slots
        self.max_seq = max_seq
        self.dtype = dtype
        self.device = torch.device(device)
        self._free = _FreeHeap(num_slots)
        # Leaves whose extent does not follow the sequence length carry
        # state, not masked history (the JAX package's probe at two
        # lengths); step_leaf_dtypes refuses them (ROADMAP A16).
        ta = _leaves(model.cache_shapes(num_slots, 160))
        tb = _leaves(model.cache_shapes(num_slots, 224))
        step_leaf_dtypes(model, num_slots, max_seq, dtype,
                         tuple(a == b for a, b in zip(ta, tb)))
        self.buffers = allocate(model, num_slots, max_seq, dtype,
                                self.device)
        self._nbytes = cache_nbytes(self.buffers)

    # -- slot lifecycle -------------------------------------------------
    @property
    def free_slots(self) -> int:
        """Slots available for admission."""
        return len(self._free)

    @property
    def used_slots(self) -> int:
        """Slots hosting a live sequence."""
        return self.num_slots - len(self._free)

    def alloc(self) -> Optional[int]:
        """Claim a free slot (lowest index first) or None when full."""
        return self._free.pop()

    def free(self, slot: int) -> None:
        """Return ``slot`` to the free list (its storage is left stale —
        masked by kv_len and rewritten before reuse)."""
        self._free.push(slot)

    # -- storage --------------------------------------------------------
    def write_prefill(self, prefill_cache: Dict, slot: int) -> None:
        """Insert a B=1 prefill cache (leaves (layers, 1, P, ...), P <=
        max_seq) into ``slot``, in place."""
        _arena_insert(self.buffers, prefill_cache, slot)

    def reset_slot(self, slot: int) -> None:
        """The admission hook that zeroes a slot's constant-size state
        leaves. Seq-indexed KV leaves are left alone (stale history is
        masked by kv_len and rewritten before use), and state leaves are
        refused at construction, so there is nothing to zero."""

    def nbytes(self) -> int:
        """Total device bytes of the arena's cache storage."""
        return self._nbytes

    def slot_bytes(self) -> float:
        """Bytes of arena backing one slot."""
        return self.nbytes() / self.num_slots

    def token_bytes(self) -> float:
        """Cache bytes appended per generated token."""
        return self.slot_bytes() / self.max_seq

    def resident_bytes(self) -> float:
        """Arena bytes reserved by live sequences: a slot pins a full
        max_seq stripe from admission to completion."""
        return self.used_slots * self.slot_bytes()


def _arena_insert(arena: Dict, prefill_cache: Dict, slot: int) -> None:
    """Write a B=1 prefill cache into arena slot ``slot`` in place: leaves
    are (L, B, S, ...), the prefill's (L, 1, P, ...) lands at (0, slot,
    0, ...)."""
    for name, leaves in arena.items():
        for k, a in leaves.items():
            c = prefill_cache[name][k]
            a[:, slot:slot + 1, :c.shape[2]].copy_(c)


class PagedKVArena:
    """Block-table KV arena: storage is (num_blocks + 1, block_size) pages
    per layer, each slot maps logical blocks to physical blocks through a
    growable table; block ``num_blocks`` is the null block.

    Lifecycle: ``alloc_slot(nblocks)`` admits a sequence (slot + initial
    reservation, all-or-nothing), ``ensure(slot, tokens)`` grows the table
    as the sequence crosses block boundaries (None on allocator
    exhaustion — the engine preempts), ``free_slot`` returns everything
    to the free lists.

    With ``kv_quant="int8"`` every paged leaf is ``{"q": int8 code
    pages, "s": fp16 scale pages}`` (quantize-on-insert in the decode
    step, dequantization in the fused kernel)."""

    def __init__(self, model: ModelAPI, num_slots: int, max_seq: int,
                 block_size: int, num_blocks: Optional[int] = None,
                 dtype=torch.bfloat16, kv_quant: str = "none",
                 device="cuda"):
        if not (1 <= block_size <= max_seq):
            raise ValueError(f"block_size {block_size} outside [1, {max_seq}]")
        if kv_quant not in KV_QUANT_MODES:
            raise ValueError(f"unknown kv_quant {kv_quant!r} "
                             f"(choose from {KV_QUANT_MODES})")
        self.model = model
        self.num_slots = num_slots
        self.max_seq = max_seq
        self.block_size = block_size
        self.max_blocks = -(-max_seq // block_size)   # table width per slot
        if num_blocks is None:
            num_blocks = num_slots * self.max_blocks  # capacity parity
        self.num_blocks = num_blocks
        self.null_block = num_blocks                  # last physical page
        self.dtype = dtype
        self.kv_quant = kv_quant
        self.device = torch.device(device)
        shapes = model.paged_cache_shapes(num_slots, num_blocks + 1,
                                          block_size, kv_quant=kv_quant)
        self.buffers = {}
        for name, group in shapes.items():
            self.buffers[name] = {}
            for k, s in group.items():
                self.buffers[name][k] = {
                    "q": torch.zeros(s["q"], dtype=torch.int8,
                                     device=self.device),
                    "s": torch.zeros(s["s"], dtype=KV_QUANT_SCALE_DTYPE,
                                     device=self.device),
                } if kv_quant == "int8" else torch.zeros(
                    s, dtype=dtype, device=self.device)
        leaves = _leaves(self.buffers)
        self._nbytes = cache_nbytes(self.buffers)
        # Bytes of one physical block across every layer's K and V (codes
        # and scales alike on an int8 arena).
        self._block_bytes = float(sum(
            t.numel() // t.shape[1] * t.element_size() for t in leaves))
        self.allocator = BlockAllocator(num_blocks, block_size)
        self._free_slots = _FreeHeap(num_slots)
        self.tables = np.full((num_slots, self.max_blocks), self.null_block,
                              np.int32)
        self._slot_blocks: List[List[int]] = [[] for _ in range(num_slots)]
        self._dev_tables: Optional[torch.Tensor] = None   # upload cache

    # -- queries ---------------------------------------------------------
    def page_layout(self) -> dict:
        """The page/table layout contract the fused paged-attention kernel
        consumes: paged leaves are ``(num_pages, block_size, Hkv, D)`` per
        layer (MLA's latents ``(num_pages, block_size, kv_lora_rank)``
        and ``(num_pages, block_size, qk_rope_head_dim)``, lifted to
        Hkv = 1 for the kernel) with ``num_pages == num_blocks + 1`` (the
        trailing page is the null sentinel); every table row is padded to
        ``max_blocks`` entries with ``null_block``. Null-page contents are
        garbage and always sit past a row's causal depth, so the kernel
        never reads them as live KV. ``kv_quant == "int8"``: each paged
        leaf is a dict ``{"q", "s"}`` — int8 code pages in the page shape
        plus fp16 scale pages shaped like the pages minus the feature axis
        — sharing the block table; zeroed pages dequantize to exactly
        zero. See docs/kernel-contracts.md."""
        return {"block_size": self.block_size,
                "max_blocks": self.max_blocks,
                "num_pages": self.num_blocks + 1,
                "null_block": self.null_block,
                "kv_quant": self.kv_quant}

    @property
    def free_slots(self) -> int:
        """Slots available for admission."""
        return len(self._free_slots)

    def blocks_needed(self, tokens: int) -> int:
        """Blocks covering ``tokens`` cache positions."""
        return self.allocator.blocks_for(tokens)

    def slot_blocks(self, slot: int) -> List[int]:
        """Copy of ``slot``'s physical block list (logical order)."""
        return list(self._slot_blocks[slot])

    def device_tables(self) -> Tuple[torch.Tensor, int]:
        """(device table tensor, bytes uploaded now). Tables change only at
        admission / block-boundary crossings / preemption, so the device
        copy is cached and re-uploaded only when dirty — steady-state
        decode steps move zero table bytes."""
        fresh = 0
        if self._dev_tables is None:
            self._dev_tables = torch.from_numpy(self.tables.copy()).to(
                self.device)
            fresh = self.tables.nbytes
        return self._dev_tables, fresh

    # -- slot/block lifecycle --------------------------------------------
    def alloc_slot(self, nblocks: int) -> Optional[int]:
        """Admit: claim a slot AND its initial ``nblocks`` reservation,
        all-or-nothing. Returns the slot or None."""
        if self.free_slots == 0:
            return None
        blocks = self.allocator.alloc(nblocks)
        if blocks is None:
            return None
        slot = self._free_slots.pop()
        self._slot_blocks[slot] = blocks
        self.tables[slot, :len(blocks)] = blocks
        self._dev_tables = None
        return slot

    def ensure(self, slot: int, tokens: int) -> Optional[int]:
        """Grow ``slot``'s table to cover ``tokens`` positions. Returns
        the number of newly allocated blocks, or None on exhaustion (the
        caller preempts a victim and retries)."""
        need = self.blocks_needed(tokens)
        have = len(self._slot_blocks[slot])
        if need <= have:
            return 0
        fresh = self.allocator.alloc(need - have)
        if fresh is None:
            return None
        self.tables[slot, have:need] = fresh
        self._slot_blocks[slot].extend(fresh)
        self._dev_tables = None
        return len(fresh)

    def free_slot(self, slot: int) -> None:
        """Release ``slot``: its blocks back to the allocator, its table
        row reset to the null sentinel, the slot freed."""
        self.allocator.free(self._slot_blocks[slot])
        self._slot_blocks[slot] = []
        self.tables[slot] = self.null_block
        self._dev_tables = None
        self._free_slots.push(slot)

    def free(self, slot: int) -> None:
        """Alias for ``free_slot`` (the scheduler's retire name)."""
        self.free_slot(slot)

    def reset_slot(self, slot: int) -> None:
        """``KVArena``'s admission hook: every leaf of a dense or moe
        model is paged (masked history, not state), so there is nothing
        to zero."""

    # -- storage ---------------------------------------------------------
    def write_prefill(self, prefill_cache: Dict, slot: int) -> None:
        """The JAX package scatters a prefill cache into a slot's blocks
        only for the enc-dec admission pass (ROADMAP A16). An int8 arena
        refuses it for good: quantized serving feeds prompts through the
        chunked step (quantize-on-insert)."""
        if self.kv_quant != "none":
            raise NotImplementedError(
                "write_prefill cannot scatter an unquantized prefill "
                "cache into int8 pages; quantized serving feeds prompts "
                "through the chunked step (quantize-on-insert)")
        raise NotImplementedError("the paged write_prefill serves the "
                                  "enc-dec admission, ROADMAP A16")

    # -- byte accounting --------------------------------------------------
    def nbytes(self) -> int:
        """Total device bytes of the arena's page storage."""
        return self._nbytes

    def block_bytes(self) -> float:
        """Bytes of paged storage backing one physical block."""
        return self._block_bytes

    def token_bytes(self) -> float:
        """Cache bytes appended per generated token."""
        return self.block_bytes() / self.block_size

    def resident_bytes(self) -> float:
        """Bytes pinned by live sequences right now (allocated blocks at
        block granularity)."""
        return self.allocator.used_blocks * self.block_bytes()
