"""Paged KV cache management for the serving engine, ported from
``repro.runtime.kvcache``.

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

Not ported yet: the contiguous ``KVArena`` (ROADMAP A9), the prefix cache
and copy-on-write with the refcounted allocator (A13), int8 pages (A14)
and speculative rollback (A12).
"""
from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.api import ModelAPI


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


class PagedKVArena:
    """Block-table KV arena: storage is (num_blocks + 1, block_size) pages
    per layer, each slot maps logical blocks to physical blocks through a
    growable table; block ``num_blocks`` is the null block.

    Lifecycle: ``alloc_slot(nblocks)`` admits a sequence (slot + initial
    reservation, all-or-nothing), ``ensure(slot, tokens)`` grows the table
    as the sequence crosses block boundaries (None on allocator
    exhaustion — the engine preempts), ``free_slot`` returns everything
    to the free lists."""

    def __init__(self, model: ModelAPI, num_slots: int, max_seq: int,
                 block_size: int, num_blocks: Optional[int] = None,
                 dtype=torch.bfloat16, device="cuda"):
        if not (1 <= block_size <= max_seq):
            raise ValueError(f"block_size {block_size} outside [1, {max_seq}]")
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
        self.device = torch.device(device)
        shapes = model.paged_cache_shapes(num_slots, num_blocks + 1,
                                          block_size)
        self.buffers = {name: {k: torch.zeros(s, dtype=dtype,
                                              device=self.device)
                               for k, s in leaves.items()}
                        for name, leaves in shapes.items()}
        leaves = [t for g in self.buffers.values() for t in g.values()]
        self._nbytes = sum(t.numel() * t.element_size() for t in leaves)
        # Bytes of one physical block across every layer's K and V.
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
        layer with ``num_pages == num_blocks + 1`` (the trailing page is
        the null sentinel); every table row is padded to ``max_blocks``
        entries with ``null_block``. Null-page contents are garbage and
        always sit past a row's causal depth, so the kernel never reads
        them as live KV. See docs/kernel-contracts.md."""
        return {"block_size": self.block_size,
                "max_blocks": self.max_blocks,
                "num_pages": self.num_blocks + 1,
                "null_block": self.null_block,
                "kv_quant": "none"}

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

    # -- byte accounting --------------------------------------------------
    def nbytes(self) -> int:
        """Total device bytes of the arena's page storage."""
        return self._nbytes

    def block_bytes(self) -> float:
        """Bytes of paged storage backing one physical block."""
        return self._block_bytes

    def resident_bytes(self) -> float:
        """Bytes pinned by live sequences right now (allocated blocks at
        block granularity)."""
        return self.allocator.used_blocks * self.block_bytes()
