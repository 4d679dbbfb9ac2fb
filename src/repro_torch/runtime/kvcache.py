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

With ``prefix_cache=True`` the allocator is refcounted and slots may map
the same full prompt blocks (``PrefixCache``, copy-on-write before any
write lands on a shared page). The split's page copy is one indexed
copy per paged leaf on the device, plain PyTorch (the JAX package's is
an XLA scatter, not a Pallas kernel).

Speculative rollback (``rollback`` on both arenas) erases the KV a
verification step inserted for rejected proposals, so the arena is
bit-identical to never having inserted them; the paged arena also trims
its table tail back to the surviving prefix. It zeroes only the valid
(page, offset) pairs, with one index-put per leaf (plain PyTorch; the
JAX package pads the pairs to a static width with null-page lanes to
keep one compilation, and jits an XLA scatter).
"""
from __future__ import annotations

import hashlib
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
    guarding double-frees. ``remove`` takes a *specific* member out of
    the free list (prefix-cache resurrection of a freed-but-still-cached
    block) by lazy deletion: the heap entry stays behind and is skipped
    at pop when no longer in the set."""

    def __init__(self, n: int):
        self.n = n
        self._heap: List[int] = list(range(n))   # already heap-ordered
        self._free_set = set(self._heap)

    def __len__(self) -> int:
        return len(self._free_set)

    def __contains__(self, i: int) -> bool:
        return i in self._free_set

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

    def remove(self, i: int) -> None:
        if i not in self._free_set:
            raise ValueError(f"not free: {i}")
        self._free_set.discard(i)


class BlockAllocator:
    """Refcounted free-list allocator over ``num_blocks`` physical KV
    blocks of ``block_size`` tokens each, copied from the JAX package.
    All-or-nothing multi-block allocation (an admission either gets its
    whole reservation or stays queued).

    Refcount lifecycle (prefix sharing): ``alloc`` hands out blocks at
    refcount 1; ``share`` takes an extra reference on a block another
    table already maps (or resurrects a refcount-0 block straight out of
    the free list — its page contents are still intact); ``free`` is a
    *decref* — a block returns to the free list only when its last
    reference drops. A refcount-0 block keeps its page contents until
    ``alloc`` reissues it, at which point the ``on_alloc`` hook fires so
    the prefix cache can drop the stale entry."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 1 or block_size < 1:
            raise ValueError(
                f"need num_blocks >= 1 and block_size >= 1, got "
                f"{num_blocks}/{block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free = _FreeHeap(num_blocks)
        self._ever_used: set = set()
        self.reissues = 0               # allocations of a previously-freed block
        self.refcounts: List[int] = [0] * num_blocks
        self.on_alloc = None            # callback(block) on (re)issue

    # -- queries ---------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        """Blocks currently on the free list (refcount 0)."""
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        """Blocks held by at least one reference."""
        return self.num_blocks - len(self._free)

    def blocks_for(self, tokens: int) -> int:
        """Blocks needed to cover ``tokens`` cache positions."""
        return max(1, -(-int(tokens) // self.block_size))

    # -- lifecycle -------------------------------------------------------
    def alloc(self, n: int) -> Optional[List[int]]:
        """Claim ``n`` blocks (lowest ids first) or None if < n are free."""
        if n < 0:
            raise ValueError(f"bad alloc count: {n}")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        self.reissues += sum(1 for b in out if b in self._ever_used)
        self._ever_used.update(out)
        for b in out:
            self.refcounts[b] = 1
            if self.on_alloc is not None:
                self.on_alloc(b)
        return out

    def share(self, blocks: List[int]) -> None:
        """Take one extra reference per block. A live block (refcount
        >= 1) is simply increffed; a refcount-0 block still sitting in
        the free list (freed but cached, contents intact) is resurrected
        — pulled out of the free list with its page untouched."""
        for b in blocks:
            if not (0 <= b < self.num_blocks):
                raise ValueError(f"bad share: {b}")
            if self.refcounts[b] == 0:
                self._free.remove(b)
            self.refcounts[b] += 1

    def free(self, blocks: List[int]) -> None:
        """Drop one reference per block (decref). The block rejoins the
        free list only at refcount 0; its page contents are left intact
        so a prefix-cache entry can resurrect it until reissue."""
        for b in blocks:
            if not (0 <= b < self.num_blocks) or self.refcounts[b] <= 0:
                raise ValueError(f"bad free: {b}")
            self.refcounts[b] -= 1
            if self.refcounts[b] == 0:
                self._free.push(b)


class PrefixCache:
    """Host-side map from hashed token-block *chains* to physical pages,
    copied from the JAX package.

    Key for chain block ``i`` is the running SHA-256 over all prompt
    tokens in blocks ``0..i`` — so a key identifies a full prefix, not a
    bag of tokens, and lookup is a walk from the root that stops at the
    first miss. Only **full** blocks are ever registered: the trailing
    partial block of a live sequence is written by the step's page insert
    and must stay exclusively owned.

    The cache holds no references of its own — an entry over a
    refcount-0 block is a *resurrection candidate*, not pinned memory.
    Eviction is implicit: when the allocator reissues a freed block, the
    ``invalidate_block`` hook drops its entry. Entries are 1:1 with
    blocks, so the cache can never exceed ``num_blocks`` entries."""

    def __init__(self, block_size: int):
        self.block_size = block_size
        self._by_key: Dict[bytes, int] = {}
        self._by_block: Dict[int, bytes] = {}
        self.hits = 0          # block-level lookup hits at admission
        self.misses = 0        # full prompt blocks that missed
        self.evictions = 0     # entries dropped on block reissue

    def __len__(self) -> int:
        return len(self._by_key)

    def keys_for(self, tokens, nfull: int) -> List[bytes]:
        """Chain digests for the first ``nfull`` full blocks of a prompt."""
        h = hashlib.sha256()
        keys: List[bytes] = []
        toks = np.asarray(tokens, np.int64)
        for i in range(nfull):
            h.update(toks[i * self.block_size:(i + 1) * self.block_size]
                     .tobytes())
            keys.append(h.digest())
        return keys

    def lookup(self, keys: List[bytes]) -> List[int]:
        """Longest cached chain prefix: physical blocks for consecutive
        key hits from the root, stopping at the first miss."""
        out: List[int] = []
        for k in keys:
            b = self._by_key.get(k)
            if b is None:
                break
            out.append(b)
        return out

    def is_cached(self, block: int) -> bool:
        """Whether ``block`` currently backs a published cache entry."""
        return block in self._by_block

    def register(self, key: bytes, block: int) -> bool:
        """Publish ``key -> block``; no-op if the key is already mapped
        (first writer wins — siblings sharing that entry already point at
        the published page). Returns True if a new entry was added."""
        if key in self._by_key:
            return False
        stale = self._by_block.pop(block, None)
        if stale is not None:               # block re-published under a new chain
            del self._by_key[stale]
        self._by_key[key] = block
        self._by_block[block] = key
        return True

    def invalidate_block(self, block: int) -> None:
        """Allocator reissued ``block`` — its cached contents are gone."""
        key = self._by_block.pop(block, None)
        if key is not None:
            del self._by_key[key]
            self.evictions += 1


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

    # -- speculative rollback -------------------------------------------
    def rollback(self, slot: int, start: int, count: int,
                 width: int) -> None:
        """Erase cache positions ``[start, start + count)`` of ``slot`` —
        the KV a verification step inserted for *rejected* proposal
        tokens — so the arena is bit-identical to never having inserted
        them (future reads are masked by kv_len anyway; the contract is
        checked differentially). Positions past ``max_seq`` were never
        written. ``width`` is the JAX signature's static window (the
        engine's chunk size); the eager fill needs none."""
        if count <= 0:
            return
        lo, hi = min(start, self.max_seq), min(start + count, self.max_seq)
        for leaf in _leaves(self.buffers):
            leaf[:, slot, lo:hi] = 0


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

    With ``prefix_cache=True`` blocks are refcounted and distinct slots
    MAY alias *full prompt blocks* (copy-on-write prefix sharing):
    ``alloc_slot_prefix`` maps a cached prompt prefix onto existing
    physical pages, ``register_prefix`` publishes a finished prefill's
    full blocks, and ``prepare_write`` splits any shared block before a
    write can land on it — so the step's page insert stays free of
    collisions by invariant: every position a step writes maps to an
    exclusively owned (refcount-1) block. On the card an index-put with
    duplicate targets is nondeterministic, so a missed split would
    corrupt a sibling's page silently.

    With ``kv_quant="int8"`` every paged leaf is ``{"q": int8 code
    pages, "s": fp16 scale pages}`` (quantize-on-insert in the decode
    step, dequantization in the fused kernel); a split copies the scale
    pages with the code pages."""

    def __init__(self, model: ModelAPI, num_slots: int, max_seq: int,
                 block_size: int, num_blocks: Optional[int] = None,
                 dtype=torch.bfloat16, prefix_cache: bool = False,
                 kv_quant: str = "none", device="cuda"):
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
        self.cow_splits = 0             # copy-on-write block splits
        self.prefix_cache: Optional[PrefixCache] = None
        if prefix_cache:
            self.prefix_cache = PrefixCache(block_size)
            self.allocator.on_alloc = self.prefix_cache.invalidate_block

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

    def alloc_slot_prefix(self, prompt_tokens,
                          chunk: int) -> Optional[Tuple[int, int, int]]:
        """Admission with prefix-cache matching: map the longest cached
        full-block chain of ``prompt_tokens`` onto existing physical
        pages (shared, increffed) and allocate fresh blocks only for the
        rest of the first feed. All-or-nothing like ``alloc_slot``.

        Returns ``(slot, hit_tokens, resident_growth_blocks)`` or None.
        ``hit_tokens`` prompt positions already hold valid KV — the
        engine skips feeding them. At least one prompt token is always
        re-fed (its logits seed sampling): when the *whole* prompt is
        cached, the last chain block is split copy-on-write at admission
        — position ``len - 1`` will be rewritten by that feed, and a
        shared page must never be written. ``resident_growth_blocks``
        counts blocks that newly became resident (fresh + resurrected;
        shares of live blocks are free)."""
        pc = self.prefix_cache
        if pc is None:
            raise ValueError("arena built without prefix_cache")
        if self.free_slots == 0:
            return None
        L = len(prompt_tokens)
        nfull = L // self.block_size
        keys = pc.keys_for(prompt_tokens, nfull)
        shared = pc.lookup(keys)
        cow_src: Optional[int] = None
        if shared and len(shared) * self.block_size >= L:
            cow_src = shared[-1]        # fully cached: split the last block
            shared = shared[:-1]
        hit_blocks = len(shared) + (cow_src is not None)
        h = (L - 1) if cow_src is not None else len(shared) * self.block_size
        take = shared + ([cow_src] if cow_src is not None else [])
        used0 = self.allocator.used_blocks
        self.allocator.share(take)      # hold refs while we allocate/copy
        need = self.blocks_needed(h + min(L - h, chunk))
        fresh = self.allocator.alloc(need - hit_blocks
                                     + (cow_src is not None))
        if fresh is None:
            self.allocator.free(take)   # roll the shares back
            return None
        if cow_src is not None:
            dst = fresh[0]
            self._copy_pages([cow_src], [dst])
            self.allocator.free([cow_src])
            self.cow_splits += 1
            blocks = shared + [dst] + fresh[1:]
        else:
            blocks = shared + fresh
        slot = self._free_slots.pop()
        self._slot_blocks[slot] = blocks
        self.tables[slot] = self.null_block
        self.tables[slot, :len(blocks)] = blocks
        self._dev_tables = None
        pc.hits += hit_blocks
        pc.misses += nfull - hit_blocks
        return slot, h, self.allocator.used_blocks - used0

    def register_prefix(self, slot: int, prompt_tokens) -> int:
        """Publish ``slot``'s full prompt blocks into the prefix cache
        (called when prefill completes — positions [0, prompt_len) are
        all written and decode writes land strictly past them). The
        trailing partial block is never registered: it keeps taking
        per-step writes and must stay exclusively owned. Idempotent —
        chains already published (by this sequence's own cache hit, or a
        sibling's earlier prefill) are skipped. Returns new entries."""
        pc = self.prefix_cache
        if pc is None:
            return 0
        nfull = len(prompt_tokens) // self.block_size
        owned = self._slot_blocks[slot]
        added = 0
        for i, key in enumerate(pc.keys_for(prompt_tokens, nfull)):
            if i >= len(owned):
                break
            added += pc.register(key, owned[i])
        return added

    def prepare_write(self, slot: int, start: int,
                      count: int) -> Optional[int]:
        """Copy-on-write barrier: make every block that positions
        ``[start, start + count)`` map to exclusively owned before the
        step writes there. Shared blocks (refcount > 1) are split —
        pages copied to fresh blocks on the device, the table remapped
        (the device table is dropped, so the next step uploads the new
        one), the shared reference dropped. Returns the number of blocks
        split (0 when nothing in range is shared) or None on allocator
        exhaustion (the caller preempts a victim and retries). The JAX
        package pads the copy to a static width to keep one compilation;
        the eager copy here needs no pad."""
        if count <= 0 or self.prefix_cache is None:
            return 0
        bs = self.block_size
        owned = self._slot_blocks[slot]
        b0 = start // bs
        b1 = min((start + count - 1) // bs, len(owned) - 1)
        cow = [(i, owned[i]) for i in range(b0, b1 + 1)
               if self.allocator.refcounts[owned[i]] > 1]
        if not cow:
            return 0
        fresh = self.allocator.alloc(len(cow))
        if fresh is None:
            return None
        self._copy_pages([old for _, old in cow], fresh)
        for j, (i, _) in enumerate(cow):
            owned[i] = fresh[j]
            self.tables[slot, i] = fresh[j]
        self.allocator.free([old for _, old in cow])   # drop shared refs
        self._dev_tables = None
        self.cow_splits += len(cow)
        return len(cow)

    def _copy_pages(self, src: List[int], dst: List[int]) -> None:
        """Copy physical pages ``src[i] -> dst[i]`` in every paged leaf
        (K and V, int8 codes and scales, MLA's latent and RoPE pages):
        one gather and one indexed copy per leaf, on the leaf's device.
        ``dst`` blocks are fresh, so the copy has no duplicate target."""
        s = torch.tensor(src, dtype=torch.long, device=self.device)
        d = torch.tensor(dst, dtype=torch.long, device=self.device)
        for leaf in _leaves(self.buffers):
            leaf.index_copy_(1, d, leaf.index_select(1, s))

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
        """Release ``slot``: decref its blocks (a page shared with a
        sibling stays resident), reset its table row to the null
        sentinel, free the slot."""
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

    # -- speculative rollback -------------------------------------------
    def rollback(self, slot: int, start: int, count: int,
                 width: int) -> int:
        """Erase cache positions ``[start, start + count)`` of ``slot``
        after a verification step rejected them: zero the page contents
        those positions map to through the (pre-trim) block table — every
        paged leaf: K/V, int8 codes and their scale pages, MLA's latent
        and RoPE pages — then trim the table tail: blocks wholly past the
        surviving prefix are decreffed back to the allocator and their
        entries reset to the null block, so resident bytes track the
        *accepted* length. Returns the number of blocks dropped.

        A position whose block is shared (refcount > 1) or published in
        the prefix cache is not zeroed: siblings and future hits read
        that page, and a cached page's contents *are* its chain's KV. The
        tail trim still decrefs such a block. Only the valid (page,
        offset) pairs are zeroed, one index-put per leaf; they are
        distinct, so the put has no duplicate target. ``width`` is the
        JAX signature's static pad width; the eager put needs none."""
        if count <= 0:
            return 0
        bs = self.block_size
        pos = np.arange(start, start + count)
        blk = self.tables[slot, pos // bs]
        pc = self.prefix_cache
        zeroable = np.asarray(
            [b != self.null_block and self.allocator.refcounts[b] == 1
             and (pc is None or not pc.is_cached(b)) for b in blk], bool)
        if zeroable.any():
            put = lambda a: torch.from_numpy(  # noqa: E731
                a[zeroable].astype(np.int64)).to(self.device)
            phys, offs = put(blk), put(pos % bs)
            for leaf in _leaves(self.buffers):
                leaf[:, phys, offs] = 0
        keep = self.blocks_needed(start) if start else 0
        owned = self._slot_blocks[slot]
        if len(owned) <= keep:
            return 0
        tail = owned[keep:]
        self.allocator.free(tail)
        del owned[keep:]
        self.tables[slot, keep:] = self.null_block
        self._dev_tables = None
        return len(tail)
