"""Paged KV cache: host-side block allocator + device-resident paged state.

The port of the reference's ``serve/paged.py`` (the host-RAM tier arrives
with a later slice): the allocator, the block tables, the prefix cache's
chain keys (:func:`prefix_keys`) and the device-resident state.  The slotted cache reserves ``max_slots x max_len``
KV positions up front; the paged layout replaces the per-lane tensor with
a shared pool of fixed-size blocks:

    cache {k,v}  (L, num_blocks, block_size, Hk, dh)
    tables       (max_slots, max_len // block_size) int32

A lane owns a block-table row: entry ``j`` is the physical block holding
logical positions ``[j*bs, (j+1)*bs)``.  Blocks are allocated on demand
(at admission for the prompt, then one at a time as decode crosses block
boundaries) and returned to the free list on eviction.

Physical block **0 is the null block**: a write sink that is never
allocated and never read.  Unmapped table entries point at it, so garbage
writes from padded prefill tails and freed lanes land there instead of
in live blocks.

:class:`BlockAllocator` and :class:`SlotTables` are host-side numpy logic,
copied from the reference.  The device sees only the ``tables`` tensor,
copied into in place whenever a row changes.
"""
from __future__ import annotations

import bisect
import hashlib
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import registry

NULL_BLOCK = 0


def blocks_for(positions: int, block_size: int) -> int:
    """Blocks needed to hold ``positions`` KV positions."""
    if positions <= 0:
        return 0
    return -(-positions // block_size)


def prefix_keys(tokens, block_size: int) -> list[bytes]:
    """Chain keys for every full block-aligned prefix of ``tokens``.

    Key ``j`` digests tokens ``[0, (j+1)*block_size)`` (int32 bytes)
    through a rolling sha256, byte for byte the reference's keys: two
    chains share a key iff their token prefixes are identical, and key
    ``j`` commits to the whole history, since block ``j``'s KV depends on
    every earlier position through attention.
    """
    t = np.ascontiguousarray(np.asarray(tokens, np.int32))
    h = hashlib.sha256()
    out: list[bytes] = []
    for j in range(t.size // block_size):
        h.update(t[j * block_size:(j + 1) * block_size].tobytes())
        out.append(h.digest())
    return out


class BlockAllocator:
    """Fixed pool of KV blocks: free list + per-block refcounts + a
    prefix-hash index of published (fully written, content-addressed)
    blocks.

    Block 0 is reserved as the null/write-sink block and is never handed
    out.  ``alloc`` pops the lowest free id (deterministic across runs so
    block layouts — and therefore the bytes the bench reports — are
    reproducible), falling back to evicting the LRU *cached* block when
    the free list is empty; ``free`` drops one reference, parking
    published blocks in the cached set and returning unpublished ones to
    the free list at refcount 0; ``share`` takes a reference on a live or
    cached block (a prefix-cache hit).  ``peak_in_use`` tracks the
    live-block high-water mark for the bench's ``kv_used_bytes``.

    Invariants (swept by :meth:`check` after every fuzzer step): each of
    the ``capacity`` allocatable blocks is in exactly one of the three
    states, so ``free + live + cached == capacity``; live refcounts are
    ``>= 1``; every cached block is indexed and every index entry points
    at a live-or-cached block (a lookup can never return a freed block);
    the free list stays sorted (allocation order is deterministic).
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block 0 is the null block), "
                f"got {num_blocks}"
            )
        if block_size < 1:
            raise ValueError(f"block_size must be positive, got {block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # sorted free list, popped from the front: lowest ids first
        self._free = list(range(1, num_blocks))
        self._ref: dict[int, int] = {}          # live blocks -> refcount >= 1
        self._cached: OrderedDict[int, None] = OrderedDict()  # LRU, ref == 0
        self._index: dict[bytes, int] = {}      # chain key -> block
        self._block_key: dict[int, bytes] = {}  # published block -> its key
        self.peak_in_use = 0
        self.hits = 0          # lookup chains that matched at least a block
        self.misses = 0
        self.cache_evictions = 0

    @property
    def capacity(self) -> int:
        """Allocatable blocks (excludes the null block)."""
        return self.num_blocks - 1

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_cached(self) -> int:
        """Published blocks with refcount 0 (revivable, reclaimable)."""
        return len(self._cached)

    @property
    def available(self) -> int:
        """Blocks an ``alloc`` can hand out: free + reclaimable cached."""
        return len(self._free) + len(self._cached)

    @property
    def in_use(self) -> int:
        """Live blocks (refcount >= 1)."""
        return len(self._ref)

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def _forget(self, block: int) -> None:
        """Drop a block's index entry (cache eviction / reclamation)."""
        key = self._block_key.pop(block, None)
        if key is not None and self._index.get(key) == block:
            del self._index[key]

    def alloc(self) -> int:
        if self._free:
            b = self._free.pop(0)
        elif self._cached:
            b, _ = self._cached.popitem(last=False)   # evict LRU cached
            self._forget(b)
            self.cache_evictions += 1
        else:
            raise RuntimeError("KV block pool exhausted")
        self._ref[b] = 1
        self.peak_in_use = max(self.peak_in_use, len(self._ref))
        return b

    def share(self, block: int) -> int:
        """Take one more reference on a live or cached block (prefix hit).
        Returns the block for chaining."""
        if block in self._ref:
            self._ref[block] += 1
        elif block in self._cached:
            del self._cached[block]                   # revive
            self._ref[block] = 1
            self.peak_in_use = max(self.peak_in_use, len(self._ref))
        else:
            raise ValueError(f"block {block} is not allocated or cached")
        return block

    def free(self, block: int) -> None:
        if block == NULL_BLOCK:
            raise ValueError("cannot free the null block")
        if block not in self._ref:
            raise ValueError(f"block {block} is not allocated")
        self._ref[block] -= 1
        if self._ref[block]:
            return
        del self._ref[block]
        if block in self._block_key:
            self._cached[block] = None                # park, MRU end
        else:
            # keep the free list sorted so allocation order is deterministic
            bisect.insort(self._free, block)

    # -- prefix index ---------------------------------------------------
    def publish(self, block: int, key: bytes) -> bool:
        """Index a fully written live block under its chain ``key``.
        Idempotent: if the key is already indexed (another lane produced
        the same chain first), the existing entry wins and this block
        stays unpublished.  Returns True if the block was indexed."""
        if block not in self._ref:
            raise ValueError(f"cannot publish non-live block {block}")
        if key in self._index or block in self._block_key:
            return False
        self._index[key] = block
        self._block_key[block] = key
        return True

    def indexed(self, key: bytes) -> bool:
        """Whether a chain key is indexed (no hit/miss counting)."""
        return key in self._index

    def lookup(self, keys: list[bytes]) -> list[int]:
        """Longest indexed chain prefix of ``keys`` (no refs taken —
        callers ``share`` the blocks they actually map)."""
        out: list[int] = []
        for k in keys:
            b = self._index.get(k)
            if b is None:
                break
            out.append(b)
        if out:
            self.hits += 1
        elif keys:
            self.misses += 1
        return out

    def check(self) -> None:
        """Invariant sweep (property tests + the cross-engine fuzzer):
        free/live/cached partition the pool, refcounts are positive,
        every cached block is indexed, and every index entry points at a
        live-or-cached block."""
        free, live, cached = set(self._free), set(self._ref), set(self._cached)
        assert len(free) + len(live) + len(cached) == self.capacity, \
            "free + live + cached != pool"
        assert not (free & live) and not (free & cached) and not (live & cached)
        assert NULL_BLOCK not in free | live | cached
        assert self._free == sorted(self._free)
        assert all(r >= 1 for r in self._ref.values())
        for b in cached:
            assert b in self._block_key, f"cached block {b} has no key"
        for b, key in self._block_key.items():
            assert self._index.get(key) == b
            assert b in live or b in cached, f"indexed block {b} was freed"
        assert len(self._block_key) == len(self._index)


class SlotTables:
    """Per-slot block tables mirrored on host.

    Invariant (the *compaction* invariant): every row is a contiguous
    prefix of live block ids followed by ``NULL_BLOCK`` padding — blocks
    are appended in logical order and only released all at once, so a
    lane's mapped region is always ``[0, mapped(slot) * block_size)``.
    """

    def __init__(self, max_slots: int, blocks_per_slot: int):
        self.table = np.zeros((max_slots, blocks_per_slot), np.int32)
        self._blocks: list[list[int]] = [[] for _ in range(max_slots)]

    @property
    def blocks_per_slot(self) -> int:
        return self.table.shape[1]

    def mapped(self, slot: int) -> int:
        """Number of blocks mapped for ``slot``."""
        return len(self._blocks[slot])

    def blocks(self, slot: int) -> tuple[int, ...]:
        return tuple(self._blocks[slot])

    def append(self, slot: int, block: int) -> None:
        """Map ``block`` as the next logical block of ``slot``."""
        if block == NULL_BLOCK:
            raise ValueError("cannot map the null block")
        row = self._blocks[slot]
        if len(row) >= self.blocks_per_slot:
            raise ValueError(f"slot {slot} table is full")
        self.table[slot, len(row)] = block
        row.append(block)

    def release(self, slot: int) -> list[int]:
        """Unmap every block of ``slot``; returns them (caller frees)."""
        out, self._blocks[slot] = self._blocks[slot], []
        self.table[slot, :] = NULL_BLOCK
        return out

    def check(self, *, refcount=None) -> None:
        """Compaction + uniqueness invariants (property tests).

        Default: no block may be mapped by two slots.  With ``refcount``
        (a callable, e.g. ``BlockAllocator.refcount``), prefix-cache
        sharing is legal and the check instead demands every block's
        refcount covers its mapping multiplicity (and is live at all).
        """
        counts: dict[int, int] = {}
        for slot, row in enumerate(self._blocks):
            n = len(row)
            assert list(self.table[slot, :n]) == row
            assert not self.table[slot, n:].any(), "non-contiguous table row"
            assert NULL_BLOCK not in row
            if refcount is None:
                dup = set(counts) & set(row)
                assert not dup, f"blocks {dup} mapped in two slots"
            for b in row:
                counts[b] = counts.get(b, 0) + 1
        if refcount is not None:
            for b, n in counts.items():
                assert refcount(b) >= n, (
                    f"block {b} mapped {n}x but refcount {refcount(b)}")


# ---------------------------------------------------------------------------
# Device-resident paged state
# ---------------------------------------------------------------------------


def make_paged_state(cfg: ArchConfig, max_slots: int, max_len: int,
                     num_blocks: int, block_size: int, device,
                     seed: int = 0) -> dict:
    """Allocate the device-resident paged state (all tables null)."""
    from .cache import sched_state

    if max_len % block_size:
        raise ValueError(
            f"max_len ({max_len}) must be a multiple of block_size "
            f"({block_size})"
        )
    specs = registry.get_module(cfg).make_paged_cache_specs(
        cfg, num_blocks, block_size)
    cache = {k: torch.zeros_like(s, device=device) for k, s in specs.items()}
    tables = torch.zeros((max_slots, max_len // block_size), dtype=torch.int32,
                         device=device)
    return {"cache": cache, "tables": tables,
            **sched_state(max_slots, device, seed)}


def cache_nbytes(cache_tree: dict) -> int:
    """Total bytes of the KV cache leaves (tensors or meta tensors)."""
    return sum(leaf.numel() * leaf.element_size() for leaf in cache_tree.values())
