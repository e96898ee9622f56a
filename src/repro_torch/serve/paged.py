"""Paged KV cache: host-side block allocator + device-resident paged state.

The port of the reference's ``serve/paged.py``: the allocator, the block
tables, the prefix cache's chain keys (:func:`prefix_keys`), the host-RAM
tier (:class:`LaneSpill`, :class:`HostTier`, :func:`check_tiered`) and the
device-resident state.  The slotted cache reserves ``max_slots x max_len``
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
        # optional hook fired as ``on_evict(block, key)`` when an LRU cached
        # block is reclaimed for reuse: before its index entry drops and
        # before the new owner writes, so the host tier can still read the
        # block's KV (the second-level prefix cache: reclaimed chains spill
        # instead of dying)
        self.on_evict = None

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
            if self.on_evict is not None:
                self.on_evict(b, self._block_key.get(b))
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

    def block_of(self, key: bytes) -> int | None:
        """The block indexed under ``key``, or None (no hit/miss counting)."""
        return self._index.get(key)

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
# Host-RAM tier
# ---------------------------------------------------------------------------


class Share(dict):
    """One rank's share of a tier payload on a serving mesh.

    ``{leaf: host tensor}`` of the part of a block (paged) or a lane
    (slotted) this rank holds, empty where another data rank holds it;
    ``src`` the global block or lane it was read from, whose holder every
    rank can name; ``nbytes`` the bytes of the whole block or lane, as one
    device reading it whole would fetch them.  The tier counts ``nbytes``,
    so every rank's tier takes the same admit, LRU and drop decisions and
    reports the reference's bytes while it holds only its share."""

    __slots__ = ("src", "nbytes")

    def __init__(self, leaves: dict, src: int, nbytes: int):
        super().__init__(leaves)
        self.src, self.nbytes = int(src), int(nbytes)


def payload_nbytes(tree: dict) -> int:
    """Bytes of a payload: a :class:`Share`'s whole bytes, else the sum of
    its leaves' (host tensors or numpy arrays: both have ``nbytes``, the
    view's own size for a view)."""
    if isinstance(tree, Share):
        return tree.nbytes
    return sum(int(a.nbytes) for a in tree.values())



class LaneSpill:
    """One preempted or parked lane's decode state, resident in host RAM.

    ``kind`` selects the payload:

    * ``"paged"``: ``blocks`` is one ``{leaf: tensor}`` per mapped block,
      in logical order (the lane's KV, block by block);
    * ``"lane"``: ``leaves`` is one ``{leaf: tensor}`` lane slice (the
      slotted KV segment and/or recurrent leaves, per
      ``registry.lane_leaf_axes``).

    On a serving mesh each payload is a :class:`Share`: this rank's part,
    and the whole payload's bytes, which ``nbytes`` sums.

    ``prefilled``/``generated`` pin the schedule position the payload
    holds: a restore writes it back and resumes decode at
    ``prompt[plen + generated - 1]``, the input the lane would have fed
    next, so the continuation is bitwise the never-evicted one.
    """

    __slots__ = ("rid", "kind", "prefilled", "generated", "blocks", "leaves", "nbytes")

    def __init__(self, rid: int, kind: str, prefilled: int, generated: int,
                 blocks: list | None = None, leaves: dict | None = None):
        self.rid = rid
        self.kind = kind
        self.prefilled = prefilled
        self.generated = generated
        self.blocks = blocks or []
        self.leaves = leaves
        self.nbytes = sum(payload_nbytes(t) for t in self.blocks
                          + ([] if leaves is None else [leaves]))


class HostTier:
    """Second-level store for KV and decode state in host RAM.

    Two payload families share one bounded pool:

    * **lane spills** (:class:`LaneSpill`, keyed by request id): a
      preempted or parked lane's whole decode state, restored O(copy) at
      resume instead of replaying its generated tokens;
    * **prefix blocks** (keyed by :class:`BlockAllocator`'s chain keys):
      LRU-reclaimed prefix-cache blocks spill here instead of dying, so
      the tier is a second-level prefix cache that admission consults.

    Capacity is counted in **block units** (``capacity_blocks``; None =
    unbounded): each paged payload block is one unit, and prefix blocks
    are the only evictable residents (a lane spill pins its units until
    it is restored or dropped: it backs an in-flight request).  Whole-lane
    spills (``kind == "lane"``) are outside the block budget; the lane
    count bounds them.

    One tier may be shared by several engines: request ids are unique
    across them and payloads are plain host tensors, so one engine's
    spill restores on another.  On a serving mesh each rank keeps a tier
    of its own, holding its :class:`Share` of every payload (an empty one
    for what another data rank holds) and counting whole payloads, so the
    ranks' tiers stay alike entry for entry.

    Conservation: attached to an allocator, the device's three block
    states gain a fourth, *spilled*; :func:`check_tiered` sweeps
    ``free + live + cached + spilled == capacity`` across both pools.
    """

    def __init__(self, capacity_blocks: int | None = None):
        if capacity_blocks is not None and capacity_blocks < 0:
            raise ValueError(f"capacity_blocks must be >= 0, got {capacity_blocks}")
        self.capacity_blocks = capacity_blocks
        self._lanes: dict[int, LaneSpill] = {}
        self._prefix: OrderedDict[bytes, dict] = OrderedDict()  # LRU
        self._bytes = 0
        # monotone counters (the engine folds them into its stats)
        self.lane_spills = 0
        self.lane_restores = 0
        self.prefix_spills = 0
        self.prefix_hits = 0
        self.drops = 0          # payloads refused, or LRU-dropped for room
        self.spilled_bytes = 0
        self.restored_bytes = 0

    # -- accounting -----------------------------------------------------
    @property
    def spilled_blocks(self) -> int:
        """Block units resident (prefix blocks + paged lane blocks)."""
        return len(self._prefix) + sum(len(sp.blocks) for sp in self._lanes.values())

    @property
    def spilled_lanes(self) -> int:
        return len(self._lanes)

    @property
    def host_free(self) -> int | None:
        """Remaining block units (None when unbounded)."""
        if self.capacity_blocks is None:
            return None
        return self.capacity_blocks - self.spilled_blocks

    @property
    def used_bytes(self) -> int:
        return self._bytes

    def _make_room(self, units: int) -> bool:
        """Free ``units`` block units by LRU-dropping prefix blocks; lane
        spills are never evicted (they back in-flight requests)."""
        if self.capacity_blocks is None:
            return True
        while self.capacity_blocks - self.spilled_blocks < units and self._prefix:
            _, payload = self._prefix.popitem(last=False)
            self._bytes -= payload_nbytes(payload)
            self.drops += 1
        return self.capacity_blocks - self.spilled_blocks >= units

    # -- lane spills ----------------------------------------------------
    def put_lane(self, sp: LaneSpill) -> bool:
        """Admit a lane spill (replacing an older one of the same rid);
        False if the tier cannot make room (the resume then replays)."""
        old = self._lanes.pop(sp.rid, None)
        if old is not None:
            self._bytes -= old.nbytes
        if not self._make_room(len(sp.blocks)):
            self.drops += 1
            return False
        self._lanes[sp.rid] = sp
        self._bytes += sp.nbytes
        self.lane_spills += 1
        self.spilled_bytes += sp.nbytes
        return True

    def has_lane(self, rid: int) -> bool:
        return rid in self._lanes

    def peek_lane(self, rid: int) -> LaneSpill | None:
        return self._lanes.get(rid)

    def pop_lane(self, rid: int) -> LaneSpill | None:
        """Remove and return a lane spill (a restore's commit)."""
        sp = self._lanes.pop(rid, None)
        if sp is not None:
            self._bytes -= sp.nbytes
            self.lane_restores += 1
            self.restored_bytes += sp.nbytes
        return sp

    def drop_lane(self, rid: int) -> None:
        """Discard a lane spill without restoring it (a terminal request,
        or a faulted lane whose state is suspect)."""
        sp = self._lanes.pop(rid, None)
        if sp is not None:
            self._bytes -= sp.nbytes

    # -- prefix blocks --------------------------------------------------
    def put_block(self, key: bytes, payload: dict) -> bool:
        """Admit one reclaimed prefix block under its chain ``key``."""
        if key in self._prefix:
            self._prefix.move_to_end(key)             # already resident
            return True
        if not self._make_room(1):
            self.drops += 1
            return False
        nb = payload_nbytes(payload)
        self._prefix[key] = payload
        self._bytes += nb
        self.prefix_spills += 1
        self.spilled_bytes += nb
        return True

    def has_block(self, key: bytes) -> bool:
        return key in self._prefix

    def match_chain(self, keys: list[bytes], start: int = 0) -> int:
        """How many consecutive chain keys of ``keys[start:]`` are resident
        here: the tier's extension of a device chain match."""
        n = 0
        for k in keys[start:]:
            if k not in self._prefix:
                break
            n += 1
        return n

    def pop_block(self, key: bytes) -> dict | None:
        """Remove and return a prefix block (restored to the device and
        published there: move semantics keep one owner per chain key)."""
        payload = self._prefix.pop(key, None)
        if payload is not None:
            nb = payload_nbytes(payload)
            self._bytes -= nb
            self.prefix_hits += 1
            self.restored_bytes += nb
        return payload

    def discard_block(self, key: bytes) -> None:
        """Drop a host copy without restoring it: the same chain key was
        published on the device again, and each key has one owner."""
        payload = self._prefix.pop(key, None)
        if payload is not None:
            self._bytes -= payload_nbytes(payload)

    def check(self) -> None:
        """Invariant sweep: the byte tally matches the payloads, and a
        bounded tier stays inside its block budget."""
        nb = sum(sp.nbytes for sp in self._lanes.values()) + sum(
            payload_nbytes(p) for p in self._prefix.values())
        assert nb == self._bytes, f"tier byte tally {self._bytes} != {nb}"
        for rid, sp in self._lanes.items():
            assert sp.rid == rid and sp.kind in ("paged", "lane")
            assert (sp.kind == "paged") == (sp.leaves is None)
        if self.capacity_blocks is not None:
            assert self.spilled_blocks <= self.capacity_blocks, (
                f"tier over budget: {self.spilled_blocks} block units > "
                f"{self.capacity_blocks}")


def check_tiered(alloc: BlockAllocator, tier: HostTier | None) -> None:
    """Four-state conservation across the device pool and the host tier.

    Each pool keeps its own partition (``free + live + cached ==
    capacity`` on the device, ``spilled + host_free == capacity_blocks``
    on a bounded tier), and every chain key has one owner: indexed on the
    device **xor** resident in the tier (a spill moves it out, a promotion
    moves it back, a republish discards the host copy).  Together:
    ``free + live + cached + spilled == capacity`` over both pools with
    no block counted twice.
    """
    alloc.check()
    if tier is None:
        return
    tier.check()
    both = set(alloc._index) & set(tier._prefix)
    assert not both, f"{len(both)} chain keys owned by device index AND host tier"
    if tier.capacity_blocks is None:
        return
    total = alloc.num_free + alloc.in_use + alloc.num_cached \
        + tier.spilled_blocks + tier.host_free
    assert total == alloc.capacity + tier.capacity_blocks, (
        f"tiered conservation broken: free {alloc.num_free} + live "
        f"{alloc.in_use} + cached {alloc.num_cached} + spilled "
        f"{tier.spilled_blocks} + host_free {tier.host_free} != "
        f"{alloc.capacity + tier.capacity_blocks}")


# ---------------------------------------------------------------------------
# Device-resident paged state
# ---------------------------------------------------------------------------


def paged_state_specs(cfg: ArchConfig, max_len: int, num_blocks: int, block_size: int,
                      mesh=None) -> dict:
    """The paged pool's leaves as meta tensors: on a ``mesh`` this rank's
    part, as the reference's ``paged_state_specs`` places them
    (``lm.paged_cache_pspec``: the blocks over the data axes, kv heads over
    ``model`` where they divide).  The tables and scheduling vectors are
    replicated."""
    if max_len % block_size:
        raise ValueError(
            f"max_len ({max_len}) must be a multiple of block_size "
            f"({block_size})"
        )
    mod = registry.get_module(cfg)
    if mesh is None:
        return mod.make_paged_cache_specs(cfg, num_blocks, block_size)
    return mod.make_paged_cache_specs(cfg, num_blocks, block_size, mesh=mesh)


def make_paged_state(cfg: ArchConfig, max_slots: int, max_len: int,
                     num_blocks: int, block_size: int, device,
                     seed: int = 0, mesh=None) -> dict:
    """Allocate the device-resident paged state (all tables null); on a
    ``mesh``, this rank's part of the pool (:func:`paged_state_specs`)."""
    from .cache import sched_state

    specs = paged_state_specs(cfg, max_len, num_blocks, block_size, mesh)
    cache = {k: torch.zeros_like(s, device=device) for k, s in specs.items()}
    tables = torch.zeros((max_slots, max_len // block_size), dtype=torch.int32,
                         device=device)
    return {"cache": cache, "tables": tables,
            **sched_state(max_slots, device, seed)}


def cache_nbytes(cache_tree: dict) -> int:
    """Total bytes of the KV cache leaves (tensors or meta tensors): on a
    mesh, the bytes this rank holds."""
    return sum(leaf.numel() * leaf.element_size() for leaf in cache_tree.values())
