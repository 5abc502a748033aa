"""Paged KV-cache block manager with a hash-based prefix cache.

A numpy-only copy of the reference's ``serving/blocks.py``: the device
prefix cache, the host tier's spill hook and tiered lookup, ``spill`` (a
preempted sequence's release), the staging ledger and the mesh engine's
``ShardedBlockPool`` (one sub-pool per data shard, pool-pressure routing,
the block accounting of a migration). Same ids, same hashes, same
decisions on the same traffic.

Invariants:

* Physical block 0 is a reserved write sink (masked lanes land there); it
  is never allocated and never enters the prefix cache.
* A block is registerable (hashable, shareable) only once it holds a full
  ``block_size`` run of prompt positions that the engine never rewrites —
  blocks entirely below position ``L_p - 1``, because the verify window
  rewrites position ``n - 1`` every round and ``n`` starts at ``L_p``.
  Shared blocks are therefore read-only by construction.
* Releasing a sequence decrements refcounts; blocks that carry a prefix
  hash go to a cached-free LRU pool (still hittable) and are evicted only
  when the plain free list runs dry.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional

import numpy as np


def chain_hashes(tokens, block_size: int, n_blocks: Optional[int] = None):
    """Chained content hashes for the leading full blocks of ``tokens``:
    ``key_j = hash(key_{j-1}, tokens[j*bs:(j+1)*bs])`` — a block's KV
    depends on the whole prefix, so the key must too."""
    tokens = np.asarray(tokens)
    total = len(tokens) // block_size if n_blocks is None else n_blocks
    keys, prev = [], 0
    for j in range(total):
        blk = tuple(int(t) for t in tokens[j * block_size:(j + 1) * block_size])
        prev = hash((prev,) + blk)
        keys.append(prev)
    return keys


@dataclass
class BlockStats:
    allocated: int = 0
    freed: int = 0
    prefix_hits: int = 0
    prefix_misses: int = 0
    evictions: int = 0
    spilled: int = 0             # block contents kept on the host: a
    #                              preemption's release, an eviction the
    #                              spill hook saved
    dropped: int = 0             # hashed contents evicted outright: no
    #                              host tier, or it refused the spill
    migrated_in: int = 0         # landing blocks allocated for a migration
    migrated_out: int = 0        # blocks released by a departing migration

    def export(self) -> dict:
        total = self.prefix_hits + self.prefix_misses
        return {
            "blocks_allocated": self.allocated,
            "blocks_freed": self.freed,
            "prefix_hits": self.prefix_hits,
            "prefix_misses": self.prefix_misses,
            "prefix_hit_rate": (self.prefix_hits / total) if total else 0.0,
            "evictions": self.evictions,
            "blocks_spilled": self.spilled,
            "blocks_dropped": self.dropped,
            "blocks_migrated_in": self.migrated_in,
            "blocks_migrated_out": self.migrated_out,
        }


class BlockManager:
    """Free-list allocator + prefix cache over ``num_blocks`` physical
    blocks of ``block_size`` token positions each (block 0 reserved)."""

    def __init__(self, num_blocks: int, block_size: int):
        assert num_blocks >= 2 and block_size >= 1
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.free: list[int] = list(range(num_blocks - 1, 0, -1))  # pop() -> 1 first
        self.refcount = np.zeros(num_blocks, np.int32)
        self.hash_of: dict[int, int] = {}          # block id -> prefix key
        self.block_of: dict[int, int] = {}         # prefix key -> block id
        self.cached_free: OrderedDict[int, None] = OrderedDict()  # LRU, oldest first
        self.stats = BlockStats()
        # the host tier's hook: called with ``(block_id, prefix_key)`` when
        # a registered cached-free block is about to be evicted (still
        # registered, contents readable); True iff it kept the contents on
        # the host (``spilled``), else they are ``dropped``
        self.spill_hook = None
        # the ``alloc`` fault seam: a callable that returns True where an
        # allocation must fail (``FaultPlan.fire``), or None
        self.fault_hook = None

    def available(self) -> int:
        return len(self.free) + len(self.cached_free)

    def blocks_in_use(self) -> int:
        return int((self.refcount > 0).sum())

    def alloc(self, n: int = 1) -> list[int]:
        """Take ``n`` fresh private blocks (refcount 1, no hash)."""
        if self.fault_hook is not None and self.fault_hook():
            raise MemoryError(
                "injected block allocation failure (FaultPlan seam 'alloc')")
        if self.available() < n:
            raise MemoryError(
                f"block pool exhausted: want {n}, have {self.available()}")
        out = []
        for _ in range(n):
            if self.free:
                b = self.free.pop()
            else:
                b, _ = self.cached_free.popitem(last=False)  # evict oldest
                key = self.hash_of.get(b)
                saved = bool(key is not None and self.spill_hook is not None
                             and self.spill_hook(b, key))
                if saved:
                    self.stats.spilled += 1
                else:
                    self.stats.dropped += 1
                self._unregister(b)
                self.stats.evictions += 1
            self.refcount[b] = 1
            self.stats.allocated += 1
            out.append(b)
        return out

    def _unregister(self, b: int):
        key = self.hash_of.pop(b, None)
        if key is not None and self.block_of.get(key) == b:
            del self.block_of[key]

    def lookup_prefix(self, tokens, max_blocks: int):
        """Longest cached chain for ``tokens``' leading full blocks (at most
        ``max_blocks`` of them). Returns (hit block ids with refcount taken,
        chained keys for all ``max_blocks`` leading blocks)."""
        keys = chain_hashes(tokens, self.block_size, max_blocks)
        hits = []
        for key in keys:
            b = self.block_of.get(key)
            if b is None:
                break
            self.acquire(b)
            hits.append(b)
        self.stats.prefix_hits += len(hits)
        self.stats.prefix_misses += len(keys) - len(hits)
        return hits, keys

    def lookup_prefix_tiered(self, tokens, max_blocks: int, tier=None,
                             shard: int = 0):
        """``lookup_prefix`` with the host tier behind it: returns ``(hits,
        keys, host_keys)``, ``host_keys`` the contiguous run of chained keys
        right after the device hits whose contents the tier holds (a
        resident block behind a gap is of no use)."""
        hits, keys = self.lookup_prefix(tokens, max_blocks)
        host_keys: list[int] = []
        if tier is not None and len(hits) < len(keys):
            run = tier.kv_run(shard, keys[len(hits):])
            host_keys = keys[len(hits):len(hits) + run]
        return hits, keys, host_keys

    def register(self, b: int, key: int):
        """Publish a (still-referenced) block under a prefix key. First
        writer wins; duplicates stay private."""
        assert self.refcount[b] > 0 and b != 0
        if key not in self.block_of and b not in self.hash_of:
            self.block_of[key] = b
            self.hash_of[b] = key

    def acquire(self, b: int):
        """Add a reference to an existing block (prefix-cache hit)."""
        if self.refcount[b] == 0:        # resurrect from cached-free pool
            self.cached_free.pop(b, None)
        self.refcount[b] += 1

    def release(self, b: int):
        """Drop a reference. Unreferenced hashed blocks become cached-free
        (still hittable); unhashed ones return to the plain free list."""
        assert self.refcount[b] > 0, f"double free of block {b}"
        self.refcount[b] -= 1
        if self.refcount[b] == 0:
            self.stats.freed += 1
            if b in self.hash_of:
                self.cached_free[b] = None
                self.cached_free.move_to_end(b)
            else:
                self.free.append(b)

    def release_all(self, blocks):
        for b in blocks:
            self.release(b)

    def spill(self, blocks) -> int:
        """Release a preempted sequence's blocks, whose contents were parked
        on the host. Hashed prompt blocks drop to cached-free, so an exact
        resume can hit them again instead of uploading them."""
        self.release_all(blocks)
        self.stats.spilled += len(blocks)
        return len(blocks)


class StagingLedger:
    """Block claims of staged requests. Staging allocates a queued
    request's worst case before the loop that may adopt it, so the loop
    never allocates; a claim is granted only out of the headroom the caller
    computes net of resident reservations, so staging never starves a
    running sequence. Tracked per shard and per request, so unstaging,
    adoption and cancel release exactly what was claimed. The ledger moves
    no block: the engine allocates and releases them."""

    def __init__(self, slots_per_shard: int):
        assert slots_per_shard >= 0
        self.slots_per_shard = slots_per_shard
        self._claims: dict[tuple[int, int], int] = {}   # (shard, uid) -> blocks
        self._by_shard: dict[int, int] = {}             # shard -> blocks claimed
        self._count: dict[int, int] = {}                # shard -> staged entries

    def staged_blocks(self, shard: int) -> int:
        return self._by_shard.get(shard, 0)

    def staged_count(self, shard: int) -> int:
        return self._count.get(shard, 0)

    def has(self, shard: int, uid: int) -> bool:
        return (shard, uid) in self._claims

    def try_claim(self, shard: int, uid: int, need: int,
                  headroom: int) -> bool:
        """Claim ``need`` blocks on ``shard`` for staged request ``uid``,
        out of ``headroom`` (free blocks net of resident reservations).
        Refuses when the shard's staging slots are full or the claim
        exceeds the headroom."""
        assert (shard, uid) not in self._claims, (shard, uid)
        if self._count.get(shard, 0) >= self.slots_per_shard:
            return False
        if need > headroom:
            return False
        self._claims[(shard, uid)] = need
        self._by_shard[shard] = self._by_shard.get(shard, 0) + need
        self._count[shard] = self._count.get(shard, 0) + 1
        return True

    def release(self, shard: int, uid: int) -> int:
        """Drop a claim (unstaged, adopted or cancelled); returns its
        size."""
        need = self._claims.pop((shard, uid))
        self._by_shard[shard] -= need
        self._count[shard] -= 1
        assert self._by_shard[shard] >= 0 and self._count[shard] >= 0
        return need


class ShardedBlockPool:
    """One ``BlockManager`` per data shard, with pool-pressure routing on
    top. Each shard owns ``blocks_per_shard`` blocks with shard-local ids,
    its own sink block 0 and its own prefix cache: a block is never shared
    across shards, which keeps every shard's round reading its own pool
    only. ``num_shards=1`` is the single-device engine's pool, bit for bit
    a bare ``BlockManager``."""

    def __init__(self, num_shards: int, blocks_per_shard: int,
                 block_size: int):
        assert num_shards >= 1
        self.num_shards = num_shards
        self.blocks_per_shard = blocks_per_shard
        self.block_size = block_size
        self.shards = [BlockManager(blocks_per_shard, block_size)
                       for _ in range(num_shards)]

    def manager(self, shard: int) -> BlockManager:
        return self.shards[shard]

    # -- a migration's block accounting ---------------------------------------
    def begin_migration(self, src_shard: int, dst_shard: int,
                        n: int) -> list[int]:
        """Allocate ``n`` landing blocks on ``dst_shard`` for a sequence
        leaving ``src_shard``: their shard-local ids. The caller copies the
        contents, then calls ``finish_migration``. Raises MemoryError where
        the destination cannot take them."""
        assert src_shard != dst_shard, (src_shard, dst_shard)
        out = self.shards[dst_shard].alloc(n)
        self.shards[dst_shard].stats.migrated_in += n
        return out

    def finish_migration(self, src_shard: int, blocks) -> None:
        """Release a migrated sequence's source blocks (shared prefix
        blocks drop one reference)."""
        self.shards[src_shard].release_all(blocks)
        self.shards[src_shard].stats.migrated_out += len(blocks)

    # -- hooks ------------------------------------------------------------------
    def set_spill_hook(self, make_hook) -> None:
        """Each shard's eviction hook: ``make_hook(shard)`` (or None)."""
        for s, m in enumerate(self.shards):
            m.spill_hook = make_hook(s)

    def set_fault_hook(self, hook) -> None:
        """One allocation fault hook shared by every sub-pool: host calls
        are sequential, so a shared ``FaultPlan`` counter stays
        deterministic across shards."""
        for m in self.shards:
            m.fault_hook = hook

    # -- capacity ---------------------------------------------------------------
    def available(self, shard: Optional[int] = None) -> int:
        if shard is not None:
            return self.shards[shard].available()
        return sum(m.available() for m in self.shards)

    def blocks_in_use(self) -> int:
        return sum(m.blocks_in_use() for m in self.shards)

    @staticmethod
    def route(need: int, headroom_by_shard: dict) -> Optional[int]:
        """Pool-pressure routing: of the candidate shards (those with a
        free slot), the one with the most headroom (free blocks net of
        outstanding reservations) that covers ``need``; the lowest shard
        breaks ties, and an exact fit admits. None where no shard can take
        the request."""
        best = None
        for s in sorted(headroom_by_shard):
            head = headroom_by_shard[s]
            if head >= need and (best is None or head > best[1]):
                best = (s, head)
        return None if best is None else best[0]

    def stats_export(self) -> dict:
        """The shards' counters summed, the hit rate recomputed over all."""
        out: dict = {}
        for m in self.shards:
            for k, v in m.stats.export().items():
                out[k] = out.get(k, 0) + v
        total = out["prefix_hits"] + out["prefix_misses"]
        out["prefix_hit_rate"] = (out["prefix_hits"] / total) if total else 0.0
        return out
