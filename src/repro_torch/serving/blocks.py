"""Paged KV-cache block manager with a hash-based prefix cache.

A numpy-only copy of the reference's ``serving/blocks.py`` (device prefix
cache only; the host tier, staging ledger and sharded pool are later
slices). Same ids, same hashes, same decisions on the same traffic.

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

    def export(self) -> dict:
        total = self.prefix_hits + self.prefix_misses
        return {
            "blocks_allocated": self.allocated,
            "blocks_freed": self.freed,
            "prefix_hits": self.prefix_hits,
            "prefix_misses": self.prefix_misses,
            "prefix_hit_rate": (self.prefix_hits / total) if total else 0.0,
            "evictions": self.evictions,
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
