"""Bounded host-memory arena: slab-recycled buffers, refcount pinning,
strict LRU eviction — the port of the reference's
``serving/hostcache/arena.py`` (its DESIGN.md §13).

The arena is the one byte-budgeted store under the host tier
(``tier.HostTier``). An *entry* is a flat list of CPU tensors under one
hashable key: a spilled prefix block's pool rows, a parked sequence's
private payload, or a recurrent-state snapshot. The arena never interprets
the tensors; clients own the keying and the (de)composition. With
``pinned=True`` (the engine on a CUDA device) every buffer is page-locked,
so the staging ring's uploads from it run asynchronously; on the CPU the
buffers are plain.

Invariants:

* **Bounded.** ``bytes_resident + bytes_slab <= capacity_bytes`` always. A
  ``put`` that cannot fit after evicting every unpinned entry is refused
  (returns False, counted); the arena never grows past its budget.
* **Slab allocation per shape.** Evicted and dropped entries give their
  buffers to per-``(shape, dtype)`` free lists; a later ``put`` of the
  same shape copies into a recycled buffer, so steady spill traffic
  allocates no pinned memory. Slab bytes count against the budget and are
  trimmed first under pressure. ``before_reuse`` (the staging ring's
  ``wait_reads``) is called with a recycled buffer before it is written,
  so no upload still reading it sees the new bytes.
* **Refcount pinning.** Entries with ``refs > 0`` are never evicted.
* **Strict LRU.** Unpinned entries are evicted oldest touch first; every
  ``get`` hit and dedup ``put`` refreshes recency. ``on_evict(key,
  tensors)`` is called with every victim before its buffers go to the slab
  (the tier points it at the disk spill), so the hook reads the victim's
  bytes intact: it runs on the host, synchronously, before any later put
  can take a buffer of the victim and wait in ``before_reuse`` for the
  uploads still reading it.
* **Integrity-checked.** Every put stamps a crc32 over the entry's bytes
  (the raw bytes of each tensor, so the same bytes give the reference's
  checksum); every get verifies it. A mismatch drops the entry, pinned or
  not, counts ``checksum_failures``, tells ``on_corruption`` and answers a
  miss: corrupt bytes never reach the device. ``integrity=False`` skips
  the stamp and the check.
"""
from __future__ import annotations

import zlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional

import torch


def _raw(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes as a flat uint8 view (numpy has no bfloat16)."""
    return t.reshape(-1).view(torch.uint8)


def _nbytes(tensors) -> int:
    return int(sum(t.numel() * t.element_size() for t in tensors))


def checksum(tensors) -> int:
    """crc32 over the concatenated raw bytes of a flat tensor list."""
    c = 0
    for t in tensors:
        if t.numel():
            c = zlib.crc32(memoryview(_raw(t).numpy()), c)
    return c


@dataclass
class ArenaStats:
    hits: int = 0                # get() found the key
    misses: int = 0              # get() found nothing, or a corrupt entry
    puts: int = 0                # new entries admitted
    dedup_hits: int = 0          # put() of an already-resident key
    evictions: int = 0           # LRU entries dropped for space
    rejections: int = 0          # puts refused (budget, pins, fault)
    slab_reuses: int = 0         # buffers recycled from the slab pool
    bytes_in: int = 0            # payload bytes copied into the arena
    checksum_failures: int = 0   # gets whose crc32 verify failed

    def export(self, arena: "HostArena") -> dict:
        return {
            "checksum_failures": self.checksum_failures,
            "host_hits": self.hits,
            "host_misses": self.misses,
            "host_puts": self.puts,
            "host_dedup_hits": self.dedup_hits,
            "host_evictions": self.evictions,
            "host_rejections": self.rejections,
            "host_slab_reuses": self.slab_reuses,
            "host_bytes_in": self.bytes_in,
            "host_bytes_resident": arena.bytes_resident,
            "host_bytes_slab": arena.bytes_slab,
            "host_bytes_capacity": arena.capacity_bytes,
            "host_entries": len(arena._entries),
            "host_entries_pinned": sum(
                1 for e in arena._entries.values() if e.refs > 0),
        }


@dataclass
class _Entry:
    tensors: list
    nbytes: int
    refs: int = 0
    crc: int = 0                 # crc32 stamped at put (0 when unchecked)


class HostArena:
    """Fixed-budget key -> list-of-tensors store with LRU and pinning.

    ``faults`` is an optional ``FaultPlan`` wired to the ``arena_put`` and
    ``arena_corrupt`` seams; ``on_corruption`` is called with the key of
    every entry whose verify fails (the tier points it at its circuit
    breaker); ``on_evict`` with the key and tensors of every LRU victim,
    before its buffers are recycled."""

    def __init__(self, capacity_bytes: int, *, integrity: bool = True,
                 pinned: bool = False, faults=None, on_corruption=None,
                 before_reuse=None, on_evict=None):
        if capacity_bytes < 0:
            raise ValueError(f"capacity_bytes={capacity_bytes}")
        self.capacity_bytes = int(capacity_bytes)
        self.integrity = integrity
        self.pinned = pinned
        self.faults = faults
        self.on_corruption = on_corruption
        self.before_reuse = before_reuse
        self.on_evict = on_evict
        # insertion/touch order is the LRU order (oldest first)
        self._entries: "OrderedDict[object, _Entry]" = OrderedDict()
        self._slab: dict[tuple, list] = {}       # (shape, dtype) -> buffers
        self.bytes_resident = 0
        self.bytes_slab = 0
        self.stats = ArenaStats()

    # -- slab pool ----------------------------------------------------------
    @staticmethod
    def _slab_key(t: torch.Tensor) -> tuple:
        return (tuple(t.shape), t.dtype)

    def _slab_take(self, src: torch.Tensor) -> torch.Tensor:
        free = self._slab.get(self._slab_key(src))
        if free:
            buf = free.pop()
            self.bytes_slab -= buf.numel() * buf.element_size()
            self.stats.slab_reuses += 1
            if self.before_reuse is not None:
                self.before_reuse(buf)
        else:
            buf = torch.empty(src.shape, dtype=src.dtype,
                              pin_memory=self.pinned)
        buf.copy_(src)
        return buf

    def _slab_give(self, tensors):
        for t in tensors:
            self._slab.setdefault(self._slab_key(t), []).append(t)
            self.bytes_slab += t.numel() * t.element_size()

    def _trim_slab(self, want: int):
        """Drop slab buffers (any shape) until ``want`` bytes fit beside
        the resident set."""
        for key in list(self._slab):
            free = self._slab[key]
            while free and self._free_bytes() < want:
                t = free.pop()
                self.bytes_slab -= t.numel() * t.element_size()
            if not free:
                del self._slab[key]
            if self._free_bytes() >= want:
                return

    # -- capacity -----------------------------------------------------------
    def _free_bytes(self) -> int:
        return self.capacity_bytes - self.bytes_resident - self.bytes_slab

    def _evict_for(self, want: int) -> bool:
        """Room for ``want`` payload bytes: trim the slab first, then evict
        unpinned entries oldest first. False if even a full sweep cannot
        free enough."""
        if want > self.capacity_bytes:
            return False
        self._trim_slab(want)
        if self._free_bytes() >= want:
            return True
        for key in list(self._entries):
            e = self._entries[key]
            if e.refs > 0:
                continue
            del self._entries[key]
            self.bytes_resident -= e.nbytes
            if self.on_evict is not None:
                self.on_evict(key, e.tensors)
            self._slab_give(e.tensors)
            self.stats.evictions += 1
            self._trim_slab(want)
            if self._free_bytes() >= want:
                return True
        self._trim_slab(want)
        return self._free_bytes() >= want

    # -- entry API ----------------------------------------------------------
    def contains(self, key, touch: bool = False) -> bool:
        """Presence probe with no hit or miss accounting."""
        if key in self._entries:
            if touch:
                self._entries.move_to_end(key)
            return True
        return False

    def put(self, key, tensors, pin: bool = False) -> bool:
        """Copy ``tensors`` (a flat list of CPU tensors) into the arena
        under ``key``. A resident key is a dedup hit: the entry is kept
        (keys are content-addressed), refreshed and optionally pinned, and
        nothing is copied. Returns False iff the arena cannot make room or
        an injected ``arena_put`` fault refuses it."""
        if self.faults is not None and self.faults.fire("arena_put"):
            self.stats.rejections += 1
            return False
        e = self._entries.get(key)
        if e is not None:
            self._entries.move_to_end(key)
            if pin:
                e.refs += 1
            self.stats.dedup_hits += 1
            return True
        want = _nbytes(tensors)
        if not self._evict_for(want):
            self.stats.rejections += 1
            return False
        copies = [self._slab_take(t) for t in tensors]
        self._entries[key] = _Entry(
            copies, want, refs=1 if pin else 0,
            crc=checksum(copies) if self.integrity else 0)
        self.bytes_resident += want
        self.stats.puts += 1
        self.stats.bytes_in += want
        return True

    def get(self, key, pin: bool = False) -> Optional[list]:
        """LRU-refreshing lookup: the entry's tensors (the arena's own
        buffers, not to be written) or None. The checksum is verified
        first; a mismatch drops the entry and answers a miss."""
        e = self._entries.get(key)
        if e is None:
            self.stats.misses += 1
            return None
        if self.faults is not None and self.faults.fire("arena_corrupt"):
            self._corrupt(e)
        if self.integrity and e.crc != checksum(e.tensors):
            self.stats.checksum_failures += 1
            self.stats.misses += 1
            self.drop(key)
            if self.on_corruption is not None:
                self.on_corruption(key)
            return None
        self._entries.move_to_end(key)
        if pin:
            e.refs += 1
        self.stats.hits += 1
        return e.tensors

    @staticmethod
    def _corrupt(e: _Entry):
        """The ``arena_corrupt`` seam: flip one byte of the stored entry
        (the verify of the same get must catch it)."""
        for t in e.tensors:
            if t.numel():
                _raw(t)[0] ^= 0xFF
                return

    def pin(self, key) -> bool:
        e = self._entries.get(key)
        if e is None:
            return False
        e.refs += 1
        return True

    def unpin(self, key):
        """Drop one pin. A missing entry is no error: a failed verify drops
        a corrupt entry even while pinned, and its pin owner still unpins
        afterwards."""
        e = self._entries.get(key)
        if e is None or e.refs <= 0:
            return
        e.refs -= 1

    def drop(self, key) -> bool:
        """Remove an entry outright; its buffers go to the slab pool."""
        e = self._entries.pop(key, None)
        if e is None:
            return False
        self.bytes_resident -= e.nbytes
        self._slab_give(e.tensors)
        return True

    def copy_out(self, tensors) -> list:
        """Copies of ``tensors`` (an entry's buffers, which a later put may
        recycle) in memory as page-locked as the arena's."""
        return [torch.empty_like(t, pin_memory=self.pinned).copy_(t)
                for t in tensors]

    def __len__(self) -> int:
        return len(self._entries)

    def stats_export(self) -> dict:
        return self.stats.export(self)
