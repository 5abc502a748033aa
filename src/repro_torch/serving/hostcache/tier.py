"""HostTier: the facade the engine consults between the device prefix
cache and fresh compute — the port of the reference's
``serving/hostcache/tier.py`` (its DESIGN.md §13), without the disk tier.

One ``HostArena`` (one byte budget for the process) serves three clients
through namespaced keys:

* ``("kv", shard, chain_key)`` — spilled prefix blocks: the pool rows of
  one hashed KV block, keyed by the chained prompt hash the block manager
  registers on the device. ``kv_run`` answers a device miss with the
  longest contiguous resident run, so the engine stages only blocks it can
  use.
* ``("rec", shard, chain_key)`` — recurrent-state snapshots: a slot's
  RWKV/Mamba state rows taken at a block boundary, under the same keys, so
  a shared prompt hits for recurrent stacks where it hits for attention.
* ``("park", uid)`` — a parked sequence's private payload (its tail blocks
  and recurrent rows), pinned until its resume. Its shared prompt blocks
  live once in the ``kv`` namespace, pinned by every parked sequence that
  needs them.

Payloads are flat lists of CPU tensors (pinned when ``device`` is CUDA);
the engine owns their layout. ``shard`` is always 0 on one device.

A ``CircuitBreaker`` gates every arena operation: repeated integrity or
staging failures trip it, and an open tier answers every probe as a miss
(puts refused, gets None, runs 0) until its half-open probe. ``unpin_kv``
and ``drop_park`` are never gated: refcount hygiene runs in every state.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.serving.faults import CircuitBreaker

from .arena import HostArena
from .staging import StagingRing


class HostTier:
    def __init__(self, capacity_bytes: int, *, device,
                 integrity: bool = True, faults=None,
                 breaker: Optional[CircuitBreaker] = None):
        device = torch.device(device)
        self.breaker = breaker
        self.staging = StagingRing(depth=2, faults=faults, device=device)
        # the breaker's method, not the tier's: a callback on the tier would
        # make a cycle that keeps the page-locked arena alive past the tier
        self.arena = HostArena(
            capacity_bytes, integrity=integrity,
            pinned=device.type == "cuda", faults=faults,
            on_corruption=(None if breaker is None else
                           lambda key: breaker.record_failure()),
            before_reuse=self.staging.wait_reads)

    # -- circuit breaker ------------------------------------------------------
    def _allow(self) -> bool:
        return self.breaker is None or self.breaker.allow()

    def record_failure(self):
        """An integrity or staging failure involving this tier."""
        if self.breaker is not None:
            self.breaker.record_failure()

    def _verified(self, tensors):
        """A get that passed its integrity check counts as breaker health."""
        if tensors is not None and self.breaker is not None:
            self.breaker.record_success()
        return tensors

    # -- prefix-spill client --------------------------------------------------
    def put_kv(self, shard: int, key, tensors, pin: bool = False) -> bool:
        if not self._allow():
            return False
        return self.arena.put(("kv", shard, key), tensors, pin=pin)

    def has_kv(self, shard: int, key) -> bool:
        if not self._allow():
            return False
        return self.arena.contains(("kv", shard, key))

    def get_kv(self, shard: int, key) -> Optional[list]:
        if not self._allow():
            return None
        return self._verified(self.arena.get(("kv", shard, key)))

    def pin_kv(self, shard: int, key) -> bool:
        if not self._allow():
            return False
        return self.arena.pin(("kv", shard, key))

    def unpin_kv(self, shard: int, key):
        self.arena.unpin(("kv", shard, key))      # never breaker-gated

    def kv_run(self, shard: int, keys) -> int:
        """Longest contiguous resident run of ``keys`` (chained hashes,
        oldest block first), each resident key touched so a popular prefix
        stays warm. Stops at the first gap: a later block is useless
        without its predecessors."""
        if not self._allow():
            return 0
        n = 0
        for k in keys:
            if not self.arena.contains(("kv", shard, k), touch=True):
                break
            n += 1
        return n

    # -- recurrent-snapshot client --------------------------------------------
    def put_rec(self, shard: int, key, tensors) -> bool:
        if not self._allow():
            return False
        return self.arena.put(("rec", shard, key), tensors)

    def has_rec(self, shard: int, key) -> bool:
        if not self._allow():
            return False
        return self.arena.contains(("rec", shard, key), touch=True)

    def get_rec(self, shard: int, key) -> Optional[list]:
        if not self._allow():
            return None
        return self._verified(self.arena.get(("rec", shard, key)))

    # -- parked-sequence client -----------------------------------------------
    def put_park(self, uid: int, tensors) -> bool:
        if not self._allow():
            return False
        return self.arena.put(("park", uid), tensors, pin=True)

    def take_park(self, uid: int) -> Optional[list]:
        """Consume a parked payload: one copy out, and the pinned entry
        removed (parking is one-shot). None (a tripped tier, a corrupt
        entry) sends the caller down the recompute path."""
        if not self._allow():
            return None
        tensors = self._verified(self.arena.get(("park", uid)))
        if tensors is None:
            return None
        out = self.arena.copy_out(tensors)      # the buffers go to the slab
        self.arena.drop(("park", uid))
        return out

    def drop_park(self, uid: int) -> bool:
        """Discard a parked payload unread (a cancel, a failed resume)."""
        return self.arena.drop(("park", uid))    # never breaker-gated

    # -- telemetry --------------------------------------------------------------
    def stats_export(self) -> dict:
        out = self.arena.stats_export()
        out.update(self.staging.stats_export())
        out.update(self.breaker.stats_export() if self.breaker is not None
                   else {"tier_state": "closed", "tier_tripped": 0,
                         "tier_denied_ops": 0})
        return out
