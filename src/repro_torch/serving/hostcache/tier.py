"""HostTier: the facade the engine consults between the device prefix
cache and fresh compute — the port of the reference's
``serving/hostcache/tier.py`` (its DESIGN.md §13 and §16).

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

Payloads are flat lists of CPU tensors (pinned when a shard's device is
CUDA); the engine owns their layout. ``shard`` is the data shard whose
device prefix cache the entry backs (``num_shards`` of them, 0 on one
device): block contents never cross shards, so neither do their host
copies, though all shards share the arena's one byte budget. Uploads go
through one staging ring for each distinct shard device
(``staging_for``).

A ``CircuitBreaker`` gates every arena operation: repeated integrity or
staging failures trip it, and an open tier answers every probe as a miss
(puts refused, gets None, runs 0) until its half-open probe. ``unpin_kv``
and ``drop_park`` are never gated: refcount hygiene runs in every state.

Durability: an optional ``DiskTier`` sits below the arena. Arena LRU
victims of the ``kv`` and ``rec`` namespaces demote to crc-framed files
(the arena's ``on_evict`` hook fires before a victim's buffers are
recycled); lookups fall through arena -> disk -> miss, and a disk hit is
promoted back into the arena (pinned when the caller pins). ``park``
entries never spill: they are pinned, so never victims, and private to a
live process; a crash loses them by design and the journal re-admits the
request. ``flush_to_disk`` makes still-resident keys durable at a
checkpoint, so the snapshot's references are on disk, not merely cached.

On disk an entry has the reference's layout, not the engine's packed one
(one flat tensor per dtype): ``set_layout`` gives the tier a namespace's
leaves, (dtype, row shape) each in the engine's order, and the reference's
arrays over them (``TransformerLM.reference_walk``). A put splits the
packed entry into those arrays, bfloat16 written as the reference writes
it (``'<V2'``); a get packs them back and restores each leaf's dtype. So a
float32 file is byte for byte the JAX engine's for the same block, and
bfloat16 goes through a round trip. An array that does not fit the layout
(a file of another model) is a miss.
"""
from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.serving.faults import CircuitBreaker

from .arena import HostArena
from .disk import DiskTier, durable_name
from .staging import StagingRing


@dataclass(frozen=True)
class LeafLayout:
    """A namespace's entry layout: ``leaves``, (dtype, row shape) per leaf
    in the engine's order; ``walk``, the reference's arrays as ``(leaf
    indices, stacked)`` (a stacked array holds its leaves' rows along a
    new leading axis)."""
    leaves: tuple
    walk: tuple

    @classmethod
    def of(cls, leaves, walk) -> "LeafLayout":
        """From the engine's leaves ((P or B, *row) tensors) and
        ``TransformerLM.reference_walk``."""
        return cls(tuple((t.dtype, tuple(t.shape[1:])) for t in leaves),
                   tuple((tuple(ix), bool(st)) for ix, st in walk))

    def _dtypes(self) -> list:
        return list(dict.fromkeys(dt for dt, _ in self.leaves))

    def to_reference(self, tensors) -> list:
        """A packed entry (one flat tensor per dtype, in the dtypes' order
        of first appearance) as the reference's arrays."""
        flat = dict(zip(self._dtypes(), tensors))
        off = dict.fromkeys(flat, 0)
        rows = []
        for dt, shape in self.leaves:
            n = math.prod(shape)
            rows.append(flat[dt][off[dt]:off[dt] + n].view(shape))
            off[dt] += n
        return [torch.stack([rows[i] for i in ix]) if st else rows[ix[0]]
                for ix, st in self.walk]

    def from_reference(self, arrays) -> Optional[list]:
        """The reference's arrays (numpy, bfloat16 as two-byte voids)
        packed back; None when they do not fit the layout."""
        if len(arrays) != len(self.walk):
            return None
        rows = [None] * len(self.leaves)
        for a, (ix, st) in zip(arrays, self.walk):
            dt, shape = self.leaves[ix[0]]
            if tuple(a.shape) != ((len(ix),) + shape if st else shape):
                return None
            t = _tensor(a, dt)
            if t is None:
                return None
            for r, i in enumerate(ix):
                rows[i] = t[r] if st else t
        return [torch.cat([rows[i].reshape(-1)
                           for i, (d, _) in enumerate(self.leaves) if d == dt])
                for dt in self._dtypes()]


def _tensor(a: np.ndarray, dtype) -> Optional[torch.Tensor]:
    """A decoded array as a tensor of ``dtype`` (its bytes, not copied:
    the caller copies), or None when its dtype is another."""
    if dtype == torch.bfloat16:
        if a.dtype.kind != "V" or a.dtype.itemsize != 2:
            return None
        a = a.view(np.int16)
    with warnings.catch_warnings():      # decoded frames are read-only
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(a)
    if dtype == torch.bfloat16:
        return t.view(torch.bfloat16)
    return t if t.dtype == dtype else None


class _DiskLink:
    """The tier's link to its disk tier: the layouts, the conversions and
    the spill count. The arena's eviction hook holds this, not the tier: a
    hook on the tier would make a cycle that keeps the page-locked arena
    alive past the tier."""

    def __init__(self, disk: DiskTier):
        self.disk = disk
        self.layouts: dict = {}
        self.spills = 0              # arena victims and flushes put on disk

    def put(self, ns: str, shard: int, key, tensors) -> bool:
        lay = self.layouts.get(ns)
        arrays = lay.to_reference(tensors) if lay is not None else tensors
        if not self.disk.put(durable_name(ns, shard, key), arrays):
            return False
        self.spills += 1
        return True

    def get(self, ns: str, shard: int, key) -> Optional[list]:
        arrays = self.disk.get(durable_name(ns, shard, key))
        if arrays is None:
            return None
        lay = self.layouts.get(ns)
        if lay is None:
            return [torch.from_numpy(np.array(a)) for a in arrays]
        return lay.from_reference(arrays)

    def on_evict(self, key, tensors):
        """Demote a ``kv`` or ``rec`` victim (chain keys are the same in
        every process, so the file outlives this engine)."""
        if key[0] in ("kv", "rec"):
            self.put(key[0], key[1], key[-1], tensors)


def _wait_all(rings):
    """``before_reuse`` over several rings: a recycled buffer waits for
    every upload that reads it, whichever ring made it."""
    def wait_reads(buf):
        for ring in rings:
            ring.wait_reads(buf)
    return wait_reads


class HostTier:
    def __init__(self, capacity_bytes: int, num_shards: int = 1, *, device,
                 integrity: bool = True, faults=None,
                 breaker: Optional[CircuitBreaker] = None,
                 disk: Optional[DiskTier] = None):
        """``device``: one device for every shard, or a list of each
        shard's."""
        devices = (list(device) if isinstance(device, (list, tuple))
                   else [device] * num_shards)
        if len(devices) != num_shards:
            raise ValueError(f"{len(devices)} devices for {num_shards} "
                             "shards")
        self.num_shards = num_shards
        self.devices = [torch.device(d) for d in devices]
        self.breaker = breaker
        self.disk = disk
        self._link = _DiskLink(disk) if disk is not None else None
        self._rings = {d: StagingRing(depth=2, faults=faults, device=d)
                       for d in dict.fromkeys(self.devices)}
        rings = list(self._rings.values())
        # the rings' and the breaker's methods, not the tier's: a callback
        # on the tier would make a cycle that keeps the page-locked arena
        # alive past the tier
        self.arena = HostArena(
            capacity_bytes, integrity=integrity,
            pinned=any(d.type == "cuda" for d in self.devices),
            faults=faults,
            on_corruption=(None if breaker is None else
                           lambda key: breaker.record_failure()),
            before_reuse=(rings[0].wait_reads if len(rings) == 1
                          else _wait_all(rings)),
            on_evict=self._link.on_evict if disk is not None else None)
        self.disk_promotes = 0       # disk hits copied back into the arena

    def staging_for(self, shard: int) -> StagingRing:
        """The staging ring of ``shard``'s device."""
        return self._rings[self.devices[shard]]

    @property
    def staging(self) -> StagingRing:
        """Shard 0's staging ring (the single-device engine's)."""
        return self.staging_for(0)

    @property
    def disk_spills(self) -> int:
        """Entries demoted to the disk tier (evictions and flushes)."""
        return self._link.spills if self._link is not None else 0

    def set_layout(self, ns: str, layout: LeafLayout):
        """The entry layout of namespace ``ns`` (``"kv"`` or ``"rec"``) on
        disk."""
        if self._link is not None:
            self._link.layouts[ns] = layout

    # -- disk demotion and promotion ------------------------------------------
    def _disk_get(self, ns: str, shard: int, key, pin: bool = False):
        """The arena-miss fall-through: a verified disk read, promoted back
        into the arena (so the next probe hits memory and a pin has an
        entry to hold). The tensors or None."""
        if self._link is None:
            return None
        tensors = self._link.get(ns, shard, key)
        if tensors is None:
            return None
        self.arena.put((ns, shard, key), tensors, pin=pin)
        self.disk_promotes += 1
        return tensors

    def _disk_has(self, ns: str, shard: int, key) -> bool:
        return (self.disk is not None
                and self.disk.contains(durable_name(ns, shard, key)))

    def flush_to_disk(self, shard: int, keys, ns: str = "kv") -> int:
        """Put still-resident arena entries on disk without evicting them
        (a checkpoint references these chain keys, so they must be durable
        now, not at some later eviction). The number of keys on disk
        afterwards."""
        if self._link is None:
            return 0
        n = 0
        for key in keys:
            if self.disk.contains(durable_name(ns, shard, key)):
                n += 1
                continue
            tensors = self.arena.get((ns, shard, key))
            if tensors is not None and self._link.put(ns, shard, key,
                                                      tensors):
                n += 1
        return n

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
        return (self.arena.contains(("kv", shard, key))
                or self._disk_has("kv", shard, key))

    def get_kv(self, shard: int, key) -> Optional[list]:
        if not self._allow():
            return None
        tensors = self._verified(self.arena.get(("kv", shard, key)))
        if tensors is None:
            tensors = self._disk_get("kv", shard, key)
        return tensors

    def pin_kv(self, shard: int, key) -> bool:
        if not self._allow():
            return False
        if self.arena.pin(("kv", shard, key)):
            return True
        # not in memory: a disk hit is promoted pinned, so the pin has an
        # arena entry to hold until its owner unpins
        return self._disk_get("kv", shard, key, pin=True) is not None

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
            if not (self.arena.contains(("kv", shard, k), touch=True)
                    or self._disk_has("kv", shard, k)):
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
        return (self.arena.contains(("rec", shard, key), touch=True)
                or self._disk_has("rec", shard, key))

    def get_rec(self, shard: int, key) -> Optional[list]:
        if not self._allow():
            return None
        tensors = self._verified(self.arena.get(("rec", shard, key)))
        if tensors is None:
            tensors = self._disk_get("rec", shard, key)
        return tensors

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
        for ring in self._rings.values():
            for k, v in ring.stats_export().items():
                out[k] = out.get(k, 0) + v
        out["h2d_overlap_frac"] = (out["h2d_overlapped"] / out["h2d_staged"]
                                   if out["h2d_staged"] else 0.0)
        out.update(self.breaker.stats_export() if self.breaker is not None
                   else {"tier_state": "closed", "tier_tripped": 0,
                         "tier_denied_ops": 0})
        if self.disk is not None:
            out.update(self.disk.stats_export())
            out["disk_promotes"] = self.disk_promotes
            out["disk_spills"] = self.disk_spills
        return out
