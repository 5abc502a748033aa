"""Durable disk tier below the host arena — the port's own copy of the
reference's ``serving/hostcache/disk.py`` (its DESIGN.md §16), byte for
byte in its frames.

The arena's LRU victims (spilled prefix blocks and recurrent-state
snapshots, keyed by the chained content hashes the device prefix cache
registers) land here as crc32-framed files instead of vanishing, so a
lookup falls through arena -> disk -> recompute, and a restarted engine
hits the prefixes a dead process computed. Chain keys survive restarts:
``blocks.chain_hashes`` hashes tuples of ints, which Python hashes the same
in every process (only str and bytes hashing is salted).

File format (one entry per file, named by ``durable_name``)::

    b"RDT1" | u32 crc32(payload) | u64 len(payload) | payload
    payload = u32 n_arrays, then per array:
              u16 len(dtype_str) | dtype_str | u8 ndim | u32 dims... | bytes

An array is a numpy array or a CPU torch tensor; a tensor goes through its
raw bytes, since numpy has no bfloat16. A tensor's dtype string is the one
numpy gives its dtype, and a bfloat16 tensor's is ``'<V2'``, the string the
reference writes for ``ml_dtypes.bfloat16``; ``decode_entry`` returns
numpy arrays, a ``'<V2'`` one as a two-byte void array, as the
reference's does. The host tier restores the dtype from its layout.

* **Atomic visibility.** A put writes ``<name>.tmp``, flushes, fsyncs and
  renames it over the final name, so a reader (or a restarted process) sees
  a whole frame or nothing; ``.tmp`` orphans of a crash are swept at
  startup. The ``mid_spill`` kill point sits between the write and the
  rename.
* **Byte-budgeted LRU.** ``capacity_bytes`` bounds the directory; a put
  evicts the oldest-touched entries first. The index lives in memory and is
  rebuilt at startup from a scan in mtime order (an approximate LRU across
  restarts; exactness never depends on it).
* **Verified reads.** Every get checks the crc; a mismatch (a torn write
  that was still renamed, an injected ``disk_torn_write``, bit rot) deletes
  the file and answers a miss.
* **Breaker-isolated.** The tier has its own ``CircuitBreaker``: ENOSPC
  (or the ``disk_full`` seam), repeated checksum failures and any OSError
  degrade the engine to host-only caching, never to an error. ``drop`` is
  never gated.
"""
from __future__ import annotations

import os
import struct
import time
import zlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.serving.faults import CircuitBreaker, kill_point

_MAGIC = b"RDT1"
_HEADER = struct.Struct("<4sIQ")      # magic, crc32, payload length


def _dtype_str(a) -> str:
    """The dtype string the reference writes for ``a``'s dtype."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return "<V2"
        return np.dtype(str(a.dtype).removeprefix("torch.")).str
    return a.dtype.str


def _raw_bytes(a) -> bytes:
    if isinstance(a, torch.Tensor):
        a = a.detach().contiguous()
        # a bfloat16 tensor's bytes are those of its 16-bit words
        a = (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    return np.ascontiguousarray(a).tobytes()


def encode_entry(arrays) -> bytes:
    """Frame a flat list of arrays (numpy, or CPU tensors) as one
    crc-checked payload."""
    parts = [struct.pack("<I", len(arrays))]
    for a in arrays:
        shape = tuple(a.shape)
        dt = _dtype_str(a).encode()
        parts.append(struct.pack("<H", len(dt)) + dt)
        parts.append(struct.pack("<B", len(shape))
                     + struct.pack(f"<{len(shape)}I", *shape))
        parts.append(_raw_bytes(a))
    payload = b"".join(parts)
    return _HEADER.pack(_MAGIC, zlib.crc32(payload), len(payload)) + payload


def decode_entry(buf: bytes) -> Optional[list]:
    """Parse a framed entry into numpy arrays; None on any inconsistency
    (a torn or corrupt frame)."""
    if len(buf) < _HEADER.size:
        return None
    magic, crc, plen = _HEADER.unpack_from(buf)
    payload = buf[_HEADER.size:]
    if magic != _MAGIC or len(payload) != plen or zlib.crc32(payload) != crc:
        return None
    try:
        off = 4
        (n,) = struct.unpack_from("<I", payload)
        out = []
        for _ in range(n):
            (dlen,) = struct.unpack_from("<H", payload, off)
            off += 2
            dt = np.dtype(payload[off:off + dlen].decode())
            off += dlen
            (ndim,) = struct.unpack_from("<B", payload, off)
            off += 1
            shape = struct.unpack_from(f"<{ndim}I", payload, off)
            off += 4 * ndim
            nb = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
            a = np.frombuffer(payload[off:off + nb], dt).reshape(shape)
            off += nb
            out.append(a)
        return out if off == len(payload) else None
    except (struct.error, ValueError, TypeError, UnicodeDecodeError):
        return None


def durable_name(namespace: str, shard: int, key: int) -> str:
    """The file name of one namespaced chain key. The key is an int (a
    chained tuple hash, the same in every process); masking it to 64 bits
    keeps the name fixed-width, and is injective over Python's +-2**61 hash
    range."""
    return f"{namespace}_{shard}_{key & 0xFFFFFFFFFFFFFFFF:016x}.blk"


@dataclass
class DiskStats:
    puts: int = 0                # entries admitted (renamed into place)
    dedup_hits: int = 0          # puts of a name already resident
    hits: int = 0                # gets that returned verified arrays
    misses: int = 0              # gets that found nothing usable
    evictions: int = 0           # LRU files deleted for space
    rejections: int = 0          # puts refused (budget, breaker, ENOSPC)
    checksum_failures: int = 0   # reads whose crc failed (file deleted)
    orphans_swept: int = 0       # crash-leftover .tmp files removed at boot
    bytes_written: int = 0       # frame bytes fsynced to disk


class DiskTier:
    """A byte-budgeted directory of crc-framed spill files with LRU
    eviction, behind its own circuit breaker. Every method is total: a
    failure (ENOSPC, a torn frame, an unreadable directory) is a miss or a
    refused put, never an exception."""

    def __init__(self, root: str, capacity_bytes: int = 1 << 30, *,
                 faults=None, breaker: Optional[CircuitBreaker] = None):
        if capacity_bytes < 0:
            raise ValueError(f"capacity_bytes={capacity_bytes}")
        self.root = root
        self.capacity_bytes = int(capacity_bytes)
        self.faults = faults
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self.stats = DiskStats()
        # name -> file size; insertion/touch order is the LRU order
        self._index: "OrderedDict[str, int]" = OrderedDict()
        self.bytes_resident = 0
        os.makedirs(root, exist_ok=True)
        self._rebuild_index()

    def _rebuild_index(self):
        """The startup scan: sweep crash orphans, index the entries in
        mtime order (the best LRU across restarts the filesystem keeps)."""
        entries = []
        try:
            for name in os.listdir(self.root):
                path = os.path.join(self.root, name)
                if name.endswith(".tmp"):
                    try:
                        os.unlink(path)
                        self.stats.orphans_swept += 1
                    except OSError:
                        pass
                    continue
                if not name.endswith(".blk"):
                    continue
                try:
                    st = os.stat(path)
                except OSError:
                    continue
                entries.append((st.st_mtime, name, st.st_size))
        except OSError:
            return
        for _, name, size in sorted(entries):
            self._index[name] = size
            self.bytes_resident += size

    # -- capacity -------------------------------------------------------------
    def _evict_for(self, want: int) -> bool:
        if want > self.capacity_bytes:
            return False
        while self._index and self.bytes_resident + want > self.capacity_bytes:
            name, size = self._index.popitem(last=False)     # oldest touch
            self.bytes_resident -= size
            try:
                os.unlink(os.path.join(self.root, name))
            except OSError:
                pass
            self.stats.evictions += 1
        return self.bytes_resident + want <= self.capacity_bytes

    def _forget(self, name: str):
        size = self._index.pop(name, None)
        if size is not None:
            self.bytes_resident -= size
        try:
            os.unlink(os.path.join(self.root, name))
        except OSError:
            pass

    # -- entry API ------------------------------------------------------------
    def contains(self, name: str) -> bool:
        """A presence probe (no accounting, no touch: planning passes)."""
        return self.breaker.state != "open" and name in self._index

    def put(self, name: str, arrays) -> bool:
        """Spill ``arrays`` under ``name``: frame them, write a temporary
        file, flush and fsync it, rename it into place. False, never an
        exception, when the budget, the breaker, an injected ``disk_full``
        or a real OSError refuses it."""
        if not self.breaker.allow():
            self.stats.rejections += 1
            return False
        if name in self._index:
            self._index.move_to_end(name)
            self.stats.dedup_hits += 1
            self.breaker.record_success()
            return True
        frame = encode_entry(arrays)
        if self.faults is not None and self.faults.fire("disk_full"):
            self.stats.rejections += 1
            self.breaker.record_failure()      # an injected ENOSPC
            return False
        if not self._evict_for(len(frame)):
            self.stats.rejections += 1
            return False
        torn = (self.faults is not None
                and self.faults.fire("disk_torn_write"))
        path = os.path.join(self.root, name)
        tmp = path + ".tmp"
        try:
            with open(tmp, "wb") as f:
                # a torn write is a crash mid-frame that still reached the
                # final name: half the frame, which the crc check of the
                # next get (this process's or a restarted one's) rejects
                f.write(frame[:len(frame) // 2] if torn else frame)
                f.flush()
                os.fsync(f.fileno())
            kill_point("mid_spill")
            os.rename(tmp, path)
        except OSError:
            self.stats.rejections += 1
            try:
                os.unlink(tmp)
            except OSError:
                pass
            self.breaker.record_failure()
            return False
        size = len(frame) // 2 if torn else len(frame)
        self._index[name] = size
        self.bytes_resident += size
        self.stats.puts += 1
        self.stats.bytes_written += size
        self.breaker.record_success()
        return True

    def get(self, name: str) -> Optional[list]:
        """A verified read. A frame that fails its crc is deleted, counted
        and answered as a miss; repeated failures trip the breaker, so a
        rotting disk stops being read."""
        if not self.breaker.allow():
            self.stats.misses += 1
            return None
        if name not in self._index:
            self.stats.misses += 1
            return None
        if self.faults is not None and self.faults.fire("disk_slow"):
            time.sleep(0.002)            # a degraded device: latency only
        try:
            with open(os.path.join(self.root, name), "rb") as f:
                buf = f.read()
        except OSError:
            self._forget(name)
            self.stats.misses += 1
            self.breaker.record_failure()
            return None
        arrays = decode_entry(buf)
        if arrays is None:
            self._forget(name)
            self.stats.checksum_failures += 1
            self.stats.misses += 1
            self.breaker.record_failure()
            return None
        self._index.move_to_end(name)
        self.stats.hits += 1
        self.breaker.record_success()
        return arrays

    def drop(self, name: str) -> bool:
        """Remove an entry outright; never gated by the breaker (hygiene
        runs while it is tripped, as the arena's ``drop`` does)."""
        if name not in self._index:
            return False
        self._forget(name)
        return True

    def names(self) -> list:
        """Every entry's name, oldest touch first."""
        return list(self._index)

    def __len__(self) -> int:
        return len(self._index)

    def stats_export(self) -> dict:
        out = {
            "disk_puts": self.stats.puts,
            "disk_dedup_hits": self.stats.dedup_hits,
            "disk_hits": self.stats.hits,
            "disk_misses": self.stats.misses,
            "disk_evictions": self.stats.evictions,
            "disk_rejections": self.stats.rejections,
            "disk_checksum_failures": self.stats.checksum_failures,
            "disk_orphans_swept": self.stats.orphans_swept,
            "disk_bytes_written": self.stats.bytes_written,
            "disk_bytes_resident": self.bytes_resident,
            "disk_bytes_capacity": self.capacity_bytes,
            "disk_entries": len(self._index),
        }
        out.update(self.breaker.stats_export(prefix="disk"))
        return out
