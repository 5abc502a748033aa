"""Write-ahead request journal — the port's own copy of the reference's
``serving/journal.py`` (its DESIGN.md §16), byte for byte in its frames.

An append-only log of request lifecycle transitions (submit, admit, park,
retry, finish, cancel, fail), so a restarted engine knows which requests
were accepted and which of them reached a terminal state. It records
identity, intent and outcomes, never device tensors: a ``submit`` carries
the whole prompt and the sampling identity (uid, noise seed, priority,
deadline), which regenerates the same tokens from scratch because the
engine's output is a function of context and noise; cached state only
makes that cheaper. A ``finish`` carries the delivered token ids, so the
journal is the durable delivery channel: a crash between journaling a
finish and the client reading it re-delivers the same tokens on restore.

Frame of one record::

    u32 len(payload) | u32 crc32(payload) | payload (JSON, utf-8)

the payload ``json.dumps(record, separators=(",", ":"), sort_keys=True)``,
so the same records give the reference's bytes.

Fsync: ``append`` buffers; every ``fsync_every`` records, and at every
``sync()`` (the engine calls it at each host sync), the file is flushed
and fsynced. With ``fsync_every=1`` (the default) an accepted submit is on
media before ``submit()`` returns. Larger values batch the fsync; at most
``fsync_every - 1`` records past the last sync are then exposed.

Replay reads records in order; the first frame whose length runs past the
end of the file or whose crc fails is a torn tail from a crash mid-append.
Replay stops there and truncates the file to the last good frame (it never
errors and never returns partial bytes), so the journal is well formed for
appending again. The ``journal_truncate`` fault seam simulates that crash
by tearing off the last good record before parsing.
"""
from __future__ import annotations

import json
import os
import struct
import zlib

from repro_torch.serving.faults import kill_point

_FRAME = struct.Struct("<II")            # payload length, crc32(payload)

# Record types. Only ``submit`` carries enough to recreate a Request; the
# rest name it by uid.
TYPES = ("submit", "admit", "park", "retry", "finish", "cancel", "fail")
TERMINAL = frozenset(("finish", "cancel", "fail"))


def _encode(rec: dict) -> bytes:
    payload = json.dumps(rec, separators=(",", ":"),
                         sort_keys=True).encode()
    return _FRAME.pack(len(payload), zlib.crc32(payload)) + payload


class RequestJournal:
    """Crc-framed append-only log with batched fsync and torn-tail repair."""

    def __init__(self, path: str, fsync_every: int = 1, *, faults=None):
        if fsync_every < 1:
            raise ValueError(f"fsync_every={fsync_every}")
        self.path = path
        self.fsync_every = int(fsync_every)
        self.faults = faults
        self.appends = 0             # records appended by this process
        self.syncs = 0               # fsyncs issued
        self._unsynced = 0
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # repair a torn tail before opening for append, so new records
        # start on a frame boundary, not on half a dead frame
        if os.path.exists(path):
            self.replay(path)
        self._f = open(path, "ab")

    # -- writing --------------------------------------------------------------
    def append(self, type: str, **fields) -> None:
        """Buffer one record; fsync every ``fsync_every`` appends."""
        if type not in TYPES:
            raise ValueError(f"unknown record type {type!r}")
        self._f.write(_encode({"type": type, **fields}))
        self.appends += 1
        self._unsynced += 1
        if self._unsynced >= self.fsync_every:
            self.sync()

    def sync(self) -> None:
        """Flush and fsync. The ``pre_fsync`` kill point sits between the
        two: a process killed there has handed its records to the OS (a
        SIGKILL loses no flushed data, only a power cut does, and the
        torn-tail replay covers that) but not forced them to media."""
        if self._f.closed:
            return
        self._f.flush()
        kill_point("pre_fsync")
        os.fsync(self._f.fileno())
        self.syncs += 1
        self._unsynced = 0

    def close(self) -> None:
        if not self._f.closed:
            self.sync()
            self._f.close()

    def stats_export(self) -> dict:
        return {"journal_appends": self.appends,
                "journal_syncs": self.syncs,
                "journal_unsynced": self._unsynced}

    # -- replay ---------------------------------------------------------------
    @classmethod
    def replay(cls, path: str, *, faults=None) -> list:
        """Every intact record, in append order ([] for a missing or empty
        journal); the file is truncated at the first torn frame."""
        try:
            with open(path, "rb") as f:
                buf = f.read()
        except OSError:
            return []
        records, offsets, off = [], [], 0
        while off + _FRAME.size <= len(buf):
            plen, crc = _FRAME.unpack_from(buf, off)
            start = off + _FRAME.size
            payload = buf[start:start + plen]
            if len(payload) != plen or zlib.crc32(payload) != crc:
                break                            # torn tail
            try:
                rec = json.loads(payload)
            except ValueError:
                break
            records.append(rec)
            off = start + plen
            offsets.append(off)
        if faults is not None and faults.fire("journal_truncate") and records:
            records.pop()                        # the tail a crash tore off
            offsets.pop()
            off = offsets[-1] if offsets else 0
        if off < len(buf):
            try:
                with open(path, "r+b") as f:
                    f.truncate(off)
            except OSError:
                pass
        return records

    @staticmethod
    def pending(records) -> "tuple[dict, dict, dict]":
        """Fold replayed records into what a restore needs:
        ``(pending, parked, delivered)``.

        ``pending`` maps the uid of every accepted request without a
        terminal record to its submit record, with later ``retry`` fields
        (noise_seed, retries) folded in and ``admitted``/``parked`` flags;
        ``parked`` maps a pending uid to its last park record (the
        checkpoint may hold its snapshot); ``delivered`` maps a uid to its
        submit record with the terminal outcome folded in (``terminal``,
        and the finish's ``tokens`` or the failure's ``code``). A terminal
        record commits the result, not its pickup, so a restore delivers
        every journaled outcome again (at least once; a re-delivery is
        bitwise the first, so a client dedups by uid)."""
        pending: dict = {}
        parked: dict = {}
        delivered: dict = {}
        for rec in records:
            uid = rec.get("uid")
            t = rec.get("type")
            if t == "submit":
                pending[uid] = dict(rec, admitted=False, parked=False)
            elif uid not in pending:
                continue                 # terminal already, or unknown uid
            elif t in TERMINAL:
                delivered[uid] = dict(pending.pop(uid), terminal=t,
                                      **{k: rec[k] for k in
                                         ("tokens", "code") if k in rec})
                parked.pop(uid, None)
            elif t == "admit":
                pending[uid]["admitted"] = True
                pending[uid]["parked"] = False
                parked.pop(uid, None)
            elif t == "park":
                pending[uid]["parked"] = True
                parked[uid] = rec
            elif t == "retry":
                pending[uid]["noise_seed"] = rec.get(
                    "noise_seed", pending[uid].get("noise_seed"))
                pending[uid]["retries"] = rec.get(
                    "retries", pending[uid].get("retries", 0))
                pending[uid]["admitted"] = False
        return pending, parked, delivered
