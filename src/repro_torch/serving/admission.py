"""Request admission: priority/deadline/FCFS queueing for the serving
engine, copied from the reference's ``serving/admission.py``.

The queue orders by ``(priority, deadline, arrival_seq)`` — lower priority
value first; within a class, earliest absolute deadline first, requests
without a deadline last and FIFO among themselves — and the engine admits a
request only when it has a free batch slot and enough physical blocks for
its prompt plus its full generation target (run-to-completion admission).
``lookahead(k)`` exposes the first ``k`` requests so a small fitting
request behind an oversized head can admit; every such bypass ages the
head (``Request.bypassed``). A request retried after a fault, or parked by
a higher-priority arrival, goes back in at its original rank (``requeue``),
its submit time kept. ``RequestError`` lives in ``serving/faults.py`` and
is re-exported here.

``StagedEntry`` and ``pack_staged_descriptors`` are staged adoption's host
half: a queued request pre-staged into spare blocks while every slot is
busy, and the descriptor arrays the round loop adopts from.

Prefill is row-local and chunked: the un-cached tail of an admitted prompt
runs through the paged decode in power-of-two chunks (``prefill_chunks``).
"""
from __future__ import annotations

import heapq
import itertools
import math
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.serving.faults import RequestError

__all__ = ["AdmissionQueue", "Request", "RequestError", "StagedEntry",
           "pack_staged_descriptors", "pow2_at_most", "prefill_chunks"]


@dataclass
class Request:
    uid: int
    prompt: np.ndarray           # (L_p,) int
    new_tokens: int
    priority: int = 0            # lower = sooner (EDF/FCFS within a class)
    deadline: Optional[float] = None   # latency SLO seconds from submit
    noise_seed: Optional[int] = None   # noise-stream id; defaults to uid
    result: Optional[np.ndarray] = None
    error: Optional[RequestError] = None   # structured failure
    retries: int = 0             # re-admissions consumed after failures
    calls_used: int = 0          # verify rounds this request took part in
    prefill_calls: int = 0       # row-local prefill chunks paid at admission
    prefix_hit_blocks: int = 0   # prompt blocks served from the prefix cache
    preemptions: int = 0         # times parked by a higher-priority request
    migrations: int = 0          # times moved to another slot or shard
    bypassed: int = 0            # admissions that jumped this request while
    #                              it sat at the queue head (aging signal)
    queue_deadline_missed: bool = False  # SLO expired while queued/parked
    submit_time: float = 0.0
    admit_time: float = 0.0
    finish_time: float = 0.0
    _seq: Optional[int] = None   # arrival order, pinned at first push

    @property
    def seq_id(self) -> int:
        return self.uid if self.noise_seed is None else self.noise_seed

    @property
    def ok(self) -> bool:
        return self.error is None and self.result is not None

    @property
    def latency(self) -> float:
        return self.finish_time - self.submit_time

    @property
    def queue_wait(self) -> float:
        return self.admit_time - self.submit_time

    @property
    def deadline_time(self) -> float:
        """Absolute SLO expiry (monotonic clock); +inf without a deadline."""
        if self.deadline is None:
            return math.inf
        return self.submit_time + self.deadline

    @property
    def missed_deadline(self) -> bool:
        return self.deadline is not None and self.finish_time > self.deadline_time

    def clock_export(self, now: Optional[float] = None) -> dict:
        """The request's clocks as elapsed durations at ``now``: a
        ``time.monotonic`` stamp means nothing in another process, how long
        the request has waited or run does."""
        if now is None:
            now = time.monotonic()
        return {"elapsed": (now - self.submit_time
                            if self.submit_time else 0.0),
                "admit_elapsed": (now - self.admit_time
                                  if self.admit_time else None)}

    def clock_rebase(self, clocks: dict,
                     now: Optional[float] = None) -> None:
        """The inverse of ``clock_export``: anchor exported durations on
        this process's monotonic clock at ``now``, so deadlines, wall-time
        bounds and latencies go on counting where they stopped."""
        if now is None:
            now = time.monotonic()
        self.submit_time = now - float(clocks.get("elapsed") or 0.0)
        admit = clocks.get("admit_elapsed")
        self.admit_time = (now - float(admit)) if admit is not None else 0.0


def pow2_at_most(x: int) -> int:
    """Largest power of two <= x (x >= 1)."""
    assert x >= 1, x
    p = 1
    while p * 2 <= x:
        p *= 2
    return p


def prefill_chunks(length: int, max_chunk: int = 64) -> list[int]:
    """Greedy power-of-two cover of ``length`` positions (largest first);
    ``max_chunk`` is first rounded down to a power of two, so at most
    ``log2(max_chunk) + 1`` distinct widths occur."""
    out, c = [], pow2_at_most(max(1, max_chunk))
    while length > 0:
        while c > length:
            c //= 2
        out.append(c)
        length -= c
    return out


@dataclass
class StagedEntry:
    """One queued request pre-staged for in-loop adoption: its worst-case
    blocks allocated up front (an adopted row never allocates inside the
    loop), prefix hits covering its first ``n0 - 1`` positions, and the
    fields ``pack_staged_descriptors`` uploads. ``key`` is its queue rank:
    staging commits in queue order, and a higher-ranked arrival unstages
    the area rather than wait behind it."""
    req: Request
    shard: int
    prompt: np.ndarray           # (L_p,) int — the staged row's tokens
    n0: int                      # adoption start: covered positions + 1
    plen: int                    # prompt length (forced-acceptance bound)
    target: int                  # plen + new_tokens
    blocks: list                 # block ids, worst case, table order
    table_row: np.ndarray        # (nb,) int32
    poison: int                  # the poison-mask value of its stream
    key: tuple                   # (priority, deadline_time, _seq)


def pack_staged_descriptors(staged, slots_per_shard: int, nb: int,
                            max_len: int) -> tuple:
    """The eight descriptor arrays of the staged round loop, shard-major
    (``index = shard * S + i``, FIFO within a shard, the order the loop
    adopts them in): ``(valid, tables, tokens, n, target, seq, poison,
    plen)``. Unused descriptors are zero and invalid."""
    S = slots_per_shard
    D = len(staged)
    valid = np.zeros(D * S, np.int32)
    tables = np.zeros((D * S, nb), np.int32)
    tokens = np.zeros((D * S, max_len), np.int32)
    n0 = np.ones(D * S, np.int32)
    target = np.zeros(D * S, np.int32)
    seq = np.zeros(D * S, np.int32)
    poison = np.zeros(D * S, np.int32)
    plen = np.zeros(D * S, np.int32)
    for s, entries in enumerate(staged):
        assert len(entries) <= S, (len(entries), S)
        for i, e in enumerate(entries):
            j = s * S + i
            valid[j] = 1
            tables[j] = e.table_row
            tokens[j, :len(e.prompt)] = e.prompt
            n0[j] = e.n0
            target[j] = e.target
            seq[j] = e.req.seq_id
            poison[j] = e.poison
            plen[j] = e.plen
    return valid, tables, tokens, n0, target, seq, poison, plen


class AdmissionQueue:
    """Priority + earliest-deadline + FCFS admission queue with bounded
    lookahead and requeue at the original rank."""

    def __init__(self):
        self._heap: list = []
        self._seq = itertools.count()

    def _entry(self, req: Request):
        if req._seq is None:               # arrival order pinned once
            req._seq = next(self._seq)
        return (req.priority, req.deadline_time, req._seq, req)

    def push(self, req: Request, now: float):
        """Enqueue ``req``, stamped submitted at ``now`` (the engine's
        clock)."""
        req.submit_time = now
        heapq.heappush(self._heap, self._entry(req))

    def requeue(self, req: Request):
        """Re-insert a request that was admitted before (a retry after a
        fault, a parked or unstaged request): its submit time and arrival
        order are kept, so it ranks where its first submission did."""
        heapq.heappush(self._heap, self._entry(req))

    def pop(self) -> Request:
        return heapq.heappop(self._heap)[-1]

    def peek(self) -> Optional[Request]:
        return self._heap[0][-1] if self._heap else None

    def lookahead(self, k: int) -> list[Request]:
        """The first ``k`` requests in queue order (head first)."""
        return [e[-1] for e in heapq.nsmallest(k, self._heap)]

    def remove(self, req: Request) -> bool:
        """Remove a specific request (a lookahead admission that is not the
        head)."""
        for i, e in enumerate(self._heap):
            if e[-1] is req:
                self._heap[i] = self._heap[-1]
                self._heap.pop()
                heapq.heapify(self._heap)
                return True
        return False

    def advance_seq(self, past: int) -> None:
        """The restore path: restart the arrival counter past the highest
        recovered rank, so requests submitted after a restart rank behind
        every request recovered with its original ``_seq``."""
        self._seq = itertools.count(max(int(past) + 1, 0))

    def requests(self) -> list[Request]:
        """Every queued request, in no particular order."""
        return [e[-1] for e in self._heap]

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)
