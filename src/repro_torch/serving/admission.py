"""Request admission: priority/deadline/FCFS queueing for the serving
engine, copied from the reference's ``serving/admission.py``.

The queue orders by ``(priority, deadline, arrival_seq)`` — lower priority
value first; within a class, earliest absolute deadline first, requests
without a deadline last and FIFO among themselves — and the engine admits a
request only when it has a free batch slot and enough physical blocks for
its prompt plus its full generation target (run-to-completion admission).
``lookahead(k)`` exposes the first ``k`` requests so a small fitting
request behind an oversized head can admit; every such bypass ages the
head (``Request.bypassed``). A request retried after a fault goes back in
at its original rank (``requeue``). ``RequestError`` lives in
``serving/faults.py`` and is re-exported here.

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

__all__ = ["AdmissionQueue", "Request", "RequestError", "pow2_at_most",
           "prefill_chunks"]


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
    bypassed: int = 0            # admissions that jumped this request while
    #                              it sat at the queue head (aging signal)
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


class AdmissionQueue:
    """Priority + earliest-deadline + FCFS admission queue with bounded
    lookahead."""

    def __init__(self):
        self._heap: list = []
        self._seq = itertools.count()

    def _entry(self, req: Request):
        if req._seq is None:               # arrival order pinned once
            req._seq = next(self._seq)
        return (req.priority, req.deadline_time, req._seq, req)

    def push(self, req: Request):
        req.submit_time = time.monotonic()
        heapq.heappush(self._heap, self._entry(req))

    def requeue(self, req: Request):
        """Re-insert a request that was admitted before (a retry after a
        fault): its submit time and arrival order are kept, so it ranks
        where its first submission did."""
        heapq.heappush(self._heap, self._entry(req))

    def pop(self) -> Request:
        return heapq.heappop(self._heap)[-1]

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

    def requests(self) -> list[Request]:
        """Every queued request, in no particular order."""
        return [e[-1] for e in self._heap]

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)
