"""Asynchronous host-to-device staging ring for host-tier re-admission —
the reference's ``serving/hostcache/staging.py`` redesigned for CUDA.

The reference relies on an asynchronous ``device_put`` and asks each array
whether it has landed. Here one side ``torch.cuda.Stream`` carries the
uploads: each ``stage`` allocates the device tensors on that stream,
issues ``copy_(..., non_blocking=True)`` from the (pinned) host tensors
and records a ``torch.cuda.Event``. ``take`` makes the current stream wait
on that event and ``record_stream``s the tensors onto it, so the consumer's
merges are ordered after the copy without the host blocking. The host
blocks only when ``depth`` uploads are in flight.

An upload counts as *overlapped* when, at issue time, the previous one had
not landed (its event not yet complete): the copy engine was busy and this
upload queued behind it instead of the host waiting. ``h2d_overlap_frac``
is their share.

Sources: a copy in flight reads its host tensors, so the ring holds them
until its event completes, through ``clear`` too, and ``wait_reads(buf)``
blocks until no copy in flight reads ``buf``: the host arena calls it
before it writes a recycled slab buffer, so a recycle never rewrites the
bytes of an upload still in flight.

With ``device="cpu"`` (the tests) the copies are synchronous clones, and
nothing ever counts as overlapped.
"""
from __future__ import annotations

from collections import deque

import torch

from repro_torch.serving.faults import StagingFault


class StagingRing:
    """Depth-bounded host-to-device upload ring.

    ``faults`` wires the ``stage_drop`` seam: an injected fault raises
    ``StagingFault`` from ``stage`` as a failed upload would. A caller that
    aborts mid-run must ``clear()``, so the next caller cannot take a
    previous admission's half-staged blocks."""

    def __init__(self, depth: int = 2, faults=None, *, device):
        if depth < 1:
            raise ValueError(f"depth={depth}")
        self.depth = depth
        self.faults = faults
        self.device = torch.device(device)
        self._stream = None                  # the copy stream, made at first use
        self._ring: deque = deque()          # in flight: (tag, tensors, event)
        self._landed: deque = deque()        # waited for, awaiting take()
        self._holds: list = []               # (event, sources) not yet landed
        self.staged = 0                      # uploads issued
        self.staged_bytes = 0
        self.overlapped = 0                  # issued while the last was busy
        self.dropped = 0                     # uploads discarded by clear()
        self._last = None                    # the last upload's event

    def _busy(self) -> bool:
        return self._last is not None and not self._last.query()

    def _copy_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        return self._stream

    def stage(self, tag, tensors) -> None:
        """Issue the uploads of ``tensors`` (host tensors) under ``tag``.
        Blocks only while ``depth`` uploads are in flight; the one it waits
        for moves to the landed queue, never dropped."""
        if self.faults is not None and self.faults.fire("stage_drop"):
            raise StagingFault(f"injected staging drop at {tag!r}")
        while len(self._ring) >= self.depth:
            self._landed.append(self._drain_one())
        self.staged += 1
        self.staged_bytes += int(sum(t.numel() * t.element_size()
                                     for t in tensors))
        if self.device.type != "cuda":
            self._ring.append((tag, [t.clone() for t in tensors], None))
            return
        if self._busy():
            self.overlapped += 1
        stream = self._copy_stream()
        with torch.cuda.stream(stream):
            devs = [torch.empty(t.shape, dtype=t.dtype, device=self.device)
                    for t in tensors]
            for d, t in zip(devs, tensors):
                d.copy_(t, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        self._last = event
        self._holds = [h for h in self._holds if not h[0].query()]
        self._holds.append((event, list(tensors)))
        self._ring.append((tag, devs, event))

    def _drain_one(self):
        item = self._ring.popleft()
        if item[2] is not None:
            item[2].synchronize()
        return item

    def take(self):
        """Pop the oldest upload as ``(tag, [device tensors])``, ordered
        before the current stream's later work (no host wait unless it is
        the depth bound). None when nothing is staged."""
        if self._landed:
            tag, devs, event = self._landed.popleft()
        elif self._ring:
            tag, devs, event = self._ring.popleft()
        else:
            return None
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for d in devs:
                d.record_stream(current)
        return tag, devs

    def wait_reads(self, buf: torch.Tensor) -> None:
        """Block until no upload in flight reads host tensor ``buf``."""
        ptr = buf.data_ptr()
        for event, sources in self._holds:
            if any(s.data_ptr() == ptr for s in sources):
                event.synchronize()
        self._holds = [h for h in self._holds if not h[0].query()]

    def clear(self) -> int:
        """Discard every in-flight and landed upload (a run that died
        mid-ring). Their sources stay held until their copies land.
        Returns the number of uploads dropped."""
        n = len(self)
        self._ring.clear()
        self._landed.clear()
        self._last = None
        self.dropped += n
        return n

    def __len__(self) -> int:
        return len(self._ring) + len(self._landed)

    def stats_export(self) -> dict:
        frac = self.overlapped / self.staged if self.staged else 0.0
        return {
            "h2d_staged": self.staged,
            "h2d_staged_bytes": self.staged_bytes,
            "h2d_overlapped": self.overlapped,
            "h2d_overlap_frac": frac,
            "h2d_dropped": self.dropped,
        }
