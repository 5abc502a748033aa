"""Fault model of the serving engine: structured request errors, a
deterministic fault-injection plan, and the host tier's circuit breaker —
the port's own copy of the reference's ``serving/faults.py`` (DESIGN.md
§14).

The engine fails per request, never per process: every failure it can
survive is routed through a ``RequestError`` attached to the offending
``Request``, and the rest of the batch stays bitwise what it would have
been. ``FaultPlan`` scripts faults at named seams so each of those paths
can be tested:

==================  =====================================================
seam                fires inside
==================  =====================================================
``alloc``           ``BlockManager.alloc``: a MemoryError before it takes
                    a block (admission and capacity-growth faults)
``arena_put``       ``HostArena.put``: the put is refused, as if the host
                    allocation failed (the caller keeps or drops the data)
``arena_corrupt``   ``HostArena.get``: one stored byte is flipped before
                    the integrity check, which demotes the get to a miss
``stage_drop``      ``StagingRing.stage``: a ``StagingFault``, as a failed
                    upload; the engine clears the ring and prefills instead
``disk_full``       ``DiskTier.put``: the spill write is refused as if
                    the filesystem returned ENOSPC (a breaker failure)
``disk_torn_write`` ``DiskTier.put``: the frame is written truncated (a
                    crash mid-write; the crc verify at the read catches it)
``disk_slow``       ``DiskTier.get``: a short fixed stall (a degraded
                    device; latency only, never an error)
``journal_truncate`` ``RequestJournal.replay``: the journal's last record
                    is torn off before parsing (a crash mid-append; the
                    replay truncates the file, it never errors)
==================  =====================================================

Every seam is parsed and fires where the reference's plan of the same spec
fires, so one plan drives both packages. Preemption and staged adoption
have no seam of their own: a parked resume and a staged entry allocate
through ``alloc``. Besides, ``poison_streams`` names noise streams whose
verify-round logits the engine replaces with NaN on the device, which
trips the quarantine health bit end to end. Apart from the plan,
``kill_point`` SIGKILLs the process at a named site (``KILL_POINTS``,
armed by ``REPRO_KILL_POINT``), for the crash and restore tests.

Every seam keeps an invocation counter; a fault fires at scripted
invocation indices (``alloc=@2;5``: the 3rd and 6th calls) or at a seeded
rate (``arena_corrupt=0.05``) decided by a counter-keyed hash, never by
``random`` or the clock, so a plan replays identically across runs and
processes, and fires where the reference's plan of the same spec fires.
"""
from __future__ import annotations

import os
import signal
import sys
import zlib
from dataclasses import dataclass
from typing import Optional

SEAMS = ("alloc", "arena_put", "arena_corrupt", "stage_drop",
         "disk_full", "disk_torn_write", "disk_slow", "journal_truncate")

# -- kill points (the crash harness) -------------------------------------------
# Named host-side sites at which a recovery test SIGKILLs a serving process:
# ``REPRO_KILL_POINT=<point>`` dies at the first hit of that site,
# ``<point>:<i>`` at the (i+1)-th. A SIGKILL, not an exception: no finally
# block, no atexit, no buffered write runs, which is the state a power cut
# leaves and what checkpoint and restore must recover from. Hits are counted
# per process; the variable is read at every hit, so a test can arm and
# disarm a point without importing anything again.
KILL_POINTS = ("post_admit", "mid_spill", "pre_fsync", "post_sync")
_kill_hits: dict[str, int] = {}


def kill_point(name: str) -> None:
    """Die here (SIGKILL) iff ``REPRO_KILL_POINT`` names this site."""
    spec = os.environ.get("REPRO_KILL_POINT", "")
    if not spec:
        return
    point, _, idx = spec.partition(":")
    if point != name:
        return
    i = _kill_hits.get(name, 0)
    _kill_hits[name] = i + 1
    if i == (int(idx) if idx else 0):
        sys.stdout.flush()       # what was delivered stays delivered
        sys.stderr.flush()
        os.kill(os.getpid(), signal.SIGKILL)


@dataclass
class RequestError:
    """Structured failure attached to ``Request.error`` (result stays None).

    ``code`` is machine-readable: submit-time rejections (``empty_prompt``,
    ``bad_new_tokens``, ``too_long``, ``token_out_of_range``,
    ``over_capacity``), quarantine verdicts (``nonfinite``, ``stuck``),
    host-side faults (``admission``, ``capacity``), runaway aborts
    (``timeout``, ``round_budget``) and ``cancelled``."""
    code: str
    detail: str = ""
    retryable: bool = False
    attempts: int = 1            # admission attempts consumed (retries + 1)

    def __str__(self):
        return f"{self.code}({self.detail})" if self.detail else self.code


class StagingFault(RuntimeError):
    """An injected (or real) failure of a host-to-device staging copy."""


class FaultPlan:
    """Deterministic per-seam fault schedule (see the module docstring).

    ``schedule`` maps a seam to explicit 0-based invocation indices;
    ``rates`` maps a seam to a per-invocation firing probability decided by
    ``crc32(seed:seam:index)``. ``fire(seam)`` is the one entry point every
    instrumented seam calls."""

    def __init__(self, schedule: Optional[dict] = None,
                 rates: Optional[dict] = None, seed: int = 0,
                 poison_streams=()):
        self.schedule = {k: frozenset(int(i) for i in v)
                         for k, v in (schedule or {}).items()}
        self.rates = {k: float(v) for k, v in (rates or {}).items()}
        self.seed = int(seed)
        self.poison_streams = frozenset(int(s) for s in poison_streams)
        self.calls: dict[str, int] = {}      # invocations seen per seam
        self.fired: dict[str, int] = {}      # faults injected per seam

    def fire(self, seam: str) -> bool:
        """Advance ``seam``'s invocation counter; True iff a fault fires."""
        i = self.calls.get(seam, 0)
        self.calls[seam] = i + 1
        hit = i in self.schedule.get(seam, ())
        rate = self.rates.get(seam, 0.0)
        if not hit and rate > 0.0:
            h = zlib.crc32(f"{self.seed}:{seam}:{i}".encode())
            hit = (h & 0xFFFFFFFF) / 2.0 ** 32 < rate
        if hit:
            self.fired[seam] = self.fired.get(seam, 0) + 1
        return hit

    @property
    def total_fired(self) -> int:
        return sum(self.fired.values())

    def fired_export(self) -> dict:
        """Injected-fault counts by seam, one ``faults_fired_<seam>`` entry
        for every known seam (zero where none fired)."""
        return {f"faults_fired_{seam}": self.fired.get(seam, 0)
                for seam in SEAMS}

    @classmethod
    def parse(cls, spec: str) -> Optional["FaultPlan"]:
        """``"seed=7,alloc=@2;5,arena_corrupt=0.05,poison=3;9"``: comma-
        separated fields; ``@`` values are explicit invocation indices
        (``;``-separated), bare floats are rates, ``poison`` lists noise-
        stream ids, ``seed`` keys the rate hash. Empty or None: no plan."""
        if not spec or not spec.strip():
            return None
        schedule, rates, seed, poison = {}, {}, 0, ()
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            k, _, v = part.partition("=")
            k, v = k.strip(), v.strip()
            if k == "seed":
                seed = int(v)
            elif k == "poison":
                poison = tuple(int(s) for s in v.split(";") if s)
            elif v.startswith("@"):
                schedule[k] = tuple(int(s) for s in v[1:].split(";") if s)
            else:
                rates[k] = float(v)
        for k in list(schedule) + list(rates):
            if k not in SEAMS:
                raise ValueError(f"unknown fault seam {k!r} (have {SEAMS})")
        return cls(schedule=schedule, rates=rates, seed=seed,
                   poison_streams=poison)

    @classmethod
    def from_env(cls, var: str = "REPRO_FAULT_PLAN") -> Optional["FaultPlan"]:
        return cls.parse(os.environ.get(var, ""))

    def __repr__(self):
        return (f"FaultPlan(schedule={dict(self.schedule)}, "
                f"rates={self.rates}, seed={self.seed}, "
                f"poison={sorted(self.poison_streams)}, "
                f"fired={self.fired})")


@dataclass
class CircuitBreaker:
    """Count-based closed / open / half-open breaker for a cache tier.

    Deterministic (it counts operations, not wall time): ``threshold``
    consecutive failures trip it open; while open every ``allow()`` is
    denied and counts toward ``cooldown``; the first ``allow()`` past the
    cooldown is the half-open probe, whose success closes it again and
    whose failure opens it again. A tripped tier answers as a miss, never
    as an error."""
    threshold: int = 3
    cooldown: int = 32
    state: str = "closed"        # "closed" | "open" | "half_open"
    failures: int = 0            # consecutive failures while closed
    trips: int = 0               # times the breaker opened
    denied: int = 0              # operations refused while open
    _cooldown_left: int = 0

    def allow(self) -> bool:
        if self.state == "open":
            self._cooldown_left -= 1
            if self._cooldown_left > 0:
                self.denied += 1
                return False
            self.state = "half_open"     # this operation is the probe
        return True

    def record_success(self):
        if self.state == "half_open":
            self.state = "closed"
        self.failures = 0

    def record_failure(self):
        self.failures += 1
        if (self.state == "half_open"
                or (self.state == "closed"
                    and self.failures >= self.threshold)):
            self.state = "open"
            self.trips += 1
            self._cooldown_left = self.cooldown
            self.failures = 0

    def stats_export(self, prefix: str = "tier") -> dict:
        """The breaker's state and its trip and denial counts, under the
        reference's names (``tier_*`` for the host arena, ``disk_*`` for
        the disk tier)."""
        return {f"{prefix}_state": self.state,
                f"{prefix}_tripped": self.trips,
                f"{prefix}_denied_ops": self.denied}
