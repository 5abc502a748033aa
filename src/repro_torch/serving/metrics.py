"""Serving telemetry: per-request and engine-level counters as plain dicts,
copied from the reference's ``serving/metrics.py`` (the counters of the
serving layers the port has: preemption, staged adoption and the host tier
among them). The engine updates them from values it already pulls to the
host once per sync, so telemetry adds no device round-trips."""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def percentile(values, p: float) -> float:
    """p in [0, 100]; 0.0 on empty input."""
    vals = [v for v in values if v is not None]
    if not vals:
        return 0.0
    return float(np.percentile(np.asarray(vals, np.float64), p))


@dataclass
class EngineMetrics:
    rounds: int = 0                      # batch-level verify rounds (ARM calls)
    verify_passes: int = 0               # model passes of the round loops,
    #                                      no-op rounds after the last live row
    #                                      included
    prefill_calls: int = 0               # row-local prefill chunk passes
    host_syncs: int = 0                  # stats-array pulls (one per loop)
    device_dispatches: int = 0           # round loops launched
    tokens_generated: int = 0
    tokens_accepted_hist: list = field(default_factory=list)  # per-loop sums
    occupancy_hist: list = field(default_factory=list)
    active_row_rounds: int = 0           # (row, round) pairs active, total
    row_rounds: int = 0                  # rounds * batch, total
    window_hist: list = field(default_factory=list)           # W per loop
    requests_finished: int = 0
    request_latencies: list = field(default_factory=list)
    request_queue_waits: list = field(default_factory=list)
    request_calls: list = field(default_factory=list)         # rounds/request
    request_new_tokens: list = field(default_factory=list)
    deadline_miss_count: int = 0
    deadline_requests: int = 0
    deadline_missed_in_queue: int = 0    # SLO expired while queued/parked
    #                                      (seen at the admission poll, once
    #                                      per request)
    preemptions: int = 0                 # slots parked for a higher priority
    resumes: int = 0                     # parked requests re-admitted
    migrations: int = 0                  # live sequences moved to another
    #                                      slot (``migrate_slot``)
    blocks_parked: int = 0               # block payloads pulled to the host
    blocks_migrated: int = 0             # blocks copied across shards
    in_loop_adoptions: int = 0           # staged requests a freed row took
    #                                      inside the round loop (no sync)
    staged_sequences: int = 0            # requests ever staged
    staging_occupancy_hist: list = field(default_factory=list)  # staged/S
    #                                      per loop
    idle_row_rounds: int = 0             # (row, round) pairs a freed row sat
    #                                      idle with the staging area drained
    active_rr_backlog: int = 0           # active_row_rounds and row_rounds
    row_rr_backlog: int = 0              # of the loops launched while work
    #                                      was queued or staged
    head_bypass_admissions: int = 0      # lookahead admissions past the head
    requests_failed: int = 0             # finished with a RequestError
    requests_rejected: int = 0           # submit-time validation rejections
    requests_cancelled: int = 0          # requests cancelled via cancel(uid)
    retries: int = 0                     # failed requests re-admitted
    host_staged_blocks: int = 0          # KV blocks restaged from the host
    #                                      tier (H2D through the ring)
    rec_snapshot_captures: int = 0       # recurrent state rows put into the
    #                                      tier at block boundaries
    rec_snapshot_restores: int = 0       # admissions started from a tier
    #                                      snapshot
    staging_errors: int = 0              # staging runs aborted mid-ring
    recovered_requests: int = 0          # requests re-enqueued from the
    #                                      journal by restore()
    recovered_parked: int = 0            # of those, resumed from a parked
    #                                      snapshot in the checkpoint (the
    #                                      rest prefill from their prompt)
    checkpoints_written: int = 0         # scheduler snapshots fsynced at
    #                                      host syncs (by rank 0 alone on a
    #                                      model axis: 0 on the others)
    resume_recomputes: int = 0           # parked resumes rebuilt by prefill
    #                                      (a piece of the payload was gone)
    prefetch_hits: int = 0               # blocks merged from a queued
    #                                      request's prefetched copies

    def _per_token(self, value: float) -> float:
        return value / self.tokens_generated if self.tokens_generated else 0.0

    def observe_loop(self, window: int, rounds: int, active_row_rounds: int,
                     batch: int, accepted: int, backlog: int = 0):
        """One round loop (one dispatch, one host sync) covering ``rounds``
        verify rounds; ``backlog`` is the work queued or staged when it was
        launched, and a loop with some feeds the under-backlog split."""
        self.rounds += int(rounds)
        self.host_syncs += 1
        self.device_dispatches += 1
        self.window_hist.append(int(window))
        self.active_row_rounds += int(active_row_rounds)
        denom = max(1, int(rounds)) * batch
        self.row_rounds += denom
        if backlog > 0:
            self.active_rr_backlog += int(active_row_rounds)
            self.row_rr_backlog += denom
        self.occupancy_hist.append(active_row_rounds / denom if batch
                                   else 0.0)
        self.tokens_accepted_hist.append(int(accepted))
        self.tokens_generated += int(accepted)

    def observe_finish(self, req):
        self.requests_finished += 1
        self.request_latencies.append(req.latency)
        self.request_queue_waits.append(req.queue_wait)
        self.request_calls.append(req.calls_used)
        self.request_new_tokens.append(req.new_tokens)
        if req.deadline is not None:
            self.deadline_requests += 1
            if req.missed_deadline:
                self.deadline_miss_count += 1

    def export(self, block_stats: dict | None = None,
               host_stats: dict | None = None) -> dict:
        calls = np.asarray(self.request_calls, np.float64)
        new = np.asarray(self.request_new_tokens, np.float64)
        out = {
            "rounds": self.rounds,
            "verify_passes": self.verify_passes,
            "prefill_calls": self.prefill_calls,
            "host_syncs": self.host_syncs,
            "device_dispatches": self.device_dispatches,
            "rounds_per_sync": (self.rounds / self.host_syncs
                                if self.host_syncs else 0.0),
            "host_syncs_per_token": self._per_token(self.host_syncs),
            "rounds_per_token": self._per_token(self.rounds),
            "tokens_generated": self.tokens_generated,
            "requests_finished": self.requests_finished,
            "mean_accept_per_round": (self.tokens_generated / self.rounds
                                      if self.rounds else 0.0),
            "mean_batch_occupancy": (
                float(np.mean(self.occupancy_hist))
                if self.occupancy_hist else 0.0),
            "occupancy_weighted": (self.active_row_rounds / self.row_rounds
                                   if self.row_rounds else 0.0),
            "occupancy_under_backlog": (
                self.active_rr_backlog / self.row_rr_backlog
                if self.row_rr_backlog else 0.0),
            "mean_window": (float(np.mean(self.window_hist))
                            if self.window_hist else 0.0),
            "window_final": self.window_hist[-1] if self.window_hist else 0,
            "arm_calls_per_request_mean": (
                float(calls.mean()) if calls.size else 0.0),
            # < 1.0 means speculation beat ancestral decode
            "arm_calls_vs_ancestral": (
                float((calls / np.maximum(new, 1)).mean())
                if calls.size else 0.0),
            "latency_p50_s": percentile(self.request_latencies, 50),
            "latency_p95_s": percentile(self.request_latencies, 95),
            "queue_wait_p50_s": percentile(self.request_queue_waits, 50),
            "queue_wait_p95_s": percentile(self.request_queue_waits, 95),
            "deadline_miss_count": self.deadline_miss_count,
            "deadline_requests": self.deadline_requests,
            "deadline_missed_in_queue": self.deadline_missed_in_queue,
            "preemptions": self.preemptions,
            "resumes": self.resumes,
            "migrations": self.migrations,
            "blocks_parked": self.blocks_parked,
            "blocks_migrated": self.blocks_migrated,
            "in_loop_adoptions": self.in_loop_adoptions,
            "staged_sequences": self.staged_sequences,
            "staging_occupancy": (
                float(np.mean(self.staging_occupancy_hist))
                if self.staging_occupancy_hist else 0.0),
            "idle_row_rounds": self.idle_row_rounds,
            "head_bypass_admissions": self.head_bypass_admissions,
            "requests_failed": self.requests_failed,
            "requests_rejected": self.requests_rejected,
            "requests_cancelled": self.requests_cancelled,
            "retries": self.retries,
            "host_staged_blocks": self.host_staged_blocks,
            "rec_snapshot_captures": self.rec_snapshot_captures,
            "rec_snapshot_restores": self.rec_snapshot_restores,
            "staging_errors": self.staging_errors,
            "resume_recomputes": self.resume_recomputes,
            "prefetch_hits": self.prefetch_hits,
            "recovered_requests": self.recovered_requests,
            "recovered_parked": self.recovered_parked,
            "checkpoints_written": self.checkpoints_written,
        }
        if block_stats:
            out.update(block_stats)
        if host_stats:
            # the arena's, the staging ring's and the breaker's counters
            out.update(host_stats)
        return out
