"""Serving telemetry: per-request and engine-level counters as plain dicts,
copied from the reference's ``serving/metrics.py`` (the counters of the
serving layers this slice has). The engine updates them from values it
already pulls to the host once per sync, so telemetry adds no device
round-trips."""
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
    head_bypass_admissions: int = 0      # lookahead admissions past the head
    requests_failed: int = 0             # finished with a RequestError
    requests_rejected: int = 0           # submit-time validation rejections
    requests_cancelled: int = 0          # requests cancelled via cancel(uid)
    retries: int = 0                     # failed requests re-admitted

    def _per_token(self, value: float) -> float:
        return value / self.tokens_generated if self.tokens_generated else 0.0

    def observe_loop(self, window: int, rounds: int, active_row_rounds: int,
                     batch: int, accepted: int):
        """One round loop (one dispatch, one host sync) covering ``rounds``
        verify rounds."""
        self.rounds += int(rounds)
        self.host_syncs += 1
        self.device_dispatches += 1
        self.window_hist.append(int(window))
        self.active_row_rounds += int(active_row_rounds)
        denom = max(1, int(rounds)) * batch
        self.row_rounds += denom
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

    def export(self, block_stats: dict | None = None) -> dict:
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
            "head_bypass_admissions": self.head_bypass_admissions,
            "requests_failed": self.requests_failed,
            "requests_rejected": self.requests_rejected,
            "requests_cancelled": self.requests_cancelled,
            "retries": self.retries,
        }
        if block_stats:
            out.update(block_stats)
        return out
