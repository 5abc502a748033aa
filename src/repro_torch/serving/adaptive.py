"""Acceptance-driven adaptive speculation window, copied from the
reference's ``serving/adaptive.py``.

Each round costs one model pass over W positions and yields ``a in
[1, W]`` accepted tokens. The controller tracks an EWMA of the mean accept
length per host sync and proposes ``W = clip(round(headroom * ewma), 1,
w_max)`` on the power-of-two grid (plus ``w_max``), adopted once the same
proposal repeats ``patience`` syncs. Exactness is indifferent to W —
candidates gate only acceptance, never token values.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np


def _pow2_at_most(x: int) -> int:
    p = 1
    while p * 2 <= x:
        p *= 2
    return p


@dataclass
class AdaptiveWindowController:
    w_max: int = 16
    w_init: int = 0              # 0 -> start at w_max (optimistic)
    alpha: float = 0.3           # EWMA weight of the newest observation
    headroom: float = 1.7        # W targets headroom * expected accept
    patience: int = 2            # syncs a proposal must persist
    enabled: bool = True
    history_cap: int = 4096      # telemetry ring bound

    def __post_init__(self):
        assert self.w_max >= 1
        assert self.history_cap >= 1
        if self.w_init <= 0:
            self._w = self.w_max
        else:
            w = min(self.w_init, self.w_max)
            self._w = w if w == self.w_max else _pow2_at_most(w)
        self._ewma = float(self._w)
        self._pending = self._w
        self._streak = 0
        self.history: deque[int] = deque(maxlen=self.history_cap)

    @property
    def window(self) -> int:
        return self._w

    @property
    def ewma_accept(self) -> float:
        return self._ewma

    def observe_aggregate(self, accepted_total: float,
                          active_row_rounds: int) -> int:
        """Feed one loop's totals: tokens accepted and (row, round) pairs
        active. Returns the window to use for the next loop."""
        self.history.append(self._w)
        if not self.enabled or active_row_rounds <= 0:
            return self._w
        mean = float(accepted_total) / float(active_row_rounds)
        self._ewma += self.alpha * (mean - self._ewma)
        want = int(np.clip(round(self.headroom * self._ewma), 1, self.w_max))
        prop = _pow2_at_most(want)
        if want > prop:
            prop = min(prop * 2, self.w_max)
        if prop == self._pending:
            self._streak += 1
        else:
            self._pending, self._streak = prop, 1
        if self._streak >= self.patience and prop != self._w:
            self._w = prop
        return self._w
