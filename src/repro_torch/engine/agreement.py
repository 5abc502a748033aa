"""Token agreement under the margin rule, shared by the CPU parity tests and
``chip_smoke.py``.

Two runs that sample with the same noise give the same tokens wherever the
arithmetic agrees. Across frameworks, or between a kernel and its plain
version, the logits agree only within a float tolerance, so a stream may
split where the reference's two best candidates were nearly tied. The
rule: the streams must be equal up to their first difference, and at that
position the reference's top-2 margin of ``logits + eps`` must be below
the stated tolerance. Token ``p`` is ``argmax(logits(p - 1) + eps(p))``,
where ``logits(p - 1)`` is the model's output at input position ``p - 1``.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np


def top2_margin(scores) -> float:
    """Gap between the largest and second-largest value of a 1-D array."""
    s = np.sort(np.asarray(scores, np.float64))
    return float(s[-1] - s[-2])


def check_token_agreement(ref, got, margin_at: Callable[[int], float],
                          tol: float, start: int = 0) -> Optional[dict]:
    """``ref`` and ``got``: 1-D token arrays of one request (prompt plus
    generated). Returns None when they are equal from ``start`` on, else
    ``{"position": p, "margin": m}`` for the first difference, whose
    reference margin ``margin_at(p)`` was below ``tol``. Raises
    AssertionError when the lengths differ or the margin is not below
    ``tol``."""
    ref, got = np.asarray(ref), np.asarray(got)
    if ref.shape != got.shape:
        raise AssertionError(f"lengths differ: {ref.shape} vs {got.shape}")
    diff = np.nonzero(ref[start:] != got[start:])[0]
    if diff.size == 0:
        return None
    p = int(diff[0]) + start
    m = float(margin_at(p))
    if not m < tol:
        raise AssertionError(
            f"streams differ at position {p} (ref {int(ref[p])}, got "
            f"{int(got[p])}) where the reference's top-2 margin {m:.3g} is "
            f"not below the tolerance {tol:.3g}")
    return {"position": p, "margin": m}
