"""The workload and engine settings of the port's kill-point crash tests
(not a test file: ``torch_tp_driver.py durable`` runs the kill matrix on
them, ``test_torch_recovery.py`` holds the results).

The port's counterpart of ``tests/serving/recovery_driver.py``: the same
workload and engine settings on reduced qwen3-1.7b (float32, the port's
random weights from seed 0, noise key 9), run through
``chip_smoke.recovery_child``, the loop that phase 20 (c) runs on the
card.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402

from repro_torch.serving.admission import Request  # noqa: E402

EPS_SEED = 9
ENGINE_KW = dict(batch=1, window_max=4, max_len=64, block_size=4,
                 adaptive=False, preempt_floor=1.0)
METRIC_KEYS = ("requests_finished", "prefill_calls", "preemptions",
               "recovered_requests", "recovered_parked",
               "checkpoints_written", "disk_spills", "disk_hits",
               "disk_promotes", "journal_appends", "journal_syncs",
               "resume_recomputes")


def make_requests(cfg, cls=Request):
    """One long priority-5 request, parked by three priority-0 arrivals."""
    rng = np.random.default_rng(5)
    low = cls(uid=0, prompt=rng.integers(0, cfg.vocab, size=24),
              new_tokens=10, priority=5)
    high = [cls(uid=1 + i, prompt=rng.integers(0, cfg.vocab, size=6),
                new_tokens=6, priority=0)
            for i in range(3)]
    return [low] + high
