"""Child process of the port's kill-point crash tests (not a test file:
``test_torch_recovery.py`` runs it as a subprocess).

The port's counterpart of ``tests/serving/recovery_driver.py``: the same
workload and engine settings on reduced qwen3-1.7b (float32, the port's
random weights from seed 0, noise key 9), on the CPU and one torch thread,
through ``chip_smoke.recovery_child``, the loop that phase 20 (c) runs on
the card. A test arms one ``REPRO_KILL_POINT`` site in the child's
environment and checks that the child died by SIGKILL; a second child over
the same durable directory restores and finishes the work. Every line
printed is a flushed JSON event (``submitted``, ``finish``, ``recovered``,
``metrics``), so what reached stdout before a kill is what the dead process
had delivered to its client.

Usage: ``python torch_recovery_driver.py {serve,resume} DIR``
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import recovery_child  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.transformer import TransformerLM  # noqa: E402
from repro_torch.serving.admission import Request  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

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


def main():
    torch.set_num_threads(1)
    mode, ddir = sys.argv[1:3]
    cfg = get_config("qwen3-1.7b", reduced=True)
    params = TransformerLM.init(cfg, seed=0, device="cpu")
    reqs = make_requests(cfg)
    recovery_child(
        lambda: ServingEngine(cfg, params, eps_key=EPS_SEED, device="cpu",
                              durable_dir=ddir, journal_fsync_every=1,
                              **ENGINE_KW),
        mode, reqs[:1], reqs[1:], METRIC_KEYS)


if __name__ == "__main__":
    main()
