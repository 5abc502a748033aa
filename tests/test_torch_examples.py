"""The four torch examples (``examples/*_torch.py``) on the CPU at tiny
step counts: each exits 0 and prints the exactness claim it asserts —
FPI samples bitwise ancestral sampling's (the quickstart and the latent
autoencoder), every served request bitwise its solo run (serving), the
launcher's checkpoint restoring the trained parameters bitwise
(training)."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

CASES = {
    "quickstart_torch.py": (["--steps", "2", "--samples", "1"],
                            "samples bit-identical: True"),
    "serve_llm_torch.py": (["--train-steps", "2", "--requests", "3"],
                           "every request equals its solo run bitwise"),
    "train_multiarch_torch.py": (["--arch", "qwen3-1.7b", "--steps", "2",
                                  "--log-every", "1"],
                                 "checkpoint restores bitwise: True"),
    "latent_autoencoder_torch.py": (["--ae-steps", "2", "--arm-steps", "2",
                                     "--samples", "2"], "exact: True"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs_and_asserts_its_claim(name):
    flags, claim = CASES[name]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / name), "--device", "cpu",
         *flags], capture_output=True, text=True, cwd=str(ROOT), env=env,
        timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert claim in out.stdout, out.stdout[-3000:]
