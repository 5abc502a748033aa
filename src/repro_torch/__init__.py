"""PyTorch/CUDA port of the predictive-sampling serving system.

A package of its own beside the JAX reference ``repro``: it imports
``torch`` and never ``jax`` or ``repro``. Its layout mirrors ``repro``
module for module, so the counterpart of ``repro.X.Y`` is
``repro_torch.X.Y``. The kernels on the serving path are hand-written CUDA
for Hopper (``kernels/csrc``); everything else is plain PyTorch.

Entry points (``ServingEngine``, ``PredictiveSampler``, the serve CLI) run
on ``cuda`` unless the caller passes ``device="cpu"``; with no GPU present
and no device named they raise instead of silently running on the CPU.
"""
