"""Reparametrization of discrete sampling (paper §2.2): the Gumbel-max map
``x = argmax_c(mu_c + eps_c)`` with the noise fixed, which is what lets a
forecast be verified exactly. Shift-invariant in ``mu``, so raw logits
serve as well as log-probabilities."""
from __future__ import annotations

import torch


def reparam_argmax(logits, eps):
    """Deterministic sample ``g(mu, eps) = argmax_c(mu_c + eps_c)``.

    logits, eps: (..., K). Returns int64 categories of shape (...,); ties go
    to the lowest index, as ``jnp.argmax``'s do.
    """
    return torch.argmax(logits + eps, dim=-1)
