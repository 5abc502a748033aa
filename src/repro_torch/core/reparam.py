"""Reparametrization of discrete sampling (paper §2.2 and Appendix B).

§2.2: ancestral sampling ``x_i ~ Cat(softmax(mu_i))`` is the deterministic
map ``x_i = argmax_c(mu_{i,c} + eps_{i,c})`` with fixed Gumbel noise
``eps``, which is what lets a forecast be verified exactly. The map is
shift-invariant in ``mu``, so raw logits serve as well as
log-probabilities.

Appendix B: training a forecast on data samples needs noise from the
posterior ``p(eps | x)``. A Gumbel max and its argmax are independent, so
  b           = the max value ~ Gumbel(logsumexp(mu)),
  eps_{i,x_i} = b - mu_{x_i},
  eps_{i,c}   = TruncGumbel(mu_c | b) - mu_c        for c != x_i,
and ``argmax_c(mu_c + eps_c) == x_i`` (``posterior_gumbel``).

Noise comes from ``core/random.py``, which reproduces ``jax.random``'s
bits; its floats agree with JAX's within the ulps that module states.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.analysis.hotpath import hot_path
from repro_torch.core import random as jr


def gumbel(key, shape):
    """Standard Gumbel(0, 1) float32 noise of ``shape``: JAX's
    ``jax.random.gumbel(key, shape)``, whose counters are the flat index."""
    return jr.gumbel(key, math.prod(shape)).reshape(shape)


def _key_on(key, device):
    """The key moved to ``device``, so its noise is drawn there: threefry
    runs where its key lies."""
    return tuple(k.to(device) for k in key)


@hot_path
def reparam_argmax(logits, eps):
    """Deterministic sample ``g(mu, eps) = argmax_c(mu_c + eps_c)``.

    logits, eps: (..., K). Returns int64 categories of shape (...,); ties go
    to the lowest index, as ``jnp.argmax``'s do.
    """
    return torch.argmax(logits + eps, dim=-1)


def categorical_sample(key, logits):
    """Ancestral sample through an explicit Gumbel max, so tests can share
    the noise."""
    eps = gumbel(_key_on(key, logits.device), tuple(logits.shape))
    return reparam_argmax(logits.float(), eps)


def _trunc_gumbel_value(key, mu, b):
    """``v = mu + g`` for ``g ~ Gumbel(0)`` truncated so that ``v <= b``:
    ``v = -logaddexp(-b, -(mu + g0))`` with ``g0 ~ Gumbel(0)``."""
    g0 = gumbel(_key_on(key, mu.device), tuple(mu.shape))
    return -torch.logaddexp(-b, -(mu + g0))


def posterior_gumbel(key, logits, x):
    """Noise ``eps ~ p(eps | x)`` for the Gumbel-max reparametrization.

    logits: (..., K) float logits (any shift); x: (...,) int categories.
    Returns float32 eps of shape (..., K) with
    ``reparam_argmax(logits, eps) == x``.
    """
    logits = logits.float()
    K = logits.shape[-1]
    k_max, k_rest = jr.split(_key_on(key, logits.device))
    x = x.long()
    onehot = F.one_hot(x, K).bool()
    mu_x = torch.gather(logits, -1, x[..., None])              # (..., 1)
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)        # (..., 1)
    g0 = gumbel(k_max, tuple(x.shape))[..., None]
    b = lse + g0          # the max value ~ Gumbel(LSE), independent of x
    eps_max = b - mu_x    # the noise at the argmax
    eps_rest = _trunc_gumbel_value(k_rest, logits, b) - logits
    return torch.where(onehot, eps_max, eps_rest)
