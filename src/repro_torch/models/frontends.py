"""Stub modality frontends, as the reference's ``models/frontends.py``.

For musicgen-large (audio, over EnCodec tokens) and internvl2-1b (vision)
the configs specify the transformer backbone only; ``prefix_embeddings``
of ``n_prefix_tokens`` positions stand in for the frozen codec's or
vision encoder's outputs, placed before the tokens. These helpers give
shape-correct prefixes: a meta-device tensor for the shapes alone, and
random values drawn from a JAX-compatible key (``core/random.py``), equal
to the reference's ``random_prefix`` on the same key (bitwise in
bfloat16, within a few ulps in float32).
"""
from __future__ import annotations

import torch

from repro_torch.core import random as jr


def prefix_spec(cfg, batch: int):
    """A meta-device tensor of the frontend prefix's shape
    (batch, n_prefix_tokens, d_model) and dtype, or None without one."""
    if cfg.n_prefix_tokens == 0:
        return None
    return torch.empty((batch, cfg.n_prefix_tokens, cfg.d_model),
                       dtype=cfg.param_dtype, device="meta")


def random_prefix(key, cfg, batch: int):
    """``0.02 * normal(key)`` of the prefix's shape in the model's dtype, on
    the key's device, or None without a prefix. ``key`` is a pair of
    uint32 key words (``core.random.prng_key``, ``fold_in``)."""
    if cfg.n_prefix_tokens == 0:
        return None
    dtype = cfg.param_dtype
    z = jr.normal(key, (batch, cfg.n_prefix_tokens, cfg.d_model), dtype)
    return torch.tensor(0.02, dtype=dtype, device=z.device) * z
