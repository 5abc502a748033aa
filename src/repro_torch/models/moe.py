"""Dense MLP blocks of the FFN layer (``_mlp_init`` / ``_mlp_apply``).

The mixture-of-experts layer of the reference is a later slice
(ROADMAP.md §1 item 14); the geglu and gelu kinds come with the gemma
slice, whose ``jax.nn.gelu`` defaults to the tanh approximation.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn.core import Dense


def _mlp_init(gen, d_model, d_ff, kind, dtype, device=None):
    kw = dict(use_bias=False, dtype=dtype, device=device)
    p = {"up": Dense.init(gen, d_model, d_ff, **kw),
         "down": Dense.init(gen, d_ff, d_model, **kw)}
    if kind in ("swiglu", "geglu"):
        p["gate"] = Dense.init(gen, d_model, d_ff, **kw)
    return p


def _mlp_apply(p, x, kind):
    if kind != "swiglu":
        raise NotImplementedError(
            f"mlp_kind {kind!r} is not ported yet (ROADMAP.md §1 item 3, "
            "the gemma slice)")
    u = Dense.apply(p["up"], x)
    u = u * F.silu(Dense.apply(p["gate"], x))
    return Dense.apply(p["down"], u)
