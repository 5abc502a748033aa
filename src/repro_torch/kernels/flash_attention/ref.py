"""Plain PyTorch version of the causal flash-attention kernel: full scores
in float32, as the reference's ``flash_attention/ref.py``, in the model's
layout (q ``(B, T, H, d)``, k and v ``(B, T, KV, d)``, kv head ``h // G``),
returning the per-row log-sum-exp the kernel writes beside the output.

Float64 inputs are computed in float64 (the gradient checks use it);
everything else in float32. It is differentiable through autograd, which
the tests use as the oracle of the op's hand-written backward.
"""
from __future__ import annotations

import torch


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def causal_mask(q_pos, k_pos, window: int = 0):
    """(Q, K) boolean mask: key visible iff k <= q (and k > q - window
    when ``window > 0``)."""
    m = k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        m &= k_pos[None, :] > (q_pos[:, None] - window)
    return m


def flash_attention_ref(q, k, v, window: int = 0):
    """Returns (o (B, T, H, d) in q's dtype, lse (B, H, T) in the compute
    dtype): the
    causal (optionally sliding-window) softmax attention of every query
    head over its kv head, and the log-sum-exp of each row's scaled,
    masked scores."""
    B, T, H, d = q.shape
    KV = k.shape[2]
    ct = compute_dtype(q.dtype)
    qg = q.to(ct).reshape(B, T, KV, H // KV, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(ct)) / (d ** 0.5)
    pos = torch.arange(T, device=q.device)
    s = torch.where(causal_mask(pos, pos, window), s,
                    torch.full_like(s, -1e30))
    lse = torch.logsumexp(s, dim=-1)                      # (B, KV, G, T)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(ct))
    return o.reshape(B, T, H, d).to(q.dtype), lse.reshape(B, H, T)
