"""Plain PyTorch version of the dense flash-decode kernel, as the
reference's ``decode_attention/ref.py`` but on the model's layout: q
``(B, W, H, d)`` against caches ``(B, S, KV, d)`` with kv head ``h // G``
read in place. Query w attends key positions ``j <= lengths + w`` (and
``j > lengths + w - window`` with a sliding window), scores and softmax
in float32, the output in q's dtype."""
from __future__ import annotations

import torch


def decode_attention_ref(q, k, v, lengths, window: int = 0):
    """q: (B, W, H, d); k, v: (B, S, KV, d); lengths: (B,). Returns
    (B, W, H, d)."""
    B, W, H, d = q.shape
    S, KV = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, W, KV, H // KV, d)
    s = torch.einsum("bwkgd,bskd->bkgws", qg, k.float()) / (d ** 0.5)
    qp = (lengths.long()[:, None, None, None, None]
          + torch.arange(W, device=q.device)[None, None, None, :, None])
    kp = torch.arange(S, device=q.device)
    mask = kp <= qp
    if window > 0:
        mask &= kp > (qp - window)
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgws,bskd->bwkgd", p, v.float())
    return out.reshape(B, W, H, d).to(q.dtype)
