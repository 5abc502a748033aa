"""GQA/MQA attention (optional qk-norm, sliding window) in verify-window
mode.

``window`` runs W query tokens against a dense KV cache with per-sequence
lengths ``cache_len (B,)`` (the solo sampler's path); ``window_paged`` runs
them against the physical block pool through block tables (the serving
path). On partial accepts the caller rewinds ``cache_len``: stale slots are
never read (the mask is ``key_pos <= query_pos``) and are overwritten by
the next window.

The multi-head latent attention of the reference is a later slice
(ROADMAP.md §1 item 13).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.paged_attention.ops import (paged_attention,
                                                     paged_window_write)
from repro_torch.kernels.paged_attention.ref import gather_view
from repro_torch.nn.core import Dense, RMSNorm
from repro_torch.nn.rope import apply_rope

NEG_INF = -2.0 ** 30


def write_window(buf, new, cache_len):
    """Write W new entries into a dense cache at per-sequence offsets,
    functionally (mask + gather + where, as the reference).

    buf: (B, S, ...); new: (B, W, ...); cache_len: (B,).
    """
    B, S = buf.shape[:2]
    W = new.shape[1]
    off = (torch.arange(S, device=buf.device)[None, :]
           - cache_len.long()[:, None])                   # (B, S)
    in_win = (off >= 0) & (off < W)
    idx = off.clamp(0, W - 1)
    idx = idx.reshape(idx.shape + (1,) * (buf.ndim - 2)).expand(
        (B, S) + tuple(new.shape[2:]))
    vals = torch.gather(new, 1, idx)                      # (B, S, ...)
    mask = in_win.reshape(in_win.shape + (1,) * (buf.ndim - 2))
    return torch.where(mask, vals, buf)


def _causal_mask(q_pos, k_pos, window: int = 0):
    """(..., Q, K) boolean mask: key visible iff k <= q (and within the
    sliding window when ``window > 0``)."""
    m = k_pos[..., None, :] <= q_pos[..., :, None]
    if window > 0:
        m &= k_pos[..., None, :] > (q_pos[..., :, None] - window)
    return m


def _sdpa(q, k, v, mask, scale):
    """q: (B, Q, H, hd), k/v: (B, K, KV, hd) grouped; mask (B, Q, K) or
    (Q, K). The scores product runs in the working dtype and is then cast
    to float32, the softmax is float32, and the probabilities are cast back
    to v's dtype for the value product — the reference's dtype path."""
    B, Q, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Q, KV, G, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() * scale
    if mask.ndim == 2:
        mask = mask[None]
    logits = torch.where(mask[:, None, None], logits,
                         torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v)
    return out.reshape(B, Q, H, hd)


class GQAttention:
    @staticmethod
    def init(gen, cfg, dtype=torch.float32, device=None):
        D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        kw = dict(use_bias=False, dtype=dtype, device=device)
        p = {
            "wq": Dense.init(gen, D, H * hd, **kw),
            "wk": Dense.init(gen, D, KV * hd, **kw),
            "wv": Dense.init(gen, D, KV * hd, **kw),
            "wo": Dense.init(gen, H * hd, D, **kw),
        }
        if cfg.qk_norm:
            p["q_norm"] = RMSNorm.init(hd, dtype=dtype, device=device)
            p["k_norm"] = RMSNorm.init(hd, dtype=dtype, device=device)
        return p

    @staticmethod
    def _qkv(p, x, cfg, positions):
        B, T, D = x.shape
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q = Dense.apply(p["wq"], x).reshape(B, T, H, hd)
        k = Dense.apply(p["wk"], x).reshape(B, T, KV, hd)
        v = Dense.apply(p["wv"], x).reshape(B, T, KV, hd)
        if "q_norm" in p:
            q = RMSNorm.apply(p["q_norm"], q)
            k = RMSNorm.apply(p["k_norm"], k)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        return q, k, v

    @staticmethod
    def init_cache(cfg, batch: int, max_len: int, dtype=torch.float32,
                   device=None):
        KV, hd = cfg.n_kv_heads, cfg.head_dim
        return {"k": torch.zeros((batch, max_len, KV, hd), dtype=dtype,
                                 device=device),
                "v": torch.zeros((batch, max_len, KV, hd), dtype=dtype,
                                 device=device)}

    @staticmethod
    def window(p, x, cfg, cache, cache_len, window: int = 0):
        """x: (B, W, D) verify-window queries; cache_len: (B,) valid
        lengths. Returns (y, new_cache); key positions are absolute."""
        B, W, _ = x.shape
        S = cache["k"].shape[1]
        pos = cache_len.long()[:, None] + torch.arange(W, device=x.device)
        q, k_new, v_new = GQAttention._qkv(p, x, cfg, pos)
        k = write_window(cache["k"], k_new, cache_len)
        v = write_window(cache["v"], v_new, cache_len)
        k_pos = torch.arange(S, device=x.device).expand(B, S)
        mask = _causal_mask(pos, k_pos, window)
        out = _sdpa(q, k, v, mask, 1.0 / math.sqrt(cfg.head_dim))
        y = Dense.apply(p["wo"], out.reshape(B, W, -1))
        return y, {"k": k, "v": v}

    @staticmethod
    def window_paged(p, x, cfg, pool, tables, cache_len, window: int = 0,
                     use_kernel: bool = False):
        """Paged counterpart of ``window``: the cache is the physical block
        pool ``{"k","v"}: (P, bs, KV, hd)`` plus per-sequence ``tables
        (B, nb)`` (int32; ``cache_len`` int32 too). The pool is updated in
        place. ``use_kernel`` runs the fused paged decode, which commits the
        W fresh K/V rows while the queries attend through the table (one
        launch); otherwise the rows are committed by the writeback op, the
        dense view is gathered and ``_sdpa`` runs on it, which makes the
        result equal the dense ``window`` path's."""
        B, W, _ = x.shape
        pos = cache_len.long()[:, None] + torch.arange(W, device=x.device)
        q, k_new, v_new = GQAttention._qkv(p, x, cfg, pos)
        if use_kernel:
            out, pk, pv = paged_attention(q, pool["k"], pool["v"], k_new,
                                          v_new, tables, cache_len,
                                          window=window)
        else:
            pk = paged_window_write(pool["k"], k_new, tables, cache_len)
            pv = paged_window_write(pool["v"], v_new, tables, cache_len)
            k, v = gather_view(pk, tables), gather_view(pv, tables)
            S = k.shape[1]
            k_pos = torch.arange(S, device=x.device).expand(B, S)
            mask = _causal_mask(pos, k_pos, window)
            out = _sdpa(q, k, v, mask, 1.0 / math.sqrt(cfg.head_dim))
        y = Dense.apply(p["wo"], out.reshape(B, W, -1))
        return y, {"k": pk, "v": pv}
