"""Attention mixers: GQA/MQA (optional qk-norm, sliding window) and MLA
(DeepSeek-V3's multi-head latent attention).

``full`` runs whole-sequence causal attention (the training path).
``window`` runs W query tokens against a dense KV cache with per-sequence
lengths ``cache_len (B,)`` (the solo sampler's path); ``window_paged`` runs
them against the physical block pool through block tables (the serving
path). On partial accepts the caller rewinds ``cache_len``: stale slots are
never read (the mask is ``key_pos <= query_pos``) and are overwritten by
the next window.

MLA caches the compressed latent ``c_kv`` and the decoupled rope key
instead of per-head K/V, and attends in the absorbed-matrix form, so a
decode step reads only ``r + rope_dim`` values per cached token.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention.ops import (paged_attention,
                                                     paged_latent_attention,
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


# Above this sequence length the plain whole-sequence route attends query
# chunk by query chunk ((B, H, CHUNK, T) score tiles instead of
# (B, H, T, T)), each chunk checkpointed, as the reference does.
CHUNKED_THRESHOLD = 2048
QUERY_CHUNK = 512


def _pick_chunk(T: int, target: int = QUERY_CHUNK) -> int:
    """Largest divisor of T that is <= target."""
    for c in range(min(target, T), 0, -1):
        if T % c == 0:
            return c
    return T


def _chunked(one_chunk, T: int, *qs):
    """Runs ``one_chunk(q_pos, *q_chunks)`` over query chunks of
    ``_pick_chunk(T)`` rows of each (B, T, ...) tensor in ``qs``, each
    under ``torch.utils.checkpoint`` (its backward recomputes the chunk's
    softmax weights instead of keeping them), and concatenates the
    (B, chunk, ...) outputs along the sequence."""
    cq = _pick_chunk(T)
    outs = []
    for c0 in range(0, T, cq):
        q_pos = torch.arange(c0, c0 + cq, device=qs[0].device)
        outs.append(checkpoint(one_chunk, q_pos,
                               *[x[:, c0:c0 + cq] for x in qs],
                               use_reentrant=False))
    return torch.cat(outs, dim=1)


def _sdpa_chunked(q, k, v, scale, window: int = 0):
    """Causal chunked attention over whole sequences. q: (B, T, H, hd);
    k/v: (B, T, KV, hd). Keys stay resident; queries go chunk by chunk."""
    k_pos = torch.arange(q.shape[1], device=q.device)

    def one_chunk(q_pos, q_i):
        return _sdpa(q_i, k, v, _causal_mask(q_pos, k_pos, window), scale)
    return _chunked(one_chunk, q.shape[1], q)


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
    def full(p, x, cfg, window: int = 0, use_kernel: bool = True):
        """x: (B, T, D) -> (B, T, D); causal (optionally sliding-window).
        With ``use_kernel``, CUDA tensors attend through the flash-attention
        kernel; otherwise, and always on the CPU, the reference's plain
        route: ``_sdpa`` up to ``CHUNKED_THRESHOLD`` positions, then
        ``_sdpa_chunked``. The kernel keeps the scores and probabilities
        in float32 where ``_sdpa`` rounds them to the working dtype, so in
        bfloat16 the two routes differ by a few ulps."""
        B, T, _ = x.shape
        pos = torch.arange(T, device=x.device).expand(B, T)
        q, k, v = GQAttention._qkv(p, x, cfg, pos)
        scale = 1.0 / math.sqrt(cfg.head_dim)
        if use_kernel and x.device.type == "cuda":
            out = flash_attention(q, k, v, window)
        elif T > CHUNKED_THRESHOLD:
            out = _sdpa_chunked(q, k, v, scale, window)
        else:
            out = _sdpa(q, k, v, _causal_mask(pos, pos, window), scale)
        return Dense.apply(p["wo"], out.reshape(B, T, -1))

    @staticmethod
    def init_cache(cfg, batch: int, max_len: int, dtype=torch.float32,
                   device=None):
        KV, hd = cfg.n_kv_heads, cfg.head_dim
        return {"k": torch.zeros((batch, max_len, KV, hd), dtype=dtype,
                                 device=device),
                "v": torch.zeros((batch, max_len, KV, hd), dtype=dtype,
                                 device=device)}

    @staticmethod
    def window(p, x, cfg, cache, cache_len, window: int = 0,
               use_kernel: bool = False):
        """x: (B, W, D) verify-window queries; cache_len: (B,) valid
        lengths. Returns (y, new_cache); key positions are absolute. The
        window's K/V are written into the cache first; ``use_kernel`` then
        attends through the dense flash-decode op (the CUDA kernel on CUDA
        tensors, its float32 plain version on the CPU), otherwise through
        ``_sdpa``, which rounds scores and probabilities to the working
        dtype where the op keeps them in float32."""
        B, W, _ = x.shape
        S = cache["k"].shape[1]
        pos = cache_len.long()[:, None] + torch.arange(W, device=x.device)
        q, k_new, v_new = GQAttention._qkv(p, x, cfg, pos)
        k = write_window(cache["k"], k_new, cache_len)
        v = write_window(cache["v"], v_new, cache_len)
        if use_kernel:
            out = decode_attention(q, k, v, cache_len, window)
        else:
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


class MLAttention:
    """Multi-head latent attention (DeepSeek-V3)."""

    @staticmethod
    def init(gen, cfg, dtype=torch.float32, device=None):
        D, H = cfg.d_model, cfg.n_heads
        r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        kw = dict(use_bias=False, dtype=dtype, device=device)
        return {
            "wq_a": Dense.init(gen, D, r_q, **kw),
            "q_norm": RMSNorm.init(r_q, dtype=dtype, device=device),
            "wq_b": Dense.init(gen, r_q, H * (dn + dr), **kw),
            "wkv_a": Dense.init(gen, D, r_kv + dr, **kw),
            "kv_norm": RMSNorm.init(r_kv, dtype=dtype, device=device),
            "wk_b": Dense.init(gen, r_kv, H * dn, **kw),
            "wv_b": Dense.init(gen, r_kv, H * dv, **kw),
            "wo": Dense.init(gen, H * dv, D, **kw),
        }

    @staticmethod
    def _q(p, x, cfg, positions):
        B, T, _ = x.shape
        H, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
        q = Dense.apply(p["wq_b"], RMSNorm.apply(
            p["q_norm"], Dense.apply(p["wq_a"], x)))
        q = q.reshape(B, T, H, dn + dr)
        q_nope, q_rope = q[..., :dn], q[..., dn:]
        q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
        return q_nope, q_rope

    @staticmethod
    def _latent(p, x, cfg, positions):
        """Compressed KV latent (B, T, r) and the decoupled rope key
        (B, T, dr), one head shared by all heads."""
        r_kv = cfg.kv_lora_rank
        kv = Dense.apply(p["wkv_a"], x)
        c_kv = RMSNorm.apply(p["kv_norm"], kv[..., :r_kv])
        k_rope = apply_rope(kv[..., None, r_kv:], positions, cfg.rope_theta)
        return c_kv, k_rope[..., 0, :]

    @staticmethod
    def _scale(cfg):
        return 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)

    @staticmethod
    def _absorb_query(p, q_nope, cfg):
        """W_uk absorbed into the query: (B, Q, H, dn) -> q_lat (B, Q, H, r)."""
        H, dn = cfg.n_heads, cfg.qk_nope_dim
        wk_b = p["wk_b"]["w"].reshape(cfg.kv_lora_rank, H, dn)
        return torch.einsum("bqhd,rhd->bqhr", q_nope, wk_b)

    @staticmethod
    def _absorbed_out(p, ctx, cfg):
        """W_uv and ``wo`` applied to the attention-weighted latent
        ctx (B, Q, H, r) -> (B, Q, D)."""
        B, Q, H, _ = ctx.shape
        wv_b = p["wv_b"]["w"].reshape(cfg.kv_lora_rank, H, cfg.v_head_dim)
        out = torch.einsum("bqhr,rhd->bqhd", ctx, wv_b)
        return Dense.apply(p["wo"], out.reshape(B, Q, -1))

    @staticmethod
    def _attend_absorbed(p, q_nope, q_rope, c_kv, k_rope, mask, cfg):
        """Absorbed-matrix attention over the latent cache.

        q_nope: (B, Q, H, dn); c_kv: (B, S, r); k_rope: (B, S, dr).
        scores = q_nope^T W_uk c + q_rope . k_rope; the output applies W_uv
        to the attention-weighted latent, so per-head K/V never exist.
        Products run in the working dtype, the softmax in float32, as in
        the reference."""
        q_lat = MLAttention._absorb_query(p, q_nope, cfg)
        logits = (torch.einsum("bqhr,bsr->bhqs", q_lat, c_kv)
                  + torch.einsum("bqhd,bsd->bhqs", q_rope, k_rope))
        logits = logits.float() * MLAttention._scale(cfg)
        if mask.ndim == 2:
            mask = mask[None]
        logits = torch.where(mask[:, None], logits,
                             torch.full_like(logits, NEG_INF))
        pattn = torch.softmax(logits, dim=-1).to(c_kv.dtype)
        ctx = torch.einsum("bhqs,bsr->bqhr", pattn, c_kv)
        return MLAttention._absorbed_out(p, ctx, cfg)

    @staticmethod
    def full(p, x, cfg):
        """x: (B, T, D) -> (B, T, D), whole-sequence causal MLA in the
        absorbed form, plain torch on every device as in the reference
        (its q.k width, qk_nope + qk_rope = 192, is not its value width,
        so the flash-attention kernel does not apply). Above
        ``CHUNKED_THRESHOLD`` positions the queries go chunk by chunk,
        each chunk checkpointed."""
        B, T, _ = x.shape
        pos = torch.arange(T, device=x.device).expand(B, T)
        q_nope, q_rope = MLAttention._q(p, x, cfg, pos)
        c_kv, k_rope = MLAttention._latent(p, x, cfg, pos)
        if T > CHUNKED_THRESHOLD:
            k_pos = torch.arange(T, device=x.device)

            def one_chunk(q_pos, qn_i, qr_i):
                return MLAttention._attend_absorbed(
                    p, qn_i, qr_i, c_kv, k_rope, _causal_mask(q_pos, k_pos),
                    cfg)
            return _chunked(one_chunk, T, q_nope, q_rope)
        return MLAttention._attend_absorbed(p, q_nope, q_rope, c_kv, k_rope,
                                            _causal_mask(pos, pos), cfg)

    @staticmethod
    def init_cache(cfg, batch: int, max_len: int, dtype=torch.float32,
                   device=None):
        return {"c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                    dtype=dtype, device=device),
                "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim),
                                      dtype=dtype, device=device)}

    @staticmethod
    def window(p, x, cfg, cache, cache_len, window: int = 0):
        """x: (B, W, D) verify-window queries against the dense latent
        cache ``{"c_kv": (B, S, r), "k_rope": (B, S, dr)}``; cache_len:
        (B,); ``window`` > 0 masks keys outside a sliding window, as in
        the GQA mixer. Returns (y, new_cache)."""
        B, W, _ = x.shape
        S = cache["c_kv"].shape[1]
        pos = cache_len.long()[:, None] + torch.arange(W, device=x.device)
        q_nope, q_rope = MLAttention._q(p, x, cfg, pos)
        c_new, kr_new = MLAttention._latent(p, x, cfg, pos)
        c_kv = write_window(cache["c_kv"], c_new, cache_len)
        k_rope = write_window(cache["k_rope"], kr_new, cache_len)
        k_pos = torch.arange(S, device=x.device).expand(B, S)
        mask = _causal_mask(pos, k_pos, window)
        y = MLAttention._attend_absorbed(p, q_nope, q_rope, c_kv, k_rope,
                                         mask, cfg)
        return y, {"c_kv": c_kv, "k_rope": k_rope}

    @staticmethod
    def window_paged(p, x, cfg, pool, tables, cache_len, window: int = 0,
                     use_kernel: bool = False):
        """Paged MLA decode: the latent pools ``{"c_kv": (P, bs, r),
        "k_rope": (P, bs, dr)}`` are written and read through ``tables``
        and updated in place. ``use_kernel`` absorbs W_uk into the query
        and runs the fused latent decode, which streams the latent pool
        once (the merged c_kv tile is both key and value) while committing
        both pools; otherwise the writeback op commits the window, the
        dense view is gathered and ``_attend_absorbed`` runs on it, which
        makes the result equal the dense ``window`` path's. The latent
        kernel has no sliding window, so ``window`` must be 0."""
        if window:
            raise NotImplementedError("paged MLA has no sliding window")
        B, W, _ = x.shape
        pos = cache_len.long()[:, None] + torch.arange(W, device=x.device)
        q_nope, q_rope = MLAttention._q(p, x, cfg, pos)
        c_new, kr_new = MLAttention._latent(p, x, cfg, pos)
        if use_kernel:
            ctx, pc, pkr = paged_latent_attention(
                MLAttention._absorb_query(p, q_nope, cfg), q_rope,
                pool["c_kv"], pool["k_rope"], c_new, kr_new, tables,
                cache_len, scale=MLAttention._scale(cfg))
            y = MLAttention._absorbed_out(p, ctx, cfg)
        else:
            pc = paged_window_write(pool["c_kv"], c_new, tables, cache_len)
            pkr = paged_window_write(pool["k_rope"], kr_new, tables,
                                     cache_len)
            c_kv, k_rope = gather_view(pc, tables), gather_view(pkr, tables)
            S = c_kv.shape[1]
            k_pos = torch.arange(S, device=x.device).expand(B, S)
            mask = _causal_mask(pos, k_pos)
            y = MLAttention._attend_absorbed(p, q_nope, q_rope, c_kv, k_rope,
                                             mask, cfg)
        return y, {"c_kv": pc, "k_rope": pkr}
