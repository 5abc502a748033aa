"""Plain PyTorch versions of the paged flash-decode kernels (GQA, and MLA's
absorbed-latent variant) and of the window writeback.

Each attention ref gathers the dense per-sequence view through the block
table (the very copy the kernel exists to avoid) and runs the plain-softmax
decode math in float32: query w attends keys <= lengths + w.

``write_window_paged`` is the reference scatter: W new entries into the
physical block pool at table-resolved offsets. Unlike the JAX reference,
which returns a new pool, it writes the pool in place (the reference
donates the pool, so the old value is dead either way) and returns it.
"""
from __future__ import annotations

import torch


def gather_view(pool, tables):
    """pool: (P, bs, ...) physical blocks; tables: (B, nb). Returns the dense
    (B, nb*bs, ...) per-sequence view."""
    g = pool[tables.long()]                              # (B, nb, bs, ...)
    return g.reshape((g.shape[0], g.shape[1] * g.shape[2]) + g.shape[3:])


def write_window_paged(pool, new, tables, cache_len, active=None):
    """Reference window writeback, in place: pool (P, bs, ...); new
    (B, W, ...); tables (B, nb); cache_len (B,). Positions past a row's
    table, and every position of rows with ``active == False``, land in the
    reserved sink block 0, whose contents are garbage by design."""
    P, bs = pool.shape[:2]
    B, W = new.shape[:2]
    nb = tables.shape[1]
    pos = cache_len.long()[:, None] + torch.arange(W, device=pool.device)
    blk = torch.div(pos, bs, rounding_mode="floor")
    phys = torch.gather(tables.long(), 1, blk.clamp(0, nb - 1))
    ok = (blk >= 0) & (blk < nb)
    if active is not None:
        ok &= active.bool()[:, None]
    phys = torch.where(ok, phys, torch.zeros_like(phys))
    flat_idx = (phys * bs + pos % bs).reshape(-1)
    flat = pool.view((P * bs,) + tuple(pool.shape[2:]))
    flat[flat_idx] = new.reshape((B * W,) + tuple(new.shape[2:])).to(
        pool.dtype)
    return pool


def paged_attention_ref(q, k_pool, v_pool, tables, lengths, window: int = 0):
    """Attend-only plain version over pools whose window keys are already
    written. q: (B, W, H, d); k_pool/v_pool: (P, bs, KV, d); tables:
    (B, nb); lengths: (B,). Returns (B, W, H, d) in q's dtype."""
    B, W, H, d = q.shape
    KV = k_pool.shape[2]
    G = H // KV
    k = gather_view(k_pool, tables)                      # (B, S, KV, d)
    v = gather_view(v_pool, tables)
    S = k.shape[1]
    dev = q.device
    qg = q.reshape(B, W, KV, G, d)
    s = torch.einsum("bwkgd,bskd->bkgws", qg.float(), k.float()) / (d ** 0.5)
    qp = (lengths.long()[:, None, None, None, None]
          + torch.arange(W, device=dev)[None, None, None, :, None])
    kp = torch.arange(S, device=dev)[None, None, None, None, :]
    mask = kp <= qp
    if window > 0:
        mask &= kp > (qp - window)
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgws,bskd->bwkgd", p, v.float())
    return out.reshape(B, W, H, d).to(q.dtype)


def paged_attention_fused_ref(q, k_pool, v_pool, k_new, v_new, tables,
                              lengths, window: int = 0):
    """Fused-op plain version: commit the window rows with the reference
    scatter, then attend — returns (out, k_pool, v_pool) like the kernel,
    the pools written in place."""
    k_pool = write_window_paged(k_pool, k_new, tables, lengths)
    v_pool = write_window_paged(v_pool, v_new, tables, lengths)
    out = paged_attention_ref(q, k_pool, v_pool, tables, lengths,
                              window=window)
    return out, k_pool, v_pool


def paged_latent_ref(q_lat, q_rope, c_pool, kr_pool, tables, lengths, *,
                     scale: float):
    """Attend-only plain version of MLA's absorbed-latent decode over pools
    whose window latents are already written. q_lat: (B, W, H, r); q_rope:
    (B, W, H, dr); c_pool: (P, bs, r); kr_pool: (P, bs, dr). Returns the
    attention-weighted latent (B, W, H, r) in q_lat's dtype: the gathered
    c_kv rows are both the keys' latent half and the values."""
    W = q_lat.shape[1]
    c = gather_view(c_pool, tables).float()              # (B, S, r)
    kr = gather_view(kr_pool, tables).float()            # (B, S, dr)
    S = c.shape[1]
    dev = q_lat.device
    s = (torch.einsum("bwhr,bsr->bhws", q_lat.float(), c)
         + torch.einsum("bwhd,bsd->bhws", q_rope.float(), kr)) * scale
    qp = (lengths.long()[:, None, None, None]
          + torch.arange(W, device=dev)[None, None, :, None])
    kp = torch.arange(S, device=dev)[None, None, None, :]
    s = torch.where(kp <= qp, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhws,bsr->bwhr", p, c)
    return out.to(q_lat.dtype)


def paged_latent_fused_ref(q_lat, q_rope, c_pool, kr_pool, c_new, kr_new,
                           tables, lengths, *, scale: float):
    """Fused MLA plain version: commit the window latents into both pools
    with the reference scatter, then attend — returns (out, c_pool,
    kr_pool) like the kernel, the pools written in place."""
    c_pool = write_window_paged(c_pool, c_new, tables, lengths)
    kr_pool = write_window_paged(kr_pool, kr_new, tables, lengths)
    out = paged_latent_ref(q_lat, q_rope, c_pool, kr_pool, tables, lengths,
                           scale=scale)
    return out, c_pool, kr_pool
