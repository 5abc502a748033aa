"""Public paged-attention ops: GQA decode and MLA's absorbed-latent decode
through block tables, each with the window writeback fused in, and the
writeback alone.

GQA is handled by grouping the query heads of one kv head into rows
``w*G + g``, read and written by the kernel in the model's ``(B, W, H, d)``
layout, so neither the queries, the output nor the pool is copied or
expanded; MLA's single latent "kv head" serves all H heads as rows
``w*H + h``, read in place through the queries' strides. The pools are
updated in place on every path (the reference donates them).

CPU and meta tensors take the plain versions in ``ref.py``. CUDA tensors
launch the kernels or raise: there is no fallback.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import plain_here
from repro_torch.kernels.paged_attention.kernel import (LATENT_NB,
                                                        paged_decode_cuda,
                                                        paged_latent_cuda,
                                                        paged_write_cuda)
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_fused_ref, paged_latent_fused_ref, write_window_paged)
from repro_torch.kernels.split import HEAD_DIMS, split_plan


def _check_cuda(name, *ts):
    dev = ts[0].device
    for t in ts:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: tensors on {[str(x.device) for x in ts]}"
                             "; want one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous tensor of shape "
                             f"{tuple(t.shape)}")


def _check_int32(name, *ts):
    for t in ts:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: index tensors must be int32, got "
                            f"{t.dtype}")


def paged_attention(q, k_pool, v_pool, k_new, v_new, tables, lengths,
                    window: int = 0):
    """q: (B, W, H, d) window queries; k_pool/v_pool: (P, bs, KV, d)
    physical block pools; k_new/v_new: (B, W, KV, d) fresh window rows;
    tables: (B, nb); lengths: (B,). Returns (out (B, W, H, d), k_pool,
    v_pool), the window rows written through the tables in place."""
    B, W, H, d = q.shape
    if plain_here("paged_decode", q, k_pool, v_pool, k_new, v_new, tables,
                  lengths):
        return paged_attention_fused_ref(q, k_pool, v_pool, k_new, v_new,
                                         tables, lengths, window=window)
    _check_cuda("paged_attention", k_pool, v_pool, k_new, v_new, tables,
                lengths, q)
    _check_int32("paged_attention", tables, lengths)
    P, bs, KV, dk = k_pool.shape
    if not (q.dtype == k_pool.dtype == v_pool.dtype == k_new.dtype
            == v_new.dtype) or q.dtype not in (torch.float32,
                                               torch.bfloat16):
        raise TypeError("paged_attention wants one dtype, float32 or "
                        f"bfloat16: {q.dtype}, {k_pool.dtype}, "
                        f"{v_pool.dtype}, {k_new.dtype}, {v_new.dtype}")
    if (d not in HEAD_DIMS or dk != d or H % KV
            or v_pool.shape != k_pool.shape
            or k_new.shape != (B, W, KV, d) or v_new.shape != k_new.shape
            or tables.shape[0] != B or lengths.shape != (B,)):
        raise ValueError(
            f"paged_attention: unsupported shapes q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)}, new {tuple(k_new.shape)}, tables "
            f"{tuple(tables.shape)}, lengths {tuple(lengths.shape)}")
    ptrs = [t.data_ptr() for t in (q, k_pool, v_pool, k_new, v_new)]
    if any(p % 16 for p in ptrs):
        raise ValueError(f"paged_attention: tensors at addresses "
                         f"{[hex(p) for p in ptrs]}; the kernel wants "
                         "16-byte alignment")
    n_tiles, n_splits = split_plan(tables.shape[1] * bs, W, H // KV, KV, B,
                                   window)
    out = paged_decode_cuda(q, k_pool, v_pool, k_new, v_new, tables,
                            lengths, window=window, scale=1.0 / d ** 0.5,
                            n_tiles=n_tiles, n_splits=n_splits)
    return out, k_pool, v_pool


def paged_latent_attention(q_lat, q_rope, c_pool, kr_pool, c_new, kr_new,
                           tables, lengths, *, scale: float):
    """MLA absorbed-latent decode over the latent pools. q_lat:
    (B, W, H, r); q_rope: (B, W, H, dr); c_pool: (P, bs, r); kr_pool:
    (P, bs, dr); c_new: (B, W, r); kr_new: (B, W, dr) fresh window latents;
    tables: (B, nb); lengths: (B,). Returns (ctx (B, W, H, r), c_pool,
    kr_pool): the attention-weighted latent (the caller applies W_uv and
    W_o) and both pools with the window committed in place."""
    B, W, H, r = q_lat.shape
    dr = q_rope.shape[-1]
    if plain_here("paged_latent", q_lat, q_rope, c_pool, kr_pool, c_new,
                  kr_new, tables, lengths):
        return paged_latent_fused_ref(q_lat, q_rope, c_pool, kr_pool, c_new,
                                      kr_new, tables, lengths, scale=scale)
    if not (q_lat.dtype == q_rope.dtype == c_pool.dtype == kr_pool.dtype
            == c_new.dtype == kr_new.dtype) or q_lat.dtype not in (
                torch.float32, torch.bfloat16):
        raise TypeError("paged_latent_attention wants one dtype, float32 or "
                        f"bfloat16: {q_lat.dtype}, {q_rope.dtype}, "
                        f"{c_pool.dtype}, {kr_pool.dtype}, {c_new.dtype}, "
                        f"{kr_new.dtype}")
    P, bs = c_pool.shape[:2]
    if (r > 512 or q_rope.shape != (B, W, H, dr)
            or c_pool.shape != (P, bs, r) or kr_pool.shape != (P, bs, dr)
            or c_new.shape != (B, W, r) or kr_new.shape != (B, W, dr)
            or tables.shape[0] != B or lengths.shape != (B,)
            or (q_lat.dtype == torch.bfloat16
                and (r, dr) not in LATENT_NB)):
        raise ValueError(
            f"paged_latent_attention: unsupported shapes q_lat "
            f"{tuple(q_lat.shape)}, q_rope {tuple(q_rope.shape)}, pools "
            f"{tuple(c_pool.shape)}, {tuple(kr_pool.shape)}, new "
            f"{tuple(c_new.shape)}, {tuple(kr_new.shape)}, tables "
            f"{tuple(tables.shape)}, lengths {tuple(lengths.shape)}")
    # the queries are read in place, through their strides: copied only
    # when a row is not contiguous or not 16-byte aligned
    q_lat, q_rope = _rows_16(q_lat), _rows_16(q_rope)
    c_new, kr_new = c_new.contiguous(), kr_new.contiguous()
    _check_cuda("paged_latent_attention", c_pool, kr_pool, c_new, kr_new,
                tables, lengths)
    for t in (q_lat, q_rope):
        if t.device != c_pool.device:
            raise ValueError(f"paged_latent_attention: queries on "
                             f"{t.device}, pools on {c_pool.device}")
    _check_int32("paged_latent_attention", tables, lengths)
    size = q_lat.element_size()
    ptrs = [t.data_ptr() for t in (c_pool, kr_pool, c_new, kr_new)]
    if (r * size) % 16 or (dr * size) % 16 or any(p % 16 for p in ptrs):
        raise ValueError(f"paged_latent_attention: rows of {r * size} and "
                         f"{dr * size} B at addresses "
                         f"{[hex(p) for p in ptrs]}; the kernel wants "
                         "16-byte multiples")
    out = paged_latent_cuda(q_lat, q_rope, c_pool, kr_pool, c_new, kr_new,
                            tables, lengths, scale=scale)
    return out, c_pool, kr_pool


def _rows_16(q):
    """``q`` if its last axis is contiguous and every row starts on a
    16-byte boundary (the latent kernel reads rows in 16-byte words through
    the other strides), else a contiguous copy."""
    size = q.element_size()
    if (q.stride(-1) == 1 and q.data_ptr() % 16 == 0
            and all(s * size % 16 == 0 for s in q.stride()[:-1])):
        return q
    return q.contiguous()


def paged_window_write(pool, new, tables, start, active=None):
    """Commit ``new (B, W, ...)`` into ``pool (P, bs, ...)`` at offsets
    ``start (B,)`` through ``tables (B, nb)``, in place; returns the pool.
    Rows with ``active == 0`` write nothing the reference keeps (it routes
    them to the sink block 0)."""
    if plain_here("paged_write", pool, new, tables, start,
                  *(() if active is None else (active,))):
        return write_window_paged(pool, new, tables, start, active)
    idx = (tables, start) if active is None else (tables, start, active)
    _check_cuda("paged_window_write", pool, new, *idx)
    _check_int32("paged_window_write", *idx)
    B = new.shape[0]
    if (new.dtype != pool.dtype or new.shape[2:] != pool.shape[2:]
            or tables.shape[0] != B or start.shape != (B,)
            or (active is not None and active.shape != (B,))):
        raise ValueError(
            f"paged_window_write: pool {tuple(pool.shape)} {pool.dtype}, "
            f"new {tuple(new.shape)} {new.dtype}, tables "
            f"{tuple(tables.shape)}, start {tuple(start.shape)}, active "
            f"{None if active is None else tuple(active.shape)}")
    return paged_write_cuda(pool, new, tables, start, active)
