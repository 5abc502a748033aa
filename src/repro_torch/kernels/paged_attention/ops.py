"""Public paged-attention ops: GQA decode through block tables with the
window writeback fused in, and the writeback alone.

GQA is handled by grouping the query heads of one kv head into rows
``g*W + w``, so the pool is never expanded or copied. The pools are
updated in place on both paths (the reference donates them).

CPU tensors take the plain versions in ``ref.py``. CUDA tensors launch the
kernels or raise: there is no fallback.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention.kernel import (paged_decode_cuda,
                                                        paged_write_cuda)
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_fused_ref, write_window_paged)


def _all_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


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
    if _all_cpu(q, k_pool, v_pool, k_new, v_new, tables, lengths):
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
    if (d not in (64, 128) or dk != d or H % KV
            or v_pool.shape != k_pool.shape
            or k_new.shape != (B, W, KV, d) or v_new.shape != k_new.shape
            or tables.shape[0] != B or lengths.shape != (B,)):
        raise ValueError(
            f"paged_attention: unsupported shapes q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)}, new {tuple(k_new.shape)}, tables "
            f"{tuple(tables.shape)}, lengths {tuple(lengths.shape)}")
    G = H // KV
    qg = (q.reshape(B, W, KV, G, d).permute(0, 2, 3, 1, 4)
          .reshape(B, KV, G * W, d).contiguous())
    out = paged_decode_cuda(qg, k_pool, v_pool, k_new, v_new, tables,
                            lengths, W=W, window=window,
                            scale=1.0 / d ** 0.5)
    out = (out.reshape(B, KV, G, W, d).permute(0, 3, 1, 2, 4)
           .reshape(B, W, H, d))
    return out, k_pool, v_pool


def paged_window_write(pool, new, tables, start, active=None):
    """Commit ``new (B, W, ...)`` into ``pool (P, bs, ...)`` at offsets
    ``start (B,)`` through ``tables (B, nb)``, in place; returns the pool.
    Rows with ``active == 0`` write nothing the reference keeps (it routes
    them to the sink block 0)."""
    if _all_cpu(pool, new, tables, start) and (
            active is None or active.device.type == "cpu"):
        return write_window_paged(pool, new, tables, start, active)
    if active is None:
        active = torch.ones(new.shape[:1], dtype=torch.int32,
                            device=new.device)
    _check_cuda("paged_window_write", pool, new, tables, start, active)
    _check_int32("paged_window_write", tables, start, active)
    B = new.shape[0]
    if (new.dtype != pool.dtype or new.shape[2:] != pool.shape[2:]
            or tables.shape[0] != B or start.shape != (B,)
            or active.shape != (B,)):
        raise ValueError(
            f"paged_window_write: pool {tuple(pool.shape)} {pool.dtype}, "
            f"new {tuple(new.shape)} {new.dtype}, tables "
            f"{tuple(tables.shape)}, start {tuple(start.shape)}, active "
            f"{tuple(active.shape)}")
    return paged_write_cuda(pool, new, tables, start, active)
