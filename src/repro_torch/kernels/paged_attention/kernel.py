"""Launchers of the CUDA paged-attention kernels (``csrc/paged_decode.cu``,
``csrc/paged_latent.cu``, ``csrc/paged_write.cu``).

Imports nothing GPU-only at module import; the library is built and loaded
at the first launch. The paged decode's split-key workspace and ticket
counters come from ``kernels/split.py``, shared with the dense decode
kernel."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import bind, check_status, count_launch, stream_ptr
from repro_torch.kernels.split import SPLIT_TARGET, split_buffers

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_decode_cuda(q, k_pool, v_pool, k_new, v_new, tables, lengths, *,
                      window: int, scale: float, n_tiles: int,
                      n_splits: int):
    """q: (B, W, H, d) window queries, read in place; pools (P, bs, KV, d),
    written in place; k_new/v_new (B, W, KV, d); tables (B, nb) and lengths
    (B,) int32. All contiguous, 16-byte aligned CUDA tensors, checked by
    the caller; ``n_tiles`` and ``n_splits`` from ``split.split_plan`` over
    the span nb * bs. Returns out (B, W, H, d)."""
    B, W, H, d = q.shape
    bs, KV = k_pool.shape[1], k_pool.shape[2]
    nb = tables.shape[1]
    out = torch.empty_like(q)
    ws, ws_ptr, ctr_ptr = split_buffers("paged_decode", q.device,
                                        B * KV * n_tiles, n_splits, d)
    fn = bind("paged_decode_launch", [ctypes.c_void_p] * 10
              + [ctypes.c_int] * 8
              + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    status = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                k_new.data_ptr(), v_new.data_ptr(), tables.data_ptr(),
                lengths.data_ptr(), out.data_ptr(), ws_ptr, ctr_ptr, B, W, H,
                KV, d, bs, nb, int(window), float(scale), _DTYPES[q.dtype],
                n_tiles, n_splits, stream_ptr(q.device))
    check_status("paged_decode", status)
    count_launch("paged_decode")
    return out


LATENT_ROWS = 64        # query rows per CTA of the bf16 latent kernel
# n-blocks of 8 value columns a warp of the bf16 latent kernel holds, by
# (latent, rope) width, the fewest column splits first
# (csrc/paged_latent.cu)
LATENT_NB = {(512, 64): (16, 8), (32, 16): (2,)}


def latent_plan(R: int, B: int, r: int, dr: int):
    """(row tiles, column splits) of a bf16 latent call with ``R`` query
    rows a sequence, ``B`` sequences and widths ``r``, ``dr``: 64-row tiles,
    and the fewest column splits whose CTAs fill the card (``SPLIT_TARGET``,
    one per SM), else the most the kernel is compiled for. Chosen from what
    the host knows, never from the lengths."""
    n_tiles = -(-R // LATENT_ROWS)
    for nb in LATENT_NB[r, dr]:
        splits = r // (16 * nb)
        if n_tiles * B * splits >= SPLIT_TARGET:
            break
    return n_tiles, splits


def paged_latent_cuda(q_lat, q_rope, c_pool, kr_pool, c_new, kr_new, tables,
                      lengths, *, scale: float):
    """q_lat: (B, W, H, r) and q_rope: (B, W, H, dr), read in place through
    their strides (last axis contiguous, rows 16-byte aligned); pools
    (P, bs, r) and (P, bs, dr), written in place; c_new (B, W, r), kr_new
    (B, W, dr); tables (B, nb) and lengths (B,) int32. All CUDA tensors of
    one dtype, checked by the caller; bf16 wants (r, dr) among
    ``LATENT_NB``'s. Returns the attention-weighted latent
    (B, W, H, r)."""
    B, W, H, r = q_lat.shape
    dr = q_rope.shape[-1]
    bs = c_pool.shape[1]
    nb = tables.shape[1]
    out = q_lat.new_empty((B, W, H, r))
    splits = (latent_plan(H * W, B, r, dr)[1] if q_lat.dtype == torch.bfloat16
              else 1)
    fn = bind("paged_latent_launch", [ctypes.c_void_p] * 9
              + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int]
              + [ctypes.c_longlong] * 6 + [ctypes.c_int, ctypes.c_void_p])
    status = fn(q_lat.data_ptr(), q_rope.data_ptr(), c_pool.data_ptr(),
                kr_pool.data_ptr(), c_new.data_ptr(), kr_new.data_ptr(),
                tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, W,
                H, r, dr, bs, nb, float(scale), _DTYPES[q_lat.dtype],
                *q_lat.stride()[:3], *q_rope.stride()[:3], splits,
                stream_ptr(q_lat.device))
    check_status("paged_latent", status)
    count_launch("paged_latent")
    return out


def paged_write_cuda(pool, new, tables, start, active):
    """pool (P, bs, ...) written in place; new (B, W, ...) of the pool's
    dtype and trailing shape; tables (B, nb), start (B,) and active (B,)
    int32, or active None: every row is active. All contiguous CUDA
    tensors, checked by the caller. The kernel copies 16-byte words: rows
    whose width or start is not a multiple of 16 bytes raise."""
    B, W = new.shape[:2]
    bs = pool.shape[1]
    nb = tables.shape[1]
    row_bytes = pool[0, 0].numel() * pool.element_size()
    if row_bytes % 16 or pool.data_ptr() % 16 or new.data_ptr() % 16:
        raise ValueError(f"paged_write: rows of {row_bytes} B at addresses "
                         f"{pool.data_ptr():#x}, {new.data_ptr():#x}; the "
                         "kernel wants 16-byte multiples")
    fn = bind("paged_write_launch", [ctypes.c_void_p] * 5
              + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    status = fn(pool.data_ptr(), new.data_ptr(), tables.data_ptr(),
                start.data_ptr(), None if active is None
                else active.data_ptr(), B, W, nb, bs, row_bytes,
                stream_ptr(pool.device))
    check_status("paged_write", status)
    count_launch("paged_write")
    return pool
