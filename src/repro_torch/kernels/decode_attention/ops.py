"""Public dense flash-decode op: W window queries against the dense KV
cache of the solo sampler (``GQAttention.window``).

GQA is handled by grouping the G query heads of one kv head into rows
``w*G + g``, read and written by the kernel in the model's ``(B, W, H, d)``
layout, so neither the queries, the output nor the cache is copied or
repeated (the reference's op ``jnp.repeat``s the cache). CPU and meta
tensors take the plain version in ``ref.py``; CUDA tensors launch the
kernel or raise: there is no fallback.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import plain_here
from repro_torch.kernels.decode_attention.kernel import decode_attention_cuda
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.split import HEAD_DIMS, split_plan


def decode_attention(q, k, v, lengths, window: int = 0):
    """q: (B, W, H, d) window queries; k, v: (B, S, KV, d) caches with the
    window's keys already written at ``lengths .. lengths + W - 1``;
    lengths: (B,). Returns (B, W, H, d) in q's dtype."""
    B, W, H, d = q.shape
    ts = (q, k, v, lengths)
    if plain_here("decode_attention", *ts):
        return decode_attention_ref(q, k, v, lengths, window=window)
    dev = q.device
    if any(t.device.type != "cuda" or t.device != dev for t in ts):
        raise ValueError("decode_attention: tensors on "
                         f"{[str(t.device) for t in ts]}; want one CUDA "
                         "device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError("decode_attention wants one dtype, float32 or "
                        f"bfloat16: {q.dtype}, {k.dtype}, {v.dtype}")
    if k.ndim != 4 or k.shape[0] != B or k.shape[3] != d \
            or v.shape != k.shape or d not in HEAD_DIMS or H % k.shape[2] \
            or lengths.shape != (B,):
        raise ValueError(f"decode_attention: unsupported shapes q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, lengths {tuple(lengths.shape)}")
    if lengths.dtype not in (torch.int32, torch.int64):
        lengths = lengths.to(torch.int32)
    S, KV = k.shape[1], k.shape[2]
    n_tiles, n_splits = split_plan(S, W, H // KV, KV, B, window)
    return decode_attention_cuda(q.contiguous(), k.contiguous(),
                                 v.contiguous(), lengths.contiguous(),
                                 window=window, scale=1.0 / d ** 0.5,
                                 n_tiles=n_tiles, n_splits=n_splits)
