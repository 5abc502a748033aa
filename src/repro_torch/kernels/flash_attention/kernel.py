"""Launcher of the CUDA causal flash-attention kernel
(``csrc/flash_attention.cu``).

Imports nothing GPU-only at module import; the library is built and loaded
at the first launch."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import bind, check_status, count_launch, stream_ptr

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_cuda(q, k, v, *, window: int, scale: float):
    """q: (B, T, H, d); k, v: (B, T, KV, d); contiguous CUDA tensors of one
    dtype, d = 64, 128 or 256, checked by the caller. Returns (o (B, T, H, d) in q's
    dtype, lse (B, H, T) float32)."""
    B, T, H, d = q.shape
    KV = k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    fn = bind("flash_attention_launch", [ctypes.c_void_p] * 5
              + [ctypes.c_int] * 6
              + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), B, T, H, KV, d, int(window), float(scale),
                _DTYPES[q.dtype], stream_ptr(q.device))
    check_status("flash_attention", status)
    count_launch("flash_attention")
    return o, lse
