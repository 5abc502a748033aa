"""Launcher of the CUDA dense flash-decode kernel
(``csrc/decode_attention.cu``).

Imports nothing GPU-only at module import; the library is built and loaded
at the first launch. The split-key workspace and ticket counters come from
``kernels/split.py``, shared with the paged decode kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import bind, check_status, count_launch, stream_ptr
from repro_torch.kernels.split import split_buffers

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def decode_attention_cuda(q, k, v, lengths, *, window: int, scale: float,
                          n_tiles: int, n_splits: int):
    """q: (B, W, H, d); k, v: (B, S, KV, d); lengths (B,) int32 or int64.
    All contiguous CUDA tensors, checked by the caller; ``n_tiles`` and
    ``n_splits`` from ``split.split_plan``. Returns out (B, W, H, d)."""
    B, W, H, d = q.shape
    S, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    ws, ws_ptr, ctr_ptr = split_buffers("decode_attention", q.device,
                                        B * KV * n_tiles, n_splits, d)
    fn = bind("decode_attention_launch", [ctypes.c_void_p] * 4
              + [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
              + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                int(lengths.dtype == torch.int64), out.data_ptr(), ws_ptr,
                ctr_ptr, B, W, H, KV, d, S, int(window), float(scale),
                _DTYPES[q.dtype], n_tiles, n_splits, stream_ptr(q.device))
    check_status("decode_attention", status)
    count_launch("decode_attention")
    return out
