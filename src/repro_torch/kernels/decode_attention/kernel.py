"""Launcher of the CUDA dense flash-decode kernel
(``csrc/decode_attention.cu``).

Imports nothing GPU-only at module import; the library is built and loaded
at the first launch."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import bind, check_status, count_launch, stream_ptr

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def decode_attention_cuda(q, k, v, lengths, *, G: int, window: int,
                          scale: float):
    """q: (B, KV, W*G, d) grouped rows (row = w*G + g); k, v: (B, S, KV, d);
    lengths (B,) int32. All contiguous CUDA tensors, checked by the caller.
    Returns out (B, KV, W*G, d)."""
    B, KV, R, d = q.shape
    S = k.shape[1]
    out = torch.empty_like(q)
    fn = bind("decode_attention_launch", [ctypes.c_void_p] * 5
              + [ctypes.c_int] * 7
              + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                out.data_ptr(), B, KV, R, G, d, S, int(window), float(scale),
                _DTYPES[q.dtype], stream_ptr(q.device))
    check_status("decode_attention", status)
    count_launch("decode_attention")
    return out
