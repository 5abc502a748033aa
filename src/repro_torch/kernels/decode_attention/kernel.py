"""Launcher of the CUDA dense flash-decode kernel
(``csrc/decode_attention.cu``).

Imports nothing GPU-only at module import; the library is built and loaded
at the first launch. The split-key ticket counters (``csrc/split_merge.cuh``)
are one zeroed buffer per device, allocated at the first split call and
left zeroed by every call; calls on one device are assumed to run in stream
order, as the samplers make them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import bind, check_status, count_launch, stream_ptr

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROWS = 16               # query rows per CTA (decode_attention.cu: kRows)
COUNTERS = 1 << 16      # ticket counters per device: groups a call may have
_COUNTER_BUFS: dict = {}


def _counters(device, groups: int):
    if groups > COUNTERS:
        raise ValueError(f"decode_attention: {groups} row tiles x kv heads "
                         f"x sequences; the kernel counts at most "
                         f"{COUNTERS}")
    buf = _COUNTER_BUFS.get(device)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("decode_attention: call it once outside CUDA "
                               "graph capture first (its ticket counters "
                               "are allocated at the first split call)")
        buf = torch.zeros(COUNTERS, dtype=torch.int32, device=device)
        _COUNTER_BUFS[device] = buf
    return buf


def decode_attention_cuda(q, k, v, lengths, *, window: int, scale: float,
                          n_tiles: int, n_splits: int):
    """q: (B, W, H, d); k, v: (B, S, KV, d); lengths (B,) int32 or int64.
    All contiguous CUDA tensors, checked by the caller; ``n_tiles`` and
    ``n_splits`` from ``ops.split_plan``. Returns out (B, W, H, d)."""
    B, W, H, d = q.shape
    S, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    ws_ptr = ctr_ptr = None
    if n_splits > 1:
        groups = B * KV * n_tiles
        ctr_ptr = _counters(q.device, groups).data_ptr()
        ws = torch.empty(groups * n_splits * ROWS * (d + 2),
                         dtype=torch.float32, device=q.device)
        ws_ptr = ws.data_ptr()
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
