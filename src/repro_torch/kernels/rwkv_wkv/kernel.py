"""Launcher of the CUDA WKV-recurrence kernel (``csrc/rwkv_wkv.cu``).

Imports nothing GPU-only at module import; the library is built and loaded
at the first launch."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import (WKV_FORMS, bind, check_status, count_launch,
                                 stream_ptr)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MODES = {"none": 0, "all": 1, "last": 2}


def rwkv_wkv_cuda(r, k, v, w, u, state0, states: str):
    """r, k, v, w: (B, T, H, hd); u: (H, hd), contiguous CUDA tensors of one
    dtype, hd 32 or 64; state0: (B, H, hd, hd) float32 or None; checked by
    the caller. Returns y, or (y, float32 states) as ``rwkv_wkv_ref``."""
    B, T, H, hd = r.shape
    y = torch.empty_like(r)
    s_out = None
    if states == "all":
        s_out = torch.empty((B, T, H, hd, hd), dtype=torch.float32,
                            device=r.device)
    elif states == "last":
        s_out = torch.empty((B, H, hd, hd), dtype=torch.float32,
                            device=r.device)
    fn = bind("rwkv_wkv_launch", [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
              + [ctypes.c_void_p])
    status = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), None if state0 is None else state0.data_ptr(),
                y.data_ptr(), None if s_out is None else s_out.data_ptr(),
                B, T, H, hd, _MODES[states], _DTYPES[r.dtype],
                stream_ptr(r.device))
    check_status("rwkv_wkv", status)
    count_launch("rwkv_wkv")
    WKV_FORMS[states] += 1
    return y if s_out is None else (y, s_out)
