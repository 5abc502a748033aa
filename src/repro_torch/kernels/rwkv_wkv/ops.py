"""Public WKV op on the model's ``(B, T, H, hd)`` layout.

``u`` is indexed by head in place (the reference tiles it over the batch,
``rwkv_wkv/ops.py``). States go in and out in float32 whatever the model's
dtype: rounded to bfloat16 between calls, the state would lose the decay
(``1 - w`` is near 2^-9, below half a bf16 ulp of the state) and the
result would depend on where calls split the sequence. CPU tensors take
the plain version in ``ref.py``; CUDA tensors launch the kernel or raise:
there is no fallback.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rwkv_wkv.kernel import rwkv_wkv_cuda
from repro_torch.kernels.rwkv_wkv.ref import FORMS, rwkv_wkv_ref

HEAD_DIMS = (32, 64)    # the widths the kernel is compiled for


def rwkv_wkv(r, k, v, w, u, state0=None, states: str = "none"):
    """r, k, v, w: (B, T, H, hd); u: (H, hd); state0: (B, H, hd, hd) float32
    or None (zero state). ``states`` "none" returns y; "all" (y, the state
    after every position, (B, T, H, hd, hd)); "last" (y, the state after
    the last position, (B, H, hd, hd)). y in r's dtype, states in
    float32."""
    if states not in FORMS:
        raise ValueError(f"rwkv_wkv: states={states!r}; want one of {FORMS}")
    ts = [r, k, v, w, u] + ([] if state0 is None else [state0])
    if state0 is not None and state0.dtype != torch.float32:
        raise TypeError(f"rwkv_wkv: state0 is {state0.dtype}; want float32")
    if all(t.device.type == "cpu" for t in ts):
        return rwkv_wkv_ref(r, k, v, w, u, state0, states)
    dev = r.device
    if any(t.device.type != "cuda" or t.device != dev for t in ts):
        raise ValueError(f"rwkv_wkv: tensors on {[str(t.device) for t in ts]}"
                         "; want one CUDA device")
    if any(t.dtype != r.dtype for t in ts[:5]) or r.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError("rwkv_wkv wants r, k, v, w, u of one dtype, float32 "
                        f"or bfloat16: {[t.dtype for t in ts[:5]]}")
    B, T, H, hd = r.shape
    if (hd not in HEAD_DIMS or T < 1 or any(t.shape != r.shape
                                            for t in (k, v, w))
            or u.shape != (H, hd) or (state0 is not None
                                      and state0.shape != (B, H, hd, hd))):
        raise ValueError(
            f"rwkv_wkv: unsupported shapes r {tuple(r.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}, w {tuple(w.shape)}, u "
            f"{tuple(u.shape)}, state0 "
            f"{None if state0 is None else tuple(state0.shape)}")
    r, k, v, w, u = (t.contiguous() for t in (r, k, v, w, u))
    if state0 is not None:
        state0 = state0.contiguous()
    return rwkv_wkv_cuda(r, k, v, w, u, state0, states)
