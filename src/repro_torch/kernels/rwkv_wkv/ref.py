"""Plain PyTorch version of the RWKV-6 WKV kernel: the recurrence

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

with the state in float32, as the reference's ``rwkv_wkv/ref.py``, in the
model's layout (r, k, v, w ``(B, T, H, hd)``, u ``(H, hd)``). Beyond the
reference's zero-state form it takes an initial state and returns the
state after every position or after the last one, the three forms of the
CUDA kernel. y is in r's dtype; states go in and out in float32, so a
recurrence split over several calls equals one call over the whole
sequence.
"""
from __future__ import annotations

import torch

FORMS = ("none", "all", "last")


def rwkv_wkv_ref(r, k, v, w, u, state0=None, states: str = "none"):
    """r, k, v, w: (B, T, H, hd); u: (H, hd); state0: (B, H, hd, hd) float32
    or None for the zero state. ``states``: "none" returns y (B, T, H, hd);
    "all" returns (y, the float32 state after every position
    (B, T, H, hd, hd)); "last" returns (y, the float32 state after the last
    position (B, H, hd, hd))."""
    if states not in FORMS:
        raise ValueError(f"states={states!r}; want one of {FORMS}")
    B, T, H, hd = r.shape
    r32, k32, v32, w32 = (a.float() for a in (r, k, v, w))
    u32 = u.float()[None, :, :, None]                     # (1, H, hd, 1)
    S = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
         if state0 is None else state0.float())
    if r.device.type == "meta":
        # only shapes exist on the meta device (the dry run): no loop
        y = torch.empty((B, T, H, hd), dtype=r.dtype, device=r.device)
        return {"none": y, "all": (y, S.new_empty((B, T, H, hd, hd))),
                "last": (y, S)}[states]
    ys, Ss = [], []
    for t in range(T):
        kv = k32[:, t, :, :, None] * v32[:, t, :, None, :]  # (B, H, hd, hd)
        ys.append(torch.einsum("bhk,bhkv->bhv", r32[:, t], S + u32 * kv))
        S = w32[:, t, :, :, None] * S + kv
        if states == "all":
            Ss.append(S)
    y = torch.stack(ys, dim=1).to(r.dtype)
    if states == "none":
        return y
    if states == "all":
        return y, torch.stack(Ss, dim=1)
    return y, S
