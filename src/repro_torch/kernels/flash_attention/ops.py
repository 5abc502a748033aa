"""Public causal flash-attention op of the training path, with its
gradient.

``flash_attention(q, k, v, window)`` is a ``torch.autograd.Function``. Its
forward is the CUDA kernel on CUDA tensors and the plain version in
``ref.py`` on CPU or meta tensors; it raises on anything else (a device mix, a
dtype other than float32 or bfloat16, a head width other than 64, 128 or
256 on the card). Its backward is the exact vector-Jacobian product of that function,
written in torch ops from the saved ``(q, k, v, o, lse)``: the reference
has no backward kernel (its gradient is XLA autodiff outside Pallas), so
none is owed here; a hand-written one is later work (ROADMAP.md §2).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import plain_here
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import (causal_mask,
                                                     compute_dtype,
                                                     flash_attention_ref)

HEAD_DIMS = (64, 128, 256)  # the widths the kernel is compiled for
BWD_CHUNK = 512         # query rows per step of the backward


def flash_attention_fwd(q, k, v, window: int = 0):
    """q: (B, T, H, d); k, v: (B, T, KV, d). Returns (o (B, T, H, d) in q's
    dtype, lse (B, H, T) float32), without autograd."""
    B, T, H, d = q.shape
    if k.ndim != 4 or k.shape[:2] != (B, T) or k.shape[3] != d \
            or v.shape != k.shape or H % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if plain_here("flash_attention", q, k, v):
        return flash_attention_ref(q, k, v, window=window)
    if any(t.device.type != "cuda" or t.device != q.device
           for t in (k, v)) or q.device.type != "cuda":
        raise ValueError("flash_attention: tensors on "
                         f"{[str(t.device) for t in (q, k, v)]}; want one "
                         "CUDA device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError("flash_attention wants one dtype, float32 or "
                        f"bfloat16: {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head width {d}; the kernel is "
                         f"compiled for {HEAD_DIMS}")
    return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                v.contiguous(), window=window,
                                scale=1.0 / d ** 0.5)


def flash_attention_bwd(q, k, v, o, lse, do, window: int = 0,
                        chunk: int = BWD_CHUNK):
    """The VJP of ``flash_attention_fwd`` at (q, k, v) for the output
    cotangent ``do``, in float32 (float64 for float64 inputs), over query
    chunks of ``chunk`` rows: each chunk recomputes its scores against the
    keys it can see, ``p = exp(s - lse)``, and accumulates
    ``dv += pᵀ do``, ``ds = p (do vᵀ - rowsum(do ∘ o))``,
    ``dq = ds k / √d``, ``dk += dsᵀ q / √d``. Returns (dq, dk, dv) in the
    inputs' dtypes."""
    B, T, H, d = q.shape
    KV = k.shape[2]
    G = H // KV
    ct = compute_dtype(q.dtype)
    scale = 1.0 / d ** 0.5
    kf, vf = k.to(ct), v.to(ct)
    dk = torch.zeros(kf.shape, dtype=ct, device=q.device)
    dv = torch.zeros(vf.shape, dtype=ct, device=q.device)
    dq = torch.empty_like(q)
    delta = (do.to(ct) * o.to(ct)).sum(-1)                   # (B, T, H)
    lse = lse.to(ct)
    pos = torch.arange(T, device=q.device)
    for c0 in range(0, T, chunk):
        c1 = min(T, c0 + chunk)
        n = c1 - c0
        k_lo = max(0, c0 - window + 1) if window > 0 else 0
        qc = q[:, c0:c1].to(ct).reshape(B, n, KV, G, d)
        doc = do[:, c0:c1].to(ct).reshape(B, n, KV, G, d)
        kc, vc = kf[:, k_lo:c1], vf[:, k_lo:c1]
        s = torch.einsum("bqkgd,bskd->bkgqs", qc, kc) * scale
        lse_c = lse[:, :, c0:c1].reshape(B, KV, G, n, 1)
        mask = causal_mask(pos[c0:c1], pos[k_lo:c1], window)
        p = torch.where(mask, torch.exp(s - lse_c), torch.zeros_like(s))
        dv[:, k_lo:c1] += torch.einsum("bkgqs,bqkgd->bskd", p, doc)
        dp = torch.einsum("bqkgd,bskd->bkgqs", doc, vc)
        delta_c = (delta[:, c0:c1].reshape(B, n, KV, G)
                   .permute(0, 2, 3, 1)[..., None])
        ds = p * (dp - delta_c)
        dq[:, c0:c1] = (torch.einsum("bkgqs,bskd->bqkgd", ds, kc) * scale
                        ).reshape(B, n, H, d).to(q.dtype)
        dk[:, k_lo:c1] += torch.einsum("bkgqs,bqkgd->bskd", ds, qc) * scale
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, window):
        o, lse = flash_attention_fwd(q, k, v, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.window = window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.window)
        return dq, dk, dv, None


def flash_attention(q, k, v, window: int = 0):
    """Causal (optionally sliding-window) attention of q (B, T, H, d) over
    k, v (B, T, KV, d), kv head ``h // (H / KV)``; differentiable in q, k
    and v. Returns (B, T, H, d) in q's dtype."""
    return _FlashAttention.apply(q, k, v, window)
