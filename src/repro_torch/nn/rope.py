"""Rotary position embeddings (RoPE), split-half convention."""
from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, theta: float = 10000.0, device=None):
    """Inverse frequencies for RoPE over ``head_dim`` (must be even)."""
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x, positions, theta: float = 10000.0):
    """Apply RoPE to ``x`` of shape (..., seq, heads, head_dim).

    ``positions``: int tensor broadcastable to (..., seq). Angles are
    float32, as in the reference; the split-half (rotate_half) convention
    of Llama/Gemma/Qwen.
    """
    inv_freq = rope_frequencies(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].float() * inv_freq   # (..., seq, half)
    angles = angles[..., None, :]                       # (..., seq, 1, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)
