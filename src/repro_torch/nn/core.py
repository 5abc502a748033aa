"""Core layers: Dense, Embedding, RMSNorm, LayerNorm.

As in the reference, layers are namespaces of static functions over plain
dict parameters, so call sites read ``Dense.init`` / ``Dense.apply`` and a
parameter tree converts to and from the JAX one leaf for leaf. Weights
keep JAX's ``(in, out)`` layout: ``Dense.apply`` is ``x @ w``.

Initializers draw from an explicit ``torch.Generator``; they follow the
reference's scales, not its random numbers (tests that compare the two
frameworks load JAX's weights through ``checkpoint.io.params_from_numpy``).
"""
from __future__ import annotations

import math

import torch


def _normal(gen: torch.Generator, shape, dtype, device, std: float):
    # drawn in float32 and then rounded, so every dtype sees one stream
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * std).to(dtype)


def variance_scaling(gen, shape, fan_in=None, scale=1.0,
                     dtype=torch.float32, device=None):
    """LeCun-style variance scaling (plain normal, std sqrt(scale/fan_in))."""
    if fan_in is None:
        fan_in = shape[0] if len(shape) >= 1 else 1
    return _normal(gen, shape, dtype, device,
                   math.sqrt(scale / max(1, fan_in)))


class Dense:
    @staticmethod
    def init(gen, in_dim: int, out_dim: int, use_bias: bool = True,
             dtype=torch.float32, device=None, scale: float = 1.0):
        params = {"w": variance_scaling(gen, (in_dim, out_dim), fan_in=in_dim,
                                        scale=scale, dtype=dtype,
                                        device=device)}
        if use_bias:
            params["b"] = torch.zeros((out_dim,), dtype=dtype, device=device)
        return params

    @staticmethod
    def apply(params, x):
        y = x @ params["w"]
        if "b" in params:
            y = y + params["b"]
        return y


class Embedding:
    @staticmethod
    def init(gen, vocab: int, dim: int, dtype=torch.float32, device=None,
             std: float = 0.02):
        return {"table": _normal(gen, (vocab, dim), dtype, device, std)}

    @staticmethod
    def apply(params, ids):
        return params["table"][ids]

    @staticmethod
    def attend(params, x):
        """Tied-readout logits: x @ table.T"""
        return x @ params["table"].T


class RMSNorm:
    @staticmethod
    def init(dim: int, dtype=torch.float32, device=None):
        return {"scale": torch.ones((dim,), dtype=dtype, device=device)}

    @staticmethod
    def apply(params, x, eps: float = 1e-6):
        dtype = x.dtype
        x32 = x.float()
        var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + eps)
        return (y * params["scale"].float()).to(dtype)


class LayerNorm:
    @staticmethod
    def init(dim: int, dtype=torch.float32, device=None):
        return {"scale": torch.ones((dim,), dtype=dtype, device=device),
                "bias": torch.zeros((dim,), dtype=dtype, device=device)}

    @staticmethod
    def apply(params, x, eps: float = 1e-5):
        """Mean and variance in float32, the result cast back to x's
        dtype (the reference's order of operations)."""
        dtype = x.dtype
        x32 = x.float()
        mu = torch.mean(x32, dim=-1, keepdim=True)
        var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
        y = (x32 - mu) * torch.rsqrt(var + eps)
        return (y * params["scale"].float() + params["bias"].float()).to(
            dtype)
