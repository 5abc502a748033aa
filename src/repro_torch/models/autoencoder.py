"""Discrete-latent autoencoder (paper §4.2, Appendix A.3).

Encoder: two 3x3 convolutions (half width), a strided 4x4 stride-2 (half),
a strided 4x4 stride-2 (full), two residual blocks, and a 1x1 to
``C_lat * K`` logits. Quantization: the argmax of the softmax, one-hot,
with a straight-through gradient. The decoder mirrors the encoder with
transposed 4x4 stride-2 convolutions. Loss: MSE (the rate term belongs to
the separately trained latent ARM, two-phase training as in the paper).
Activations are NHWC, as in ``nn/core.py``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.core.device import resolve_device
from repro_torch.nn.core import Conv2D


@dataclass(frozen=True)
class AutoencoderConfig:
    height: int = 32
    width: int = 32
    channels: int = 3          # image channels
    width_filters: int = 512   # the "width" parameter (paper: 512)
    latent_channels: int = 4   # C_lat (paper: 4)
    latent_categories: int = 128  # K (paper: 128)

    @property
    def latent_hw(self) -> tuple[int, int]:
        return self.height // 4, self.width // 4


def _resblock_init(gen, ch, **kw):
    return {"conv1": Conv2D.init(gen, ch, ch, (3, 3), **kw),
            "conv2": Conv2D.init(gen, ch, ch, (3, 3), **kw)}


def _resblock_apply(params, x):
    u = F.relu(Conv2D.apply(params["conv1"], F.relu(x)))
    return x + Conv2D.apply(params["conv2"], u)


class DiscreteAutoencoder:
    @staticmethod
    def init(gen, cfg: AutoencoderConfig, dtype=torch.float32, device=None):
        kw = dict(dtype=dtype, device=resolve_device(device))
        W, hw = cfg.width_filters, cfg.width_filters // 2
        CL, K = cfg.latent_channels, cfg.latent_categories
        enc = {
            "c1": Conv2D.init(gen, cfg.channels, hw, (3, 3), **kw),
            "c2": Conv2D.init(gen, hw, hw, (3, 3), **kw),
            "s1": Conv2D.init(gen, hw, hw, (4, 4), **kw),
            "s2": Conv2D.init(gen, hw, W, (4, 4), **kw),
            "r1": _resblock_init(gen, W, **kw),
            "r2": _resblock_init(gen, W, **kw),
            "head": Conv2D.init(gen, W, CL * K, (1, 1), **kw),
        }
        dec = {
            "embed": Conv2D.init(gen, CL * K, W, (1, 1), **kw),
            "r1": _resblock_init(gen, W, **kw),
            "r2": _resblock_init(gen, W, **kw),
            "t1": Conv2D.init(gen, W, hw, (4, 4), **kw),
            "t2": Conv2D.init(gen, hw, hw, (4, 4), **kw),
            "c1": Conv2D.init(gen, hw, hw, (3, 3), **kw),
            "c2": Conv2D.init(gen, hw, cfg.channels, (3, 3), **kw),
        }
        return {"enc": enc, "dec": dec}

    @staticmethod
    def encode_logits(params, x, cfg: AutoencoderConfig):
        """x: (B, H, W, C) float in [-1, 1] -> latent logits
        (B, h, w, CL, K)."""
        e = params["enc"]
        u = F.relu(Conv2D.apply(e["c1"], x))
        u = F.relu(Conv2D.apply(e["c2"], u))
        u = F.relu(Conv2D.apply(e["s1"], u, stride=(2, 2)))
        u = F.relu(Conv2D.apply(e["s2"], u, stride=(2, 2)))
        u = _resblock_apply(e["r1"], u)
        u = _resblock_apply(e["r2"], u)
        logits = Conv2D.apply(e["head"], u)
        B, h, w, _ = logits.shape
        return logits.reshape(B, h, w, cfg.latent_channels,
                              cfg.latent_categories)

    @staticmethod
    def quantize(logits):
        """Straight-through argmax of the softmax: (z_int, z_onehot_st)."""
        z = torch.argmax(logits, dim=-1)
        hard = F.one_hot(z, logits.shape[-1]).to(logits.dtype)
        soft = torch.softmax(logits, dim=-1)
        return z, soft + (hard - soft).detach()

    @staticmethod
    def decode(params, z_onehot, cfg: AutoencoderConfig):
        """z_onehot: (B, h, w, CL, K) -> reconstruction (B, H, W, C)."""
        d = params["dec"]
        B, h, w, CL, K = z_onehot.shape
        u = Conv2D.apply(d["embed"], z_onehot.reshape(B, h, w, CL * K))
        u = _resblock_apply(d["r1"], u)
        u = _resblock_apply(d["r2"], u)
        u = F.relu(Conv2D.apply(d["t1"], u, stride=(2, 2), transpose=True))
        u = F.relu(Conv2D.apply(d["t2"], u, stride=(2, 2), transpose=True))
        u = F.relu(Conv2D.apply(d["c1"], u))
        return torch.tanh(Conv2D.apply(d["c2"], u))

    @staticmethod
    def reconstruct(params, x, cfg: AutoencoderConfig):
        logits = DiscreteAutoencoder.encode_logits(params, x, cfg)
        z, st = DiscreteAutoencoder.quantize(logits)
        return DiscreteAutoencoder.decode(params, st, cfg), z

    @staticmethod
    def mse_loss(params, x, cfg: AutoencoderConfig):
        xhat, _ = DiscreteAutoencoder.reconstruct(params, x, cfg)
        return torch.mean(torch.square(x - xhat))
