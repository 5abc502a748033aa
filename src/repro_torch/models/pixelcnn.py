"""PixelCNN ARM with a fully categorical, channel-autoregressive output
(paper Appendix A.1): masked convolutions (mask A on the input, mask B
inside), gated residual blocks with concat_elu, a one-hot input, and a
categorical distribution per (row, column, channel) in raster order with
the channel-minor flat index ``i = (h*W + w)*C + c``.

``apply`` returns ``(logits, h)``, where ``h`` is the representation that
the forecasting module shares (paper §2.2); ``make_arm_fn`` gives the flat
ARM interface of ``core/predictive_sampling.py``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.device import resolve_device
from repro_torch.nn.core import MaskedConv2D, concat_elu, group_ids


@dataclass(frozen=True)
class PixelCNNConfig:
    height: int = 28
    width: int = 28
    channels: int = 1
    categories: int = 2           # K (2 = binary MNIST; 32 = 5-bit; 256 = 8-bit)
    filters: int = 60             # per-layer filters (paper: 60 MNIST, 162 default)
    n_res: int = 2                # gated residual blocks (paper: 2 MNIST, 5 default)
    kernel: int = 3
    first_kernel: int = 7

    @property
    def d(self) -> int:
        return self.height * self.width * self.channels

    def flat_to_chw(self, i):
        """flat index -> (c, h, w) under channel-minor raster order."""
        c = i % self.channels
        p = i // self.channels
        return c, p // self.width, p % self.width


class PixelCNN:
    @staticmethod
    def init(gen, cfg: PixelCNNConfig, dtype=torch.float32, device=None):
        """Parameters drawn from ``gen`` (a generator on ``device``, which
        ``None`` resolves to the GPU)."""
        device = resolve_device(device)
        C, K, F_ = cfg.channels, cfg.categories, cfg.filters
        assert F_ % C == 0, "filters must be divisible by channels"
        kw = dict(dtype=dtype, device=device)
        g_in = np.repeat(np.arange(C), K)     # one-hot input: group = channel
        g_f = group_ids(F_, C)
        g_2f = np.concatenate([g_f, g_f])     # concat_elu duplicates groups
        params = {
            "in_conv": MaskedConv2D.init(
                gen, C * K, F_, (cfg.first_kernel, cfg.first_kernel),
                mask_type="A", groups_in=g_in, groups_out=g_f, **kw),
            "res": [],
        }
        for _ in range(cfg.n_res):
            params["res"].append({
                "conv1": MaskedConv2D.init(
                    gen, 2 * F_, F_, (cfg.kernel, cfg.kernel),
                    mask_type="B", groups_in=g_2f, groups_out=g_f, **kw),
                "conv2": MaskedConv2D.init(
                    gen, 2 * F_, 2 * F_, (cfg.kernel, cfg.kernel),
                    mask_type="B", groups_in=g_2f, groups_out=g_2f, **kw),
            })
        params["out_conv"] = MaskedConv2D.init(
            gen, 2 * F_, C * K, (1, 1), mask_type="B", groups_in=g_2f,
            groups_out=g_in, **kw)
        return params

    @staticmethod
    def apply(params, x_onehot, cfg: PixelCNNConfig):
        """x_onehot: (B, H, W, C*K) float. Returns (logits (B, H, W, C, K),
        h (B, H, W, F)); h is the last residual block's output."""
        C, K = cfg.channels, cfg.categories
        u = MaskedConv2D.apply(params["in_conv"], x_onehot)
        for blk in params["res"]:
            v = MaskedConv2D.apply(blk["conv1"], concat_elu(u))
            v = MaskedConv2D.apply(blk["conv2"], concat_elu(v))
            a, b = torch.chunk(v, 2, dim=-1)
            u = u + a * torch.sigmoid(b)
        logits = MaskedConv2D.apply(params["out_conv"], concat_elu(u))
        B, H, W, _ = logits.shape
        return logits.reshape(B, H, W, C, K), u

    @staticmethod
    def onehot(x_int, cfg: PixelCNNConfig):
        """(B, H, W, C) int -> (B, H, W, C*K) one-hot float32."""
        oh = F.one_hot(x_int.long(), cfg.categories).float()
        B, H, W, C, K = oh.shape
        return oh.reshape(B, H, W, C * K)

    @staticmethod
    def forward_int(params, x_int, cfg: PixelCNNConfig):
        return PixelCNN.apply(params, PixelCNN.onehot(x_int, cfg), cfg)

    @staticmethod
    def log_likelihood(params, x_int, cfg: PixelCNNConfig):
        """Log-likelihood (nats per image) of int images (B, H, W, C)."""
        logits, _ = PixelCNN.forward_int(params, x_int, cfg)
        logp = F.log_softmax(logits, dim=-1)
        ll = torch.gather(logp, -1, x_int.long()[..., None])[..., 0]
        return torch.sum(ll, dim=(1, 2, 3))

    @staticmethod
    def bpd(params, x_int, cfg: PixelCNNConfig):
        """Bits per dimension."""
        ll = PixelCNN.log_likelihood(params, x_int, cfg)
        return -torch.mean(ll) / (cfg.d * math.log(2.0))

    @staticmethod
    def make_arm_fn(params, cfg: PixelCNNConfig):
        """``arm_fn(x_flat (B, d) int) -> (logits (B, d, K), h)`` with
        strict triangular dependence in the channel-minor raster order.
        ``arm_fn.h_shape(B)`` is the shape of ``h`` for a batch of B, so a
        sampler can build its zero ``h`` without a forward pass."""
        C, H, W = cfg.channels, cfg.height, cfg.width

        def arm_fn(x_flat):
            B = x_flat.shape[0]
            logits, h = PixelCNN.forward_int(
                params, x_flat.reshape(B, H, W, C), cfg)
            return logits.reshape(B, cfg.d, cfg.categories), h

        arm_fn.h_shape = lambda B: (B, H, W, cfg.filters)
        return arm_fn
