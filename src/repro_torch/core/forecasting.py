"""Learned forecasting modules (paper §2.4, Appendix A.2).

* ``PixelForecast`` — the paper's module: one strictly triangular 3x3
  masked convolution over the image ARM's shared representation ``h``,
  then a 1x1 convolution to ``T * C * K`` channels. The output at pixel
  ``p`` forecasts every channel of pixels ``p .. p+T-1`` from ``h`` at
  pixels strictly before ``p`` (valid samples only).

* ``TokenForecast`` — the token-LM adaptation (the modern multi-token-
  prediction heads, cf. DeepSeek-V3): one head per forecast offset on the
  decoder's final states, shifted so the forecast for position ``s + t``
  reads ``h[s - 1]`` (a valid prefix only). The serving path uses its
  forecasts to fill the verify window where fixed-point iteration has run
  out (``engine/spec_decode.py``).

Both are trained with the paper's objective (Eq. 9, ``kl_loss``):
  ``KL[ stop_grad(P_ARM(x_{i+t} | x_{<i+t})) || P_F^(t)(x_{i+t} | x_{<i}) ]``
down-weighted (0.01, ``models/losses.py``) so the ARM likelihood is
unaffected; ``h`` is shared and receives the small student-side gradient.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.core.device import resolve_device
from repro_torch.nn.core import Conv2D, Dense, MaskedConv2D


# ---------------------------------------------------------------------------
# Image-ARM forecasting module (paper Appendix A.2)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PixelForecastConfig:
    channels: int      # data channels C
    categories: int    # K
    horizon: int       # T, in pixels (paper: 20 MNIST, 1 or 5 otherwise)
    filters: int       # forecasting filters (paper: 60 MNIST, 162 default)
    in_filters: int    # width of the shared ARM representation h


class PixelForecast:
    @staticmethod
    def init(gen, cfg: PixelForecastConfig, dtype=torch.float32,
             device=None):
        device = resolve_device(device)
        kw = dict(dtype=dtype, device=device)
        C, K, T = cfg.channels, cfg.categories, cfg.horizon
        return {
            "tri_conv": MaskedConv2D.init(gen, cfg.in_filters, cfg.filters,
                                          (3, 3), mask_type="T", **kw),
            "out_conv": Conv2D.init(gen, cfg.filters, T * C * K, (1, 1),
                                    **kw),
        }

    @staticmethod
    def apply(params, h, cfg: PixelForecastConfig):
        """h: (B, H, W, F) -> forecast logits (B, H*W, T*C, K). The anchor
        is the pixel (raster index); its window is the T*C flat positions
        from its own first channel on."""
        C, K, T = cfg.channels, cfg.categories, cfg.horizon
        u = F.elu(MaskedConv2D.apply(params["tri_conv"], h))
        out = Conv2D.apply(params["out_conv"], u)          # (B, H, W, T*C*K)
        B, H, W, _ = out.shape
        return out.reshape(B, H * W, T * C, K)

    @staticmethod
    def module_fn(params, cfg: PixelForecastConfig):
        """Batched ``module_fn(h) -> (B, n_anchors, window, K)`` for
        ``predictive_sampling.make_learned_forecast`` (group = C)."""
        return lambda h: PixelForecast.apply(params, h, cfg)

    @staticmethod
    def kl_loss(fc_logits, arm_logits, cfg: PixelForecastConfig):
        """Paper Eq. 9. fc_logits: (B, P, T*C, K) over P = H*W anchors;
        arm_logits: (B, P, C, K), detached (the target gets no gradient).
        The target of anchor p, offset (t, c) is the ARM's distribution at
        pixel p + t, channel c; pairs past the last pixel are masked out of
        the mean."""
        C, K, T = cfg.channels, cfg.categories, cfg.horizon
        B, P = arm_logits.shape[:2]
        dev = arm_logits.device
        tgt = arm_logits.detach()
        idx = (torch.arange(P, device=dev)[:, None]
               + torch.arange(T, device=dev)[None, :])        # (P, T)
        valid = idx < P
        tgt_sh = tgt[:, idx.clamp(max=P - 1)]                  # (B, P, T, C, K)
        fc = fc_logits.reshape(B, P, T, C, K)
        logp_t = F.log_softmax(tgt_sh, dim=-1)
        logp_f = F.log_softmax(fc, dim=-1)
        kl = torch.sum(torch.exp(logp_t) * (logp_t - logp_f), dim=-1)
        w = valid[None, :, :, None].expand(kl.shape).to(kl.dtype)
        return torch.sum(kl * w) / (torch.sum(w) + 1e-9)


# ---------------------------------------------------------------------------
# Token-LM forecasting heads (the LM adaptation; MTP correspondence)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TokenForecastConfig:
    d_model: int
    vocab: int
    horizon: int           # T offsets
    hidden: int = 0        # 0 = linear heads; else bottleneck MLP width


class TokenForecast:
    @staticmethod
    def init(gen, cfg: TokenForecastConfig, dtype=torch.float32,
             device=None):
        kw = dict(dtype=dtype, device=device)
        heads = []
        for _ in range(cfg.horizon):
            if cfg.hidden:
                heads.append({
                    "proj": Dense.init(gen, cfg.d_model, cfg.hidden, **kw),
                    "out": Dense.init(gen, cfg.hidden, cfg.vocab, **kw),
                })
            else:
                heads.append({
                    "out": Dense.init(gen, cfg.d_model, cfg.vocab, **kw)})
        return {"heads": heads}

    @staticmethod
    def apply(params, h, cfg: TokenForecastConfig):
        """h: (B, S, D) decoder states (the state at s encodes x_{<=s}).

        Returns logits (B, S, T, V): position s, offset t forecasts token
        x_{s+t} from h[s-1] (shifted: the valid prefix x_{<s})."""
        h_prev = F.pad(h, (0, 0, 1, 0))[:, :-1]           # h[s-1]
        outs = []
        for head in params["heads"]:
            u = h_prev
            if "proj" in head:
                # jax.nn.gelu's default is the tanh approximation
                u = F.gelu(Dense.apply(head["proj"], u), approximate="tanh")
            outs.append(Dense.apply(head["out"], u))
        return torch.stack(outs, dim=2)

    @staticmethod
    def kl_loss(fc_logits, arm_logits):
        """fc_logits (B, S, T, V); arm_logits (B, S, V), where arm_logits[s]
        is the ARM distribution over x_s given x_{<s} (detached: the target
        gets no gradient). The target of (s, t) is arm_logits[s + t]; pairs
        with s + t past the sequence are masked out of the mean. Computed
        in float32."""
        B, S, T, V = fc_logits.shape
        dev = fc_logits.device
        tgt = arm_logits.detach().float()
        idx = (torch.arange(S, device=dev)[:, None]
               + torch.arange(T, device=dev)[None, :])        # (S, T)
        valid = idx < S
        tgt_sh = tgt[:, idx.clamp(max=S - 1)]                  # (B, S, T, V)
        logp_t = F.log_softmax(tgt_sh, dim=-1)
        logp_f = F.log_softmax(fc_logits.float(), dim=-1)
        kl = torch.sum(torch.exp(logp_t) * (logp_t - logp_f), dim=-1)
        w = valid[None].expand(kl.shape).float()
        return torch.sum(kl * w) / (torch.sum(w) + 1e-9)
