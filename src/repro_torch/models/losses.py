"""Training losses. Language models: next-token cross-entropy, the MoE
layers' load-balancing loss (weight ``MOE_AUX_WEIGHT``, at the training
capacity factor ``TRAIN_MOE_CAPACITY``, as the reference trains) and, for
a model with forecast heads, the paper's forecast-KL objective (Eq. 9,
weight ``cfg.forecast_loss_weight``, 0.01), all in float32. The image
ARM: bits per dimension plus the same KL of its ``PixelForecast`` at
weight 0.01 (``pixelcnn_loss``, the joint training of the paper's §4.1).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.forecasting import PixelForecast, TokenForecast
from repro_torch.models.pixelcnn import PixelCNN
from repro_torch.models.transformer import TransformerLM, forecast_config


def next_token_xent(logits, tokens):
    """logits (B, S, V) over the token part of the sequence; tokens (B, S).
    Position s predicts token s+1 (the last position is unused)."""
    tgt = tokens[:, 1:].long()
    lg = logits[:, :-1].float()
    logz = torch.logsumexp(lg, dim=-1)
    true = torch.gather(lg, -1, tgt[..., None])[..., 0]
    return torch.mean(logz - true)


# the reference's ``lm_loss`` defaults, with which it trains: the MoE
# load-balancing weight, and the capacity factor past which training drops
# entries (the inference paths never drop)
MOE_AUX_WEIGHT = 0.01
TRAIN_MOE_CAPACITY = 1.25


def lm_loss(params, cfg, tokens, prefix_embeddings=None,
            remat: bool = False, use_kernel: bool = True):
    """The training loss. Returns (loss, metrics) with ``xent``,
    ``moe_aux``, ``forecast_kl`` (with forecast heads) and ``loss``.
    ``prefix_embeddings`` (B, n_pre, d_model) go before the tokens, and
    their n_pre positions are dropped from the logits and from ``h``
    before the losses. ``use_kernel`` as in ``TransformerLM.apply``."""
    logits, h, aux = TransformerLM.apply(params, cfg, tokens,
                                         prefix_embeddings,
                                         moe_capacity=TRAIN_MOE_CAPACITY,
                                         remat=remat, use_kernel=use_kernel)
    n_pre = 0 if prefix_embeddings is None else prefix_embeddings.shape[1]
    logits, h = logits[:, n_pre:], h[:, n_pre:]
    xent = next_token_xent(logits, tokens)
    loss = xent + MOE_AUX_WEIGHT * aux
    metrics = {"xent": xent, "moe_aux": aux}
    if cfg.forecast_horizon and "forecast" in params:
        fc_logits = TokenForecast.apply(params["forecast"], h,
                                        forecast_config(cfg))
        # arm[s] = the distribution over token s given x_{<s}
        arm = F.pad(logits, (0, 0, 1, 0))[:, :-1]
        kl = TokenForecast.kl_loss(fc_logits, arm)
        loss = loss + cfg.forecast_loss_weight * kl
        metrics["forecast_kl"] = kl
    metrics["loss"] = loss
    return loss, metrics


# the image ARM's forecast-KL weight, as the reference's
# ``benchmarks/common.py:train_pixelcnn`` trains
PIXEL_FORECAST_WEIGHT = 0.01


def pixelcnn_loss(params, fparams, images, cfg, fcfg):
    """Bits per dimension of int ``images`` (B, H, W, C) under the PixelCNN
    ``params``, plus ``PIXEL_FORECAST_WEIGHT`` times the KL of the
    ``PixelForecast`` ``fparams`` over the shared ``h``. Returns (loss,
    metrics) with ``bpd``, ``forecast_kl`` and ``loss``."""
    logits, h = PixelCNN.forward_int(params, images, cfg)
    logp = F.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, images.long()[..., None])
    bpd = -torch.mean(torch.sum(ll, dim=(1, 2, 3, 4))) / (
        cfg.d * math.log(2.0))
    arm = logits.reshape(images.shape[0], cfg.height * cfg.width,
                         cfg.channels, cfg.categories)
    kl = PixelForecast.kl_loss(PixelForecast.apply(fparams, h, fcfg), arm,
                               fcfg)
    loss = bpd + PIXEL_FORECAST_WEIGHT * kl
    return loss, {"bpd": bpd, "forecast_kl": kl, "loss": loss}
