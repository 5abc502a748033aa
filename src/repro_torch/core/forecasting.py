"""Learned forecasting heads for token language models (paper §2.4, the
token-LM adaptation; the modern multi-token-prediction heads, cf.
DeepSeek-V3).

``TokenForecast`` holds one head per forecast offset on the decoder's final
states, shifted so the forecast for position ``s + t`` reads ``h[s - 1]``
(a valid prefix only). The serving path uses its forecasts to fill the
verify window where fixed-point iteration has run out
(``engine/spec_decode.py``); the paper's training objective (``kl_loss``
in the reference) belongs to the training slice (ROADMAP.md §1 item 19).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.nn.core import Dense


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
