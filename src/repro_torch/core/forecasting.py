"""Learned forecasting heads for token language models (paper §2.4, the
token-LM adaptation; the modern multi-token-prediction heads, cf.
DeepSeek-V3).

``TokenForecast`` holds one head per forecast offset on the decoder's final
states, shifted so the forecast for position ``s + t`` reads ``h[s - 1]``
(a valid prefix only). The serving path uses its forecasts to fill the
verify window where fixed-point iteration has run out
(``engine/spec_decode.py``). Training fits them with the paper's
objective (Eq. 9, ``kl_loss``):
  ``KL[ stop_grad(P_ARM(x_{s+t} | x_{<s+t})) || P_F^(t)(x_{s+t} | x_{<s}) ]``
down-weighted (0.01 in ``models/losses.py``) so the ARM likelihood is
unaffected; ``h`` is shared and receives the small student-side gradient.
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
