"""Learning-rate schedules as step -> lr callables. ``step`` is an int32
tensor (the optimizer's counter) and the lr a float32 tensor on its
device, computed in float32 as the reference computes it."""
from __future__ import annotations

import math

import torch


def constant_schedule(lr: float):
    def fn(step):
        return torch.tensor(lr, dtype=torch.float32, device=step.device)
    return fn


def cosine_schedule(peak_lr: float, total_steps: int,
                    final_frac: float = 0.1):
    def fn(step):
        t = torch.clamp(step.float() / max(1, total_steps), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return peak_lr * (final_frac + (1 - final_frac) * cos)
    return fn


def linear_warmup_cosine(peak_lr: float, warmup_steps: int,
                         total_steps: int, final_frac: float = 0.1):
    def fn(step):
        s = step.float()
        warm = s / max(1, warmup_steps)
        t = torch.clamp((s - warmup_steps)
                        / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1.0
                                                     + torch.cos(math.pi * t))
        return peak_lr * torch.where(s < warmup_steps, warm, cos)
    return fn


def exponential_decay(lr0: float, decay: float):
    """The paper's per-iteration multiplicative decay (Appendix A)."""
    def fn(step):
        return lr0 * decay ** step.float()
    return fn
