"""Predictive sampling (paper Algorithms 1 and 2), batched, in PyTorch.

The ARM is ``arm_fn(x) -> (logits, h)`` over flattened int sequences
``x: (B, d)`` with strict triangular dependence: ``logits[:, p]`` (the
distribution over x_p) depends only on ``x[:, :p]``. ``h`` is the shared
penultimate representation (paper §2.2), handed to the forecasts at no
extra cost. ``arm_fn.h_shape(B)`` gives its shape, so Algorithm 1 starts
from a zero ``h`` without a forward pass (``PixelCNN.make_arm_fn`` sets
it).

A forecast takes the whole batch,
    ``forecast_fn(x (B, d), h, prev_out (B, d), eps (B, d, K), i (B,))
    -> (B, d)`` int forecasts,
and positions below a row's ``i`` are ignored. The reference writes them
per sample and vmaps them; these are the same functions over the batch.

``predictive_sample`` is Algorithm 1 over any forecast; with
``fpi_forecast`` it is ARM fixed-point iteration (Algorithm 2 with an
early exit; ``fixed_point_sample`` is the literal Algorithm 2).

Every row computes every call, finished rows too, and keeps them out of
the result only through ``where``, so ``arm_calls``, ``per_sample_calls``
and ``converge_iter`` are the reference's. The loop reads one flag from
the device per ARM call (``any(i < d)``, or Algorithm 2's ``changed``).

Exactness: with shared Gumbel noise ``eps``, every sampler here returns
the samples of ancestral sampling bit for bit, provided the ARM's logits
at a position do not change, bit for bit, with the inputs from that
position on. Integers are int64 (the reference's are int32).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.reparam import reparam_argmax


class SampleStats(NamedTuple):
    """Bookkeeping of a sampling run.

    arm_calls:        int — batched ARM forward passes (the paper's
                      headline metric; the slowest sample sets it).
    per_sample_calls: (B,) — ARM calls until each sample finished.
    converge_iter:    (B, d) — the call at which each position became
                      valid (paper Figure 6).
    """
    arm_calls: int
    per_sample_calls: torch.Tensor
    converge_iter: torch.Tensor


# ---------------------------------------------------------------------------
# Forecasting functions (paper §2.2, §2.3, §4.1 baselines)
# ---------------------------------------------------------------------------

def fpi_forecast(x, h, prev_out, eps, i):
    """ARM fixed-point iteration (§2.3): reuse the previous ARM outputs."""
    return prev_out


def zeros_forecast(x, h, prev_out, eps, i):
    """Baseline 'Forecast zeros' (Table 1)."""
    return torch.zeros_like(prev_out)


def predict_last_forecast(x, h, prev_out, eps, i):
    """Baseline 'Predict last' (Table 1): repeat x_{i-1} everywhere."""
    last = torch.gather(x, 1, (i - 1).clamp(min=0)[:, None])
    last = torch.where(i[:, None] > 0, last, torch.zeros_like(last))
    return last.expand_as(prev_out)


def make_learned_forecast(module_fn, window: int, group: int = 1):
    """Learned forecasting (§2.4).

    ``module_fn(h) -> (B, n_anchors, window, K)`` logits, where anchor
    ``a`` (which sees h only from before anchor ``a``) forecasts the flat
    positions ``[a*group, a*group + window)``: ``group == 1`` for token
    models, ``group == C`` for channel-autoregressive images (anchor =
    pixel, window = T * C). Positions past the window keep the ARM's own
    outputs. The forecast is reparametrized with the verifier's eps
    (Eq. 10). (The reference's Table-3 ablation switches, plain argmax and
    a module over x, have no caller in the port.)

    A finished row has ``i == d``, one anchor past the last: its anchor is
    clamped to the last one, as ``jax.lax.dynamic_index_in_dim`` clamps,
    and its window is empty.
    """
    def forecast(x, h, prev_out, eps, i):
        B, d = prev_out.shape
        fc_logits = module_fn(h)
        a = i // group                                           # (B,)
        a_idx = a.clamp(max=fc_logits.shape[1] - 1)
        logits_a = fc_logits[torch.arange(B, device=a.device), a_idx]
        pos = torch.arange(d, device=prev_out.device)[None, :]
        start = (a * group)[:, None]
        off = (pos - start).clamp(0, window - 1)                 # (B, d)
        lg = torch.gather(logits_a, 1, off[..., None].expand(
            B, d, logits_a.shape[-1]))                           # (B, d, K)
        cand = reparam_argmax(lg, eps)
        in_window = (pos >= i[:, None]) & (pos < start + window)
        return torch.where(in_window, cand, prev_out)

    return forecast


# ---------------------------------------------------------------------------
# Naive ancestral sampling (the baseline: d ARM calls)
# ---------------------------------------------------------------------------

def ancestral_sample(arm_fn: Callable, eps: torch.Tensor):
    """Sequential reference sampler: ``x_p = argmax(mu_p(x_{<p}) + eps_p)``.

    eps: (B, d, K). Returns (x, stats) with ``arm_calls == d``.
    """
    B, d, K = eps.shape
    dev = eps.device
    x = torch.zeros((B, d), dtype=torch.int64, device=dev)
    for p in range(d):
        logits, _ = arm_fn(x)
        x[:, p] = reparam_argmax(logits[:, p], eps[:, p])
    stats = SampleStats(
        arm_calls=d,
        per_sample_calls=torch.full((B,), d, dtype=torch.int64, device=dev),
        converge_iter=torch.arange(d, device=dev).expand(B, d).clone())
    return x, stats


# ---------------------------------------------------------------------------
# Predictive sampling (Algorithm 1, over any forecast)
# ---------------------------------------------------------------------------

def predictive_sample(arm_fn: Callable, forecast_fn: Callable,
                      eps: torch.Tensor, max_iters: int | None = None):
    """Algorithm 1. eps: (B, d, K) Gumbel noise (the reparametrization).

    Each iteration costs ONE batched ARM call and ends within d of them:
    strict triangular dependence makes position i valid after every call,
    so i advances by at least one.
    """
    B, d, K = eps.shape
    max_iters = d if max_iters is None else max_iters
    dev = eps.device
    pos = torch.arange(d, device=dev)[None, :]

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int64, device=dev)

    # the initial forecast is the zero vector (paper §2.2): prev_out = 0
    # and h = 0 serve every forecast at i = 0
    x, prev_out, conv = zeros(B, d), zeros(B, d), zeros(B, d)
    i, per_calls = zeros(B), zeros(B)
    h = torch.zeros(arm_fn.h_shape(B), dtype=eps.dtype, device=dev)
    n = 0
    while n < max_iters and bool((i < d).any()):
        fc = forecast_fn(x, h, prev_out, eps, i)
        xin = torch.where(pos < i[:, None], x, fc)
        logits, h = arm_fn(xin)                      # ONE batched ARM call
        out = reparam_argmax(logits, eps)            # (B, d)
        # accept the run of positions >= i whose forecast equals the
        # output; the output at the first mismatch is valid too
        match = (xin == out) | (pos < i[:, None])
        first_bad = torch.where(match.all(dim=1), d,
                                (~match).to(torch.int8).argmax(dim=1))
        new_i = torch.clamp(torch.maximum(first_bad + 1, i), max=d)
        new_i = torch.where(i >= d, i, new_i)        # finished rows stay
        x = torch.where(pos < new_i[:, None], out, x)
        n += 1
        per_calls = per_calls + (i < d).long()
        newly = (pos >= i[:, None]) & (pos < new_i[:, None])
        conv = torch.where(newly, n, conv)
        prev_out, i = out, new_i
    return x, SampleStats(n, per_calls, conv)


# ---------------------------------------------------------------------------
# ARM fixed-point iteration in its literal Algorithm-2 form
# ---------------------------------------------------------------------------

def fixed_point_sample(arm_fn: Callable, eps: torch.Tensor,
                       max_iters: int | None = None):
    """Algorithm 2: iterate ``x <- g(x, eps)`` until a fixed point.

    The samples of ``predictive_sample(..., fpi_forecast)``; the call count
    differs by at most one (Algorithm 2 pays one more pass to observe the
    fixed point, Algorithm 1 exits once the valid prefix covers d).
    """
    B, d, K = eps.shape
    max_iters = (d + 1) if max_iters is None else max_iters

    def g(x):
        logits, _ = arm_fn(x)
        return reparam_argmax(logits, eps)

    x = g(torch.zeros((B, d), dtype=torch.int64, device=eps.device))
    n, changed = 1, True
    conv = torch.ones((B, d), dtype=torch.int64, device=eps.device)
    while changed and n < max_iters:
        x_new = g(x)
        n += 1
        diff = x_new != x
        conv = torch.where(diff, n, conv)
        changed = bool(diff.any())
        x = x_new
    # each sample is done one pass after its last change
    per = conv.max(dim=1).values + 1
    return x, SampleStats(n, torch.clamp(per, max=n), conv)
