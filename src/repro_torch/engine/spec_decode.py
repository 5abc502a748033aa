"""Token-domain predictive sampling with a KV cache — the paper's
Algorithm 1 as a serving step (windowed verify).

Round layout (per sequence): accepted tokens ``x_0..x_{n-1}``; the verify
window feeds ``[x_{n-1}, c_n, .., c_{n+W-2}]`` (W tokens; candidates c are
forecasts). Output slot t is the reparametrized sample for position
``n+t``: ``o_t = argmax(logits_t + eps_{n+t})``. Slot 0 is always valid;
each further slot is valid while the candidate it was conditioned on
matched, so ``a in [1, W]`` tokens are accepted per round — the tokens of
ancestral sampling, in fewer model calls. Forecasts are fixed-point
iteration (the previous round's outputs past the accept point), and with
``use_forecast_heads`` the learned forecast heads fill the window slots
where those run out (paper §2.4).

Noise is virtual: ``eps[b, p] = Gumbel(fold_in(fold_in(key, seq_id), p))``
is recomputed on demand with the reference's own threefry bits
(``core/random.py``), so a position keeps its noise across rounds and the
port draws the reference's noise from the same key.

Token state is int64 on the port's device. ``verify_round`` also takes
the reference's fault-injection seam (``poison``: a row's logits replaced
with NaN after the model) and its forced-acceptance prefill
(``prompt_len``: window slots on prompt positions accepted as the prompt's
tokens). The engine drives ``poison``; ``prompt_len`` waits for in-loop
adoption (ROADMAP.md §1 item 11), and is held against the reference's.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core import random as jr
from repro_torch.core.device import resolve_device
from repro_torch.core.forecasting import TokenForecast
from repro_torch.core.reparam import reparam_argmax
from repro_torch.kernels.spec_verify.ops import spec_verify
from repro_torch.models.transformer import (PagedView, TransformerLM,
                                            forecast_config)


def _key_words(key, device):
    """An int seed (as ``jax.random.PRNGKey(seed)``) or a pair of uint32
    key words."""
    if isinstance(key, int):
        return jr.prng_key(key, device)
    k1, k2 = (int(x) for x in key)
    return (torch.tensor(k1, dtype=torch.int64, device=device),
            torch.tensor(k2, dtype=torch.int64, device=device))


def make_eps_fn(key, vocab: int) -> Callable:
    """Deterministic per-(noise stream, position) Gumbel noise.

    ``eps_fn(seq_ids (B,), positions (B, W))`` -> float32 (B, W, vocab),
    equal to the reference's ``make_eps_fn(key, vocab)`` up to the rounding
    of ``log`` (``core/random.py``). ``key`` is an int seed or a key pair.
    """
    words = {}

    def eps_fn(seq_ids, positions):
        dev = positions.device
        if dev not in words:
            words[dev] = _key_words(key, dev)
        kb = jr.fold_in(words[dev], seq_ids.long()[:, None])
        kp = jr.fold_in(kb, positions.long())
        return jr.gumbel(kp, vocab)

    return eps_fn


class GenState(NamedTuple):
    tokens: torch.Tensor        # (B, L_max) accepted tokens (prompt + generated)
    n: torch.Tensor             # (B,) accepted length per sequence
    cand: torch.Tensor          # (B, W) next verify window (slot0 = last token)
    cache: dict
    rounds: torch.Tensor        # () total verify rounds (batch-level ARM calls)
    per_seq_calls: torch.Tensor  # (B,) rounds in which the sequence was active
    accept_hist: torch.Tensor   # (B,) total accepted tokens while active
    seq_ids: torch.Tensor       # (B,) noise-stream id per row


class PredictiveSampler:
    """Batched predictive-sampling text generation over a dense cache — the
    solo oracle every serving test compares with.

    ``use_attention_kernel`` runs the mixers' kernels in the prompt prefill
    and every verify round: GQA attention through the dense flash-decode
    op, the RWKV-6 recurrence through the WKV op. It defaults to on on the
    GPU, as the serving engine's; off, the sampler takes the plain routes
    (``_sdpa``, the model-dtype scan)."""

    def __init__(self, cfg, params, window: int = 8, max_len: int = 256,
                 eps_key=0, eps_fn=None, use_forecast_heads: bool = False,
                 use_verify_kernel: bool = False,
                 use_attention_kernel: Optional[bool] = None, device=None):
        self.cfg = cfg
        self.params = params
        self.W = window
        self.max_len = max_len
        self.device = resolve_device(device)
        self.eps_fn = eps_fn if eps_fn is not None else make_eps_fn(
            eps_key, cfg.vocab)
        self.use_forecast_heads = (use_forecast_heads
                                   and "forecast" in params
                                   and cfg.forecast_horizon > 0)
        self.use_verify_kernel = use_verify_kernel
        if use_attention_kernel is None:
            use_attention_kernel = self.device.type == "cuda"
        self.use_attention_kernel = use_attention_kernel

    def init_state(self, prompts, batch: int, seq_ids=None) -> GenState:
        """prompts: (B, L_p) int (one prompt length for the whole batch).
        ``seq_ids`` selects each row's noise stream (default: row index)."""
        cfg, W, dev = self.cfg, self.W, self.device
        prompts = torch.as_tensor(prompts, dtype=torch.int64, device=dev)
        B, L_p = prompts.shape
        assert L_p >= 1
        cache = TransformerLM.init_cache(cfg, B, self.max_len + W,
                                         dtype=cfg.param_dtype, device=dev)
        tokens = torch.zeros((B, self.max_len), dtype=torch.int64, device=dev)
        tokens[:, :L_p] = prompts
        if L_p > 1:
            # prefill the first L_p - 1 tokens (their K/V or recurrent state
            # enter the cache): the state after position L_p - 2
            _, _, cache = TransformerLM.decode_window(
                self.params, cfg, prompts[:, :-1], cache,
                torch.zeros((B,), dtype=torch.int64, device=dev),
                use_kernel=self.use_attention_kernel)
            cache = TransformerLM.select_states(
                cfg, cache, torch.full((B,), L_p - 1, dtype=torch.int64,
                                       device=dev))
        n = torch.full((B,), L_p, dtype=torch.int64, device=dev)
        cand = torch.zeros((B, W), dtype=torch.int64, device=dev)
        cand[:, 0] = prompts[:, -1]
        if seq_ids is None:
            seq_ids = torch.arange(B)
        zeros = torch.zeros((B,), dtype=torch.int64, device=dev)
        return GenState(tokens, n, cand, cache,
                        torch.zeros((), dtype=torch.int64, device=dev),
                        zeros, zeros.clone(),
                        torch.as_tensor(seq_ids, dtype=torch.int64,
                                        device=dev))

    @torch.no_grad()
    def generate(self, prompts, new_tokens: int, seq_ids=None):
        """Generate ``new_tokens`` per sequence. Returns (tokens, stats).
        ``seq_ids`` pins each row to a noise stream (default: row index)."""
        prompts = torch.as_tensor(prompts, dtype=torch.int64)
        B, L_p = prompts.shape
        assert L_p + new_tokens <= self.max_len
        target = torch.full((B,), L_p + new_tokens, dtype=torch.int64,
                            device=self.device)
        state = self.init_state(prompts, B, seq_ids=seq_ids)
        while bool(torch.any(state.n < target)):
            state, _ = verify_round(
                self.params, self.cfg, self.eps_fn, state, target,
                use_forecast_heads=self.use_forecast_heads,
                use_verify_kernel=self.use_verify_kernel,
                use_attention_kernel=self.use_attention_kernel)
        stats = {
            "rounds": int(state.rounds),
            "per_seq_calls": state.per_seq_calls.cpu().numpy(),
            "baseline_calls": new_tokens,
            "mean_accept": float(torch.mean(
                state.accept_hist / state.per_seq_calls.clamp(min=1))),
        }
        return state.tokens, stats


def _forecast_fill(params, cfg, eps_fn, seq_ids, h, a, n_new, cand,
                   valid_fpi):
    """Fill the next window's slots past the FPI forecasts with the learned
    heads' samples. The anchor slot ``min(a, W - 1)`` reads ``h[a - 1]``,
    the last fully valid state; its offset-t logits forecast next-window
    slot t, sampled with that position's own noise."""
    B, W = cand.shape
    T = cfg.forecast_horizon
    fc_logits = TokenForecast.apply(params["forecast"], h,
                                    forecast_config(cfg))  # (B, W, T, V)
    anchor = a.clamp(max=W - 1)
    fc_a = fc_logits[torch.arange(B, device=a.device), anchor]   # (B, T, V)
    s_idx = torch.arange(W, device=a.device)
    eps_next = eps_fn(seq_ids, n_new[:, None] - 1 + s_idx[None, :])
    fc_tok = reparam_argmax(fc_a[:, s_idx.clamp(max=T - 1)], eps_next)
    use_fc = ~valid_fpi & (s_idx[None, :] < T)
    return torch.where(use_fc, fc_tok, cand)


def verify_round(params, cfg, eps_fn, state: GenState, target_len,
                 use_forecast_heads: bool = False,
                 use_verify_kernel: bool = False,
                 paged: Optional[PagedView] = None,
                 use_attention_kernel: bool = False,
                 poison=None, prompt_len=None):
    """One verify round over ``state``; W is ``state.cand.shape[1]``, so
    callers may vary the window round to round (candidates gate only
    acceptance, never token values). ``use_forecast_heads`` fills the
    window slots past the FPI forecasts from ``params["forecast"]``.

    ``state.cache`` is a dense cache, decoded with the mixers' kernels when
    ``use_attention_kernel``, or — with ``paged`` — the paged block pools,
    decoded through the block tables and updated in place (recurrent rows
    adopted in place), with the kernels ``paged.use_kernel`` picks.

    Recurrent states are adopted at ``max(a, 1)``: a row with ``a = 0`` (not
    active) takes the state after ``cand[0]``, one token past its
    snapshot, as the reference does; that is harmless only because such a
    row is done (its state is never read again before the row is cleared
    or reset).

    ``poison`` (B,) int, optional, is the engine's fault-injection seam:
    rows with ``poison > 0`` have their float32 logits replaced with NaN
    after the model, so the K/V the round writes stay finite and the row
    degrades only itself, tripping its ``nonfinite`` column.

    ``prompt_len`` (B,) int, optional, is forced-acceptance prefill: where
    a row's accepted length ``n`` is still inside its prompt, the window
    slots on prompt positions hold the prompt's tokens and are accepted
    without the sampling gate, token writes keep the prompt, and the next
    window carries the prompt's tokens wherever it still covers it. A row
    with ``prompt_len <= n`` is bitwise unaffected, and so is a call with
    ``prompt_len=None``.

    Returns ``(new_state, row_stats)`` where ``row_stats`` is the packed
    (B, 4) int64 per-row vector ``[accepted, done, new_length,
    nonfinite]``; ``nonfinite`` is 1 where a row's logits hold a NaN or an
    infinity (the engine's quarantine signal)."""
    B, W = state.cand.shape
    max_len = state.tokens.shape[1]
    dev = state.n.device
    n = state.n
    active = n < target_len
    cache_len = n - 1
    if paged is None:
        logits, h, new_cache = TransformerLM.decode_window(
            params, cfg, state.cand, state.cache, cache_len,
            use_kernel=use_attention_kernel)
    else:
        logits, h, new_cache = TransformerLM.decode_window_paged(
            params, cfg, state.cand, state.cache, paged, cache_len)
    logits = logits.float()
    if poison is not None:
        logits = torch.where((poison > 0)[:, None, None],
                             torch.full_like(logits, float("nan")), logits)
    nonfinite = (~torch.isfinite(logits).flatten(1).all(dim=1)).long()
    ar = torch.arange(W, device=dev)
    out_pos = n[:, None] + ar[None, :]                    # sampled positions
    eps = eps_fn(state.seq_ids, out_pos)
    if use_verify_kernel:
        out = spec_verify(logits, eps).long()             # (B, W)
    else:
        out = reparam_argmax(logits, eps)

    # accept length: slot t+1 valid while candidate c_{n+t} matched o_t
    match = state.cand[:, 1:] == out[:, :-1]               # (B, W-1)
    if prompt_len is not None:
        # a candidate at a prompt position is the prompt's own token
        match = match | (out_pos[:, :-1] <= prompt_len[:, None] - 1)
    a = 1 + torch.cumprod(match.long(), dim=1).sum(dim=1)
    a = torch.minimum(a, (target_len - n).clamp(min=1))
    a = torch.where(active, a, torch.zeros_like(a))

    # write accepted tokens
    pos = torch.arange(max_len, device=dev)[None, :]
    newly = (pos >= n[:, None]) & (pos < (n + a)[:, None])
    if prompt_len is not None:
        newly = newly & (pos >= prompt_len[:, None])      # keep the prompt
    slot = (pos - n[:, None]).clamp(0, W - 1)
    tokens = torch.where(newly, torch.gather(out, 1, slot), state.tokens)
    n_new = n + a
    sel = TransformerLM.select_states(cfg, new_cache, a.clamp(min=1))
    cache = sel if paged is None else TransformerLM.adopt_states_paged(
        cfg, state.cache, sel, paged.rows)

    # next window: slot 0 = last accepted token; FPI forecasts = this
    # round's outputs past the accept point (paper §2.3)
    idx = (a - 1)[:, None] + ar[None, :]                   # (B, W)
    fpi = torch.gather(out, 1, idx.clamp(0, W - 1))
    valid_fpi = idx <= W - 1
    cand = torch.where(valid_fpi, fpi, torch.zeros_like(fpi))
    if use_forecast_heads:
        cand = _forecast_fill(params, cfg, eps_fn, state.seq_ids, h, a,
                              n_new, cand, valid_fpi)
    if prompt_len is not None:
        # next-window slots still on the prompt carry its tokens
        p = (n_new - 1)[:, None] + ar[None, :]
        prompt_tok = torch.gather(tokens, 1, p.clamp(0, max_len - 1))
        cand = torch.where(p <= prompt_len[:, None] - 1, prompt_tok, cand)
    last_tok = torch.gather(tokens, 1, (n_new - 1).clamp(min=0)[:, None])
    cand = torch.cat([last_tok, cand[:, 1:]], dim=1)
    cand = torch.where(active[:, None], cand, state.cand)
    n_new = torch.where(active, n_new, n)
    tokens = torch.where(active[:, None], tokens, state.tokens)

    new_state = GenState(
        tokens, n_new, cand, cache,
        state.rounds + active.any().long(),
        state.per_seq_calls + active.long(),
        state.accept_hist + a,
        state.seq_ids,
    )
    row_stats = torch.stack(
        [a, (n_new >= target_len).long(), n_new, nonfinite], dim=1)
    return new_state, row_stats
