"""Decoder stack assembled from a ModelConfig: the whole-sequence forward
(``apply``) and verify-window decode (``decode_window``).

The reference lays its layers out as ``prefix + n_blocks * block + suffix``
and runs the homogeneous blocks under ``lax.scan`` over a stacked
``params["blocks"]`` axis. The port unrolls that axis: ``params["layers"]``
is one plain dict per layer, in layer order, and the forward pass is a
Python loop over them (``checkpoint.io.params_from_numpy`` converts the
reference's stacked tree). Caches follow the same layout, one dict per
layer: ``{"mixer": {"k", "v"}}`` for GQA layers, ``{"mixer": {"c_kv",
"k_rope"}}`` for MLA layers, and the per-row recurrent states
``{"mixer": {"x_last", "S"}, "ffn": {"x_last"}}`` for RWKV-6 layers (time
mix and channel mix) and ``{"mixer": {"conv", "h"}}`` for Mamba layers.

Mixers: GQA attention (``attn``, ``local``), MLA (``mla``), the RWKV-6
time mix (``rwkv``) and Mamba-1 (``mamba``); FFNs: dense,
mixture-of-experts (``moe``) and the RWKV-6 channel mix (``rwkv_cmix``);
the learned forecast heads (``params["forecast"]``). In the paged cache
the attention entries are physical block pools shared by all rows, while
recurrent states stay one row per batch slot (they are small and never
shared), so a hybrid stack (jamba) holds both in one cache tree.

``decode_window`` takes the reference's ``state_mode``: "per_position"
(the recurrent state after every window position), "none" (the logits
only; the recurrent entries come back unchanged) and "advance" (only the
state after ``accept`` tokens) — the two passes of the reference's
low-memory verify step (``launch/serve.py:make_serve_step``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.forecasting import TokenForecast, TokenForecastConfig
from repro_torch.models.attention import GQAttention, MLAttention
from repro_torch.models.moe import MoE, _mlp_apply, _mlp_init
from repro_torch.models.ssm import Mamba, RWKV6ChannelMix, RWKV6TimeMix
from repro_torch.nn.core import Dense, Embedding, RMSNorm

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_MIXERS = {"attn": GQAttention, "local": GQAttention, "mla": MLAttention,
           "rwkv": RWKV6TimeMix, "mamba": Mamba}
_RECURRENT = ("rwkv", "mamba")          # mixers with per-row states
STATE_MODES = ("per_position", "none", "advance")
_FFNS = ("dense", "moe", "rwkv_cmix")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                      # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    # layer layout
    layer_prefix: tuple = ()
    layer_block: tuple = (("attn", "dense"),)
    layer_suffix: tuple = ()
    # attention
    qk_norm: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0             # for "local" mixer layers
    # MLP
    mlp_kind: str = "swiglu"            # swiglu|geglu|gelu
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    router_score: str = "softmax"       # softmax|sigmoid
    # MLA
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0
    # SSM
    ssm_state: int = 16
    rwkv_head_dim: int = 64
    # embeddings / head
    tie_embeddings: bool = True
    embed_scale: bool = False           # gemma: h *= sqrt(d_model)
    # forecasting / MTP (the paper's learned-forecasting integration)
    forecast_horizon: int = 0
    forecast_hidden: int = 0
    forecast_loss_weight: float = 0.01
    # multimodal stub frontend
    modality: str = "text"              # text|audio|vision
    n_prefix_tokens: int = 0
    # numerics
    dtype: str = "float32"
    # documentation
    source: str = ""

    @property
    def n_blocks(self) -> int:
        per = len(self.layer_block)
        rem = self.n_layers - len(self.layer_prefix) - len(self.layer_suffix)
        assert rem % per == 0, (self.name, rem, per)
        return rem // per

    @property
    def param_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def layer_specs(self):
        return (list(self.layer_prefix)
                + list(self.layer_block) * self.n_blocks
                + list(self.layer_suffix))


def _check_spec(spec):
    mixer, ffn = spec
    if mixer not in _MIXERS or ffn not in _FFNS:
        raise ValueError(f"unknown layer spec {spec!r}")


def _recurrent_keys(spec) -> list:
    """The keys of a layer's cache entry that hold per-row states."""
    mixer, ffn = spec
    return [k for k, on in (("mixer", mixer in _RECURRENT),
                            ("ffn", ffn == "rwkv_cmix")) if on]


def _recurrent_entries(cfg, cache) -> list:
    """The recurrent state dicts of a cache tree, in layer order: each RWKV
    layer's time-mix and channel-mix states, each Mamba layer's."""
    return [c[k] for spec, c in zip(cfg.layer_specs(), cache["layers"])
            for k in _recurrent_keys(spec)]


def _map_recurrent(cfg, cache, fn):
    """The cache tree with every recurrent leaf replaced by ``fn(leaf)``;
    attention entries are the same tensors."""
    layers = []
    for spec, c in zip(cfg.layer_specs(), cache["layers"]):
        c = dict(c)
        for k in _recurrent_keys(spec):
            c[k] = {name: fn(leaf) for name, leaf in c[k].items()}
        layers.append(c)
    return {"layers": layers}


def has_recurrent(cfg) -> bool:
    return any(m in _RECURRENT or f == "rwkv_cmix"
               for m, f in cfg.layer_specs())


class PagedView(NamedTuple):
    """Block-table addressing for a paged decode step: attention cache
    entries are the shared physical pools and each of the R view rows reads
    and writes through ``tables`` (R, nb) int32; ``rows`` names the R batch
    slots decoded, whose recurrent state rows ride along (an index tensor,
    or a slice, which reads and writes those rows in place). ``use_kernel``
    picks the mixers' kernels: the fused paged-decode kernels (GQA or
    latent) over the gather-view fallback, and the WKV kernel over the
    plain scan."""
    tables: Any
    rows: Any
    use_kernel: bool = False


def _layer_init(gen, spec, cfg: ModelConfig, dtype, device):
    mixer, ffn = spec
    kw = dict(dtype=dtype, device=device)
    p = {"norm1": RMSNorm.init(cfg.d_model, **kw),
         "mixer": _MIXERS[mixer].init(gen, cfg, **kw),
         "norm2": RMSNorm.init(cfg.d_model, **kw)}
    if ffn == "rwkv_cmix":
        p["ffn"] = RWKV6ChannelMix.init(gen, cfg, **kw)
    elif ffn == "moe":
        p["ffn"] = MoE.init(gen, cfg, **kw)
    else:
        p["ffn"] = _mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_kind, dtype,
                             device)
    return p


def _layer_full(p, spec, cfg: ModelConfig, h, use_kernel: bool = True,
                moe_capacity=None):
    """One layer over whole sequences: h (B, T, D) -> (h, the layer's MoE
    aux loss, a float32 scalar, or None without an MoE FFN)."""
    mixer, ffn = spec
    u = RMSNorm.apply(p["norm1"], h)
    if mixer == "mla":
        y = MLAttention.full(p["mixer"], u, cfg)
    elif mixer == "rwkv":
        y = RWKV6TimeMix.full(p["mixer"], u, cfg, use_kernel=use_kernel)
    elif mixer == "mamba":
        y = Mamba.full(p["mixer"], u, cfg)
    else:
        window = cfg.sliding_window if mixer == "local" else 0
        y = GQAttention.full(p["mixer"], u, cfg, window=window,
                             use_kernel=use_kernel)
    h = h + y
    v = RMSNorm.apply(p["norm2"], h)
    if ffn == "rwkv_cmix":
        return h + RWKV6ChannelMix.full(p["ffn"], v, cfg), None
    if ffn == "moe":
        z, aux = MoE.apply(p["ffn"], v, cfg, capacity_factor=moe_capacity)
        return h + z, aux
    return h + _mlp_apply(p["ffn"], v, cfg.mlp_kind), None


def _recurrent_window(mix, p, x, cfg, state, state_mode, accept,
                      last_state_only, **kw):
    """One recurrent mixer (or the RWKV channel mix) over the window in
    ``state_mode``: (y, its new state entry). "none" and "advance" compute
    y with the mixer's last-state form, which keeps no per-position stack
    (the same y as the per-position form's, except where the WKV kernel's
    two forms round it differently on the card); "advance" then recomputes
    the state after ``accept`` tokens."""
    if state_mode == "per_position":
        return mix.window(p, x, cfg, state, last_state_only=last_state_only,
                          **kw)
    y, _ = mix.window(p, x, cfg, state, last_state_only=True, **kw)
    if state_mode == "none":
        return y, state
    return y, mix.advance_state(p, x, cfg, state, accept, **kw)


def _layer_window(p, spec, cfg: ModelConfig, h, cache, cache_len,
                  paged: PagedView | None = None, use_kernel: bool = False,
                  last_state_only: bool = False,
                  state_mode: str = "per_position", accept=None):
    """Returns (h, new_cache) for one layer. Recurrent entries of
    ``new_cache`` hold the state after every window position, or with
    ``last_state_only`` after the last one; ``state_mode`` "none" and
    "advance" as in ``TransformerLM.decode_window``. Recurrent mixers run
    before the ``paged`` branch: their states are per slot, never paged."""
    mixer, ffn = spec
    window = cfg.sliding_window if mixer == "local" else 0
    use_kernel = paged.use_kernel if paged is not None else use_kernel
    u = RMSNorm.apply(p["norm1"], h)
    nc = {}
    rec = (state_mode, accept, last_state_only)
    if mixer == "rwkv":
        y, nc["mixer"] = _recurrent_window(
            RWKV6TimeMix, p["mixer"], u, cfg, cache["mixer"], *rec,
            use_kernel=use_kernel)
    elif mixer == "mamba":
        y, nc["mixer"] = _recurrent_window(Mamba, p["mixer"], u, cfg,
                                           cache["mixer"], *rec)
    elif paged is not None:
        y, nc["mixer"] = _MIXERS[mixer].window_paged(
            p["mixer"], u, cfg, cache["mixer"], paged.tables, cache_len,
            window=window, use_kernel=use_kernel)
    elif mixer == "mla":
        y, nc["mixer"] = MLAttention.window(p["mixer"], u, cfg,
                                            cache["mixer"], cache_len)
    else:
        y, nc["mixer"] = GQAttention.window(p["mixer"], u, cfg,
                                            cache["mixer"], cache_len,
                                            window=window,
                                            use_kernel=use_kernel)
    h = h + y
    v = RMSNorm.apply(p["norm2"], h)
    if ffn == "rwkv_cmix":
        z, nc["ffn"] = _recurrent_window(RWKV6ChannelMix, p["ffn"], v, cfg,
                                         cache["ffn"], *rec)
    elif ffn == "moe":
        # no-drop: a window token's output depends on that token alone
        z, _ = MoE.apply(p["ffn"], v, cfg, capacity_factor=None)
    else:
        z = _mlp_apply(p["ffn"], v, cfg.mlp_kind)
    return h + z, nc


def _layer_cache_init(spec, cfg: ModelConfig, attn_batch: int,
                      rec_batch: int, length: int, dtype, device):
    """One layer's cache: attention entries of ``attn_batch`` rows (dense
    sequences, or physical blocks) of ``length`` slots, recurrent states of
    ``rec_batch`` rows."""
    mixer, ffn = spec
    if mixer in _RECURRENT:
        c = {"mixer": _MIXERS[mixer].init_state(cfg, rec_batch, dtype,
                                                device)}
    else:
        c = {"mixer": _MIXERS[mixer].init_cache(cfg, attn_batch, length,
                                                dtype, device)}
    if ffn == "rwkv_cmix":
        c["ffn"] = RWKV6ChannelMix.init_state(cfg, rec_batch, dtype, device)
    return c


def forecast_config(cfg: ModelConfig) -> TokenForecastConfig:
    """The learned forecast heads' config of a model config."""
    return TokenForecastConfig(cfg.d_model, cfg.vocab, cfg.forecast_horizon,
                               cfg.forecast_hidden)


class TransformerLM:
    @staticmethod
    def init(cfg: ModelConfig, seed: int = 0, device=None):
        """Random weights at the reference's scales, drawn from a
        ``torch.Generator`` seeded with ``seed`` on ``device``."""
        for spec in cfg.layer_specs():
            _check_spec(spec)
        device = torch.device(device) if device is not None else None
        # torch has no generator on the meta device (nothing is drawn there)
        gen_dev = "cpu" if device is None or device.type == "meta" else device
        gen = torch.Generator(device=gen_dev).manual_seed(seed)
        dtype = cfg.param_dtype
        kw = dict(dtype=dtype, device=device)
        params = {"embed": Embedding.init(gen, cfg.vocab, cfg.d_model, **kw)}
        params["layers"] = [_layer_init(gen, spec, cfg, dtype, device)
                            for spec in cfg.layer_specs()]
        params["final_norm"] = RMSNorm.init(cfg.d_model, **kw)
        if not cfg.tie_embeddings:
            params["head"] = Dense.init(gen, cfg.d_model, cfg.vocab,
                                        use_bias=False, **kw)
        if cfg.forecast_horizon:
            params["forecast"] = TokenForecast.init(
                gen, forecast_config(cfg), **kw)
        return params

    # -- shared embedding / head -------------------------------------------
    @staticmethod
    def _embed(params, cfg, tokens, prefix_embeddings=None):
        """Token embeddings (scaled by sqrt(d_model) where ``embed_scale``),
        with the frontend's ``prefix_embeddings`` (B, n_pre, d_model), cast
        to their dtype, placed before them."""
        h = Embedding.apply(params["embed"], tokens)
        if cfg.embed_scale:
            h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype)
        if prefix_embeddings is not None:
            h = torch.cat([prefix_embeddings.to(h.dtype), h], dim=1)
        return h

    @staticmethod
    def _head(params, cfg, h):
        if cfg.tie_embeddings:
            return Embedding.attend(params["embed"], h)
        return Dense.apply(params["head"], h)

    # -- full-sequence forward ----------------------------------------------
    @staticmethod
    def apply(params, cfg: ModelConfig, tokens, prefix_embeddings=None,
              moe_capacity=None, remat: bool = False,
              use_kernel: bool = True):
        """tokens: (B, S) int; ``prefix_embeddings`` (B, n_pre, d_model),
        the multimodal frontend's stand-in, go before them (at positions 0
        .. n_pre - 1 of RoPE). Returns (logits (B, n_pre + S, V), h, aux),
        ``h`` the final-normed states that feed the forecast heads and
        ``aux``
        the MoE layers' load-balancing losses summed (float32; 0 without
        MoE layers). ``moe_capacity=None`` is no-drop MoE (the inference
        default, exact ARM semantics); training passes a finite capacity
        factor. ``remat=True`` checkpoints each layer (its activations are
        recomputed in the backward). ``use_kernel`` routes GQA attention
        on CUDA tensors through the flash-attention kernel
        (``GQAttention.full``) and the RWKV-6 recurrence through the WKV
        kernel (``RWKV6TimeMix.full``, which raises where a gradient is
        needed: the kernel has no backward yet)."""
        for spec in cfg.layer_specs():
            _check_spec(spec)
        h = TransformerLM._embed(params, cfg, tokens, prefix_embeddings)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for p, spec in zip(params["layers"], cfg.layer_specs()):
            if remat:
                h, layer_aux = checkpoint(_layer_full, p, spec, cfg, h,
                                          use_kernel, moe_capacity,
                                          use_reentrant=False)
            else:
                h, layer_aux = _layer_full(p, spec, cfg, h, use_kernel,
                                           moe_capacity)
            if layer_aux is not None:
                aux = aux + layer_aux
        h = RMSNorm.apply(params["final_norm"], h)
        logits = TransformerLM._head(params, cfg, h)
        return logits, h, aux

    # -- caches ---------------------------------------------------------------
    @staticmethod
    def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
                   device=None):
        """Dense caches of ``batch`` sequences of ``max_len`` slots, and the
        recurrent layers' zero states of ``batch`` rows."""
        dtype = dtype or cfg.param_dtype
        for spec in cfg.layer_specs():
            _check_spec(spec)
        return {"layers": [
            _layer_cache_init(spec, cfg, batch, batch, max_len, dtype,
                              device) for spec in cfg.layer_specs()]}

    @staticmethod
    def init_paged_cache(cfg: ModelConfig, batch: int, num_blocks: int,
                         block_size: int, dtype=None, device=None):
        """Physical block pools: every GQA layer holds ``{"k", "v"}:
        (num_blocks, block_size, KV, hd)``, every MLA layer ``{"c_kv":
        (num_blocks, block_size, r), "k_rope": (num_blocks, block_size,
        dr)}``; block 0 is the reserved write sink. Recurrent states are
        not paged: one row per batch slot (``batch`` rows)."""
        dtype = dtype or cfg.param_dtype
        for spec in cfg.layer_specs():
            _check_spec(spec)
        return {"layers": [
            _layer_cache_init(spec, cfg, num_blocks, batch, block_size,
                              dtype, device) for spec in cfg.layer_specs()]}

    # -- verify-window decode -------------------------------------------------
    @staticmethod
    def decode_window(params, cfg: ModelConfig, tokens, cache, cache_len,
                      paged: PagedView | None = None,
                      use_kernel: bool = False,
                      last_state_only: bool = False,
                      state_mode: str = "per_position", accept=None):
        """tokens: (B, W) candidates; cache_len: (B,). Returns
        (logits (B, W, V), h, new_cache). ``use_kernel`` (dense caches; a
        paged view carries its own) runs GQA attention through the dense
        flash-decode op and the RWKV-6 recurrence through the WKV op.

        The recurrent entries of ``new_cache`` by ``state_mode``:
        "per_position" (the default) the state after every window position
        (feed them through ``select_states``), or with ``last_state_only``
        only the state after the last one (prefill); "none" the cache's
        own entries, unchanged (the logits-only first pass of the
        low-memory step); "advance" only the state after ``accept`` (B,)
        tokens, each row's updates frozen from there on (its second
        pass): the state ``select_states`` would pick at ``accept``,
        bitwise on the plain routes."""
        if state_mode not in STATE_MODES or (state_mode == "advance"
                                             and accept is None):
            raise ValueError(f"state_mode={state_mode!r} (accept "
                             f"{'given' if accept is not None else 'None'}"
                             f"); want one of {STATE_MODES}, with accept "
                             "for 'advance'")
        h = TransformerLM._embed(params, cfg, tokens)
        new_layers = []
        for p, spec, c in zip(params["layers"], cfg.layer_specs(),
                              cache["layers"]):
            h, nc = _layer_window(p, spec, cfg, h, c, cache_len, paged,
                                  use_kernel, last_state_only, state_mode,
                                  accept)
            new_layers.append(nc)
        h = RMSNorm.apply(params["final_norm"], h)
        logits = TransformerLM._head(params, cfg, h)
        return logits, h, {"layers": new_layers}

    @staticmethod
    def decode_window_paged(params, cfg: ModelConfig, tokens, paged_cache,
                            view: PagedView, cache_len,
                            last_state_only: bool = False,
                            state_mode: str = "per_position", accept=None):
        """Verify-window decode straight over the physical block pools, which
        are updated in place: no dense K/V view is built on the kernel path,
        and each layer's window K/V is committed by the same launch that
        attends through ``view.tables``. Recurrent state rows are read at
        ``view.rows``. Returns (logits, h, new_cache): the pools for
        attention entries and the new states of the decoded rows for
        recurrent ones (feed them through ``select_states``, unless
        ``last_state_only`` or ``state_mode="advance"``, then
        ``adopt_states_paged``); ``state_mode`` as in ``decode_window``."""
        cache = _map_recurrent(cfg, paged_cache, lambda x: x[view.rows])
        return TransformerLM.decode_window(
            params, cfg, tokens, cache, cache_len.to(torch.int32),
            paged=view, last_state_only=last_state_only,
            state_mode=state_mode, accept=accept)

    @staticmethod
    def adopt_states_paged(cfg: ModelConfig, paged_cache, sel, rows):
        """Merge a paged decode's selected states back into the pool tree,
        in place: attention pools were already written by the window
        writes; recurrent entries copy the selected states into their slot
        rows ``rows`` (no copy of the whole state). Returns
        ``paged_cache``."""
        for dst, src in zip(_recurrent_entries(cfg, paged_cache),
                            _recurrent_entries(cfg, sel)):
            for k, leaf in dst.items():
                leaf[rows] = src[k]
        return paged_cache

    @staticmethod
    def reset_rows(cfg: ModelConfig, cache, rows):
        """Zero the recurrent states of slot rows ``rows`` in place (a slot
        freed or newly admitted starts from the zero state)."""
        for entry in _recurrent_entries(cfg, cache):
            for leaf in entry.values():
                leaf[rows] = 0

    @staticmethod
    def select_states(cfg: ModelConfig, new_cache, accept_idx):
        """Adopt the verify outputs: attention buffers are taken as they are
        (the rewound ``cache_len`` shields stale slots); recurrent
        per-position states are gathered at ``accept_idx - 1`` (B,), the
        state after the last accepted token (index 0 where
        ``accept_idx`` is 0, as in the reference)."""
        B = accept_idx.shape[0]
        ar = torch.arange(B, device=accept_idx.device)
        at = (accept_idx - 1).clamp(min=0)
        return _map_recurrent(cfg, new_cache, lambda x: x[ar, at])
