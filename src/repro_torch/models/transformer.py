"""Decoder stack assembled from a ModelConfig: the whole-sequence forward
of training (``apply``) and verify-window decode (``decode_window``).

The reference lays its layers out as ``prefix + n_blocks * block + suffix``
and runs the homogeneous blocks under ``lax.scan`` over a stacked
``params["blocks"]`` axis. The port unrolls that axis: ``params["layers"]``
is one plain dict per layer, in layer order, and the forward pass is a
Python loop over them (``checkpoint.io.params_from_numpy`` converts the
reference's stacked tree). Caches follow the same layout:
``{"layers": [{"mixer": {"k", "v"}}, ...]}`` for GQA layers and
``{"mixer": {"c_kv", "k_rope"}}`` for MLA layers.

The port covers the attention mixers (``attn``, ``local``) and MLA
(``mla``) with dense FFNs, and the learned forecast heads
(``params["forecast"]``); the other mixers and MoE FFNs raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.forecasting import TokenForecast, TokenForecastConfig
from repro_torch.models.attention import GQAttention, MLAttention
from repro_torch.models.moe import _mlp_apply, _mlp_init
from repro_torch.nn.core import Dense, Embedding, RMSNorm

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_LATER = {"mamba": "item 15", "rwkv": "item 15", "moe": "item 14",
          "rwkv_cmix": "item 15"}
_MIXERS = {"attn": GQAttention, "local": GQAttention, "mla": MLAttention}


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
    for part in (mixer, ffn):
        if part in _LATER:
            raise NotImplementedError(
                f"layer kind {part!r} is not ported yet "
                f"(ROADMAP.md §1 {_LATER[part]})")
    if mixer not in _MIXERS or ffn != "dense":
        raise ValueError(f"unknown layer spec {spec!r}")


class PagedView(NamedTuple):
    """Block-table addressing for a paged decode step: attention cache
    entries are the shared physical pools and each of the R view rows reads
    and writes through ``tables`` (R, nb) int32; ``rows`` (R,) names the
    batch slots decoded. ``use_kernel`` picks the fused paged-decode
    kernels (GQA or latent) over the gather-view fallback."""
    tables: Any
    rows: Any
    use_kernel: bool = False


def _layer_full(p, spec, cfg: ModelConfig, h, use_kernel: bool = True):
    """One layer over whole sequences: h (B, T, D) -> (B, T, D)."""
    mixer, _ = spec
    u = RMSNorm.apply(p["norm1"], h)
    if mixer == "mla":
        y = MLAttention.full(p["mixer"], u, cfg)
    else:
        window = cfg.sliding_window if mixer == "local" else 0
        y = GQAttention.full(p["mixer"], u, cfg, window=window,
                             use_kernel=use_kernel)
    h = h + y
    v = RMSNorm.apply(p["norm2"], h)
    return h + _mlp_apply(p["ffn"], v, cfg.mlp_kind)


def _layer_window(p, spec, cfg: ModelConfig, h, cache, cache_len,
                  paged: PagedView | None = None):
    """Returns (h, new_cache) for one layer."""
    mixer, _ = spec
    window = cfg.sliding_window if mixer == "local" else 0
    u = RMSNorm.apply(p["norm1"], h)
    if paged is not None:
        y, nc = _MIXERS[mixer].window_paged(
            p["mixer"], u, cfg, cache["mixer"], paged.tables, cache_len,
            window=window, use_kernel=paged.use_kernel)
    else:
        y, nc = _MIXERS[mixer].window(p["mixer"], u, cfg, cache["mixer"],
                                      cache_len, window=window)
    h = h + y
    v = RMSNorm.apply(p["norm2"], h)
    h = h + _mlp_apply(p["ffn"], v, cfg.mlp_kind)
    return h, {"mixer": nc}


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
        gen = torch.Generator(device=device or "cpu").manual_seed(seed)
        dtype = cfg.param_dtype
        kw = dict(dtype=dtype, device=device)
        params = {"embed": Embedding.init(gen, cfg.vocab, cfg.d_model, **kw)}
        layers = []
        for mixer, _ in cfg.layer_specs():
            layers.append({
                "norm1": RMSNorm.init(cfg.d_model, **kw),
                "mixer": _MIXERS[mixer].init(gen, cfg, **kw),
                "norm2": RMSNorm.init(cfg.d_model, **kw),
                "ffn": _mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_kind,
                                 dtype, device),
            })
        params["layers"] = layers
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
    def _embed(params, cfg, tokens):
        h = Embedding.apply(params["embed"], tokens)
        if cfg.embed_scale:
            h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype)
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
        """tokens: (B, S) int. Returns (logits (B, S, V), h, aux), ``h``
        the final-normed states that feed the forecast heads and ``aux``
        the MoE load-balancing loss (0: no MoE layer is ported).
        ``remat=True`` checkpoints each layer (its activations are
        recomputed in the backward). ``use_kernel`` routes GQA attention
        on CUDA tensors through the flash-attention kernel
        (``GQAttention.full``)."""
        if prefix_embeddings is not None:
            raise NotImplementedError(
                "prefix embeddings (multimodal frontends) are not ported "
                "yet (ROADMAP.md §1 item 16)")
        if moe_capacity is not None:
            raise NotImplementedError(
                "MoE layers are not ported yet (ROADMAP.md §1 item 14)")
        for spec in cfg.layer_specs():
            _check_spec(spec)
        h = TransformerLM._embed(params, cfg, tokens)
        for p, spec in zip(params["layers"], cfg.layer_specs()):
            if remat:
                h = checkpoint(_layer_full, p, spec, cfg, h, use_kernel,
                               use_reentrant=False)
            else:
                h = _layer_full(p, spec, cfg, h, use_kernel)
        h = RMSNorm.apply(params["final_norm"], h)
        logits = TransformerLM._head(params, cfg, h)
        return logits, h, torch.zeros((), dtype=torch.float32,
                                      device=h.device)

    # -- caches ---------------------------------------------------------------
    @staticmethod
    def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
                   device=None):
        dtype = dtype or cfg.param_dtype
        for spec in cfg.layer_specs():
            _check_spec(spec)
        return {"layers": [
            {"mixer": _MIXERS[mixer].init_cache(cfg, batch, max_len, dtype,
                                                device)}
            for mixer, _ in cfg.layer_specs()]}

    @staticmethod
    def init_paged_cache(cfg: ModelConfig, batch: int, num_blocks: int,
                         block_size: int, dtype=None, device=None):
        """Physical block pools: every GQA layer holds ``{"k", "v"}:
        (num_blocks, block_size, KV, hd)``, every MLA layer ``{"c_kv":
        (num_blocks, block_size, r), "k_rope": (num_blocks, block_size,
        dr)}``; block 0 is the reserved write sink."""
        return TransformerLM.init_cache(cfg, num_blocks, block_size, dtype,
                                        device)

    # -- verify-window decode -------------------------------------------------
    @staticmethod
    def decode_window(params, cfg: ModelConfig, tokens, cache, cache_len,
                      paged: PagedView | None = None):
        """tokens: (B, W) candidates; cache_len: (B,). Returns
        (logits (B, W, V), h, new_cache)."""
        h = TransformerLM._embed(params, cfg, tokens)
        new_layers = []
        for p, spec, c in zip(params["layers"], cfg.layer_specs(),
                              cache["layers"]):
            h, nc = _layer_window(p, spec, cfg, h, c, cache_len, paged)
            new_layers.append(nc)
        h = RMSNorm.apply(params["final_norm"], h)
        logits = TransformerLM._head(params, cfg, h)
        return logits, h, {"layers": new_layers}

    @staticmethod
    def decode_window_paged(params, cfg: ModelConfig, tokens, paged_cache,
                            view: PagedView, cache_len):
        """Verify-window decode straight over the physical block pools, which
        are updated in place: no dense K/V view is built on the kernel path,
        and each layer's window K/V is committed by the same launch that
        attends through ``view.tables``. Returns (logits, h, new_cache)."""
        return TransformerLM.decode_window(
            params, cfg, tokens, paged_cache, cache_len.to(torch.int32),
            paged=view)

    @staticmethod
    def adopt_states_paged(cfg: ModelConfig, paged_cache, sel, rows):
        """Merge a paged decode's outputs back into the pool tree. Attention
        pools were already written in place by the window writes; there are
        no recurrent per-row states in this slice."""
        return sel

    @staticmethod
    def select_states(cfg: ModelConfig, new_cache, accept_idx):
        """Adopt the verify outputs: attention buffers are taken as they are
        (the rewound ``cache_len`` shields stale slots)."""
        return new_cache
