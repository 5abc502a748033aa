"""Gemma3-1B [hf:google/gemma-3-1b-pt] — 5:1 local(sliding-window):global
attention, 128k-capable. Assigned: 26L d_model=1152 4H (kv=1) d_ff=6912
vocab=262144. 26 layers = 4 full (5 local + 1 global) blocks + 2 trailing
local layers. Sliding window 512 makes long_500k decode runnable."""
from repro_torch.models.transformer import ModelConfig

_BLOCK = (("local", "dense"),) * 5 + (("attn", "dense"),)


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b",
        arch_type="dense",
        n_layers=26,
        d_model=1152,
        d_ff=6912,
        vocab=262144,
        n_heads=4,
        n_kv_heads=1,
        head_dim=256,
        layer_block=_BLOCK,
        layer_suffix=(("local", "dense"),) * 2,
        sliding_window=512,
        qk_norm=True,
        rope_theta=1e6,
        mlp_kind="geglu",
        embed_scale=True,
        tie_embeddings=True,
        dtype="bfloat16",
        source="hf:google/gemma-3-1b-pt",
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b-reduced",
        arch_type="dense",
        n_layers=4,
        d_model=256,
        d_ff=512,
        vocab=512,
        n_heads=4,
        n_kv_heads=1,
        head_dim=64,
        layer_block=(("local", "dense"),) * 3 + (("attn", "dense"),),
        sliding_window=16,
        qk_norm=True,
        rope_theta=1e6,
        mlp_kind="geglu",
        embed_scale=True,
        tie_embeddings=True,
        dtype="float32",
        source="hf:google/gemma-3-1b-pt",
    )
