"""Qwen3-1.7B [hf:Qwen/Qwen3-8B family card] — dense GQA with qk_norm.
Assigned: 28L d_model=2048 16H (kv=8) d_ff=6144 vocab=151936."""
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b",
        arch_type="dense",
        n_layers=28,
        d_model=2048,
        d_ff=6144,
        vocab=151936,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        layer_block=(("attn", "dense"),),
        qk_norm=True,
        rope_theta=1e6,
        mlp_kind="swiglu",
        tie_embeddings=True,
        dtype="bfloat16",
        source="hf:Qwen/Qwen3-8B",
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b-reduced",
        arch_type="dense",
        n_layers=2,
        d_model=256,
        d_ff=512,
        vocab=512,
        n_heads=4,
        n_kv_heads=2,
        head_dim=64,
        layer_block=(("attn", "dense"),),
        qk_norm=True,
        rope_theta=1e6,
        mlp_kind="swiglu",
        tie_embeddings=True,
        dtype="float32",
        source="hf:Qwen/Qwen3-8B",
    )
