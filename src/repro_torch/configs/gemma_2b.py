"""Gemma-2B [arXiv:2403.08295] — GeGLU, head_dim=256, MQA (kv=1).
Assigned: 18L d_model=2048 8H (kv=1) d_ff=16384 vocab=256000."""
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b",
        arch_type="dense",
        n_layers=18,
        d_model=2048,
        d_ff=16384,
        vocab=256000,
        n_heads=8,
        n_kv_heads=1,
        head_dim=256,
        layer_block=(("attn", "dense"),),
        mlp_kind="geglu",
        embed_scale=True,
        tie_embeddings=True,
        dtype="bfloat16",
        source="arXiv:2403.08295",
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b-reduced",
        arch_type="dense",
        n_layers=2,
        d_model=256,
        d_ff=512,
        vocab=512,
        n_heads=4,
        n_kv_heads=1,
        head_dim=64,
        layer_block=(("attn", "dense"),),
        mlp_kind="geglu",
        embed_scale=True,
        tie_embeddings=True,
        dtype="float32",
        source="arXiv:2403.08295",
    )
