"""Mistral-Large-Instruct-2407 123B [hf:mistralai/Mistral-Large-Instruct-2407]
— dense GQA. Assigned: 88L d_model=12288 96H (kv=8) d_ff=28672 vocab=32768."""
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-123b",
        arch_type="dense",
        n_layers=88,
        d_model=12288,
        d_ff=28672,
        vocab=32768,
        n_heads=96,
        n_kv_heads=8,
        head_dim=128,
        layer_block=(("attn", "dense"),),
        rope_theta=1e6,
        mlp_kind="swiglu",
        tie_embeddings=False,
        dtype="bfloat16",
        source="hf:mistralai/Mistral-Large-Instruct-2407",
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-123b-reduced",
        arch_type="dense",
        n_layers=2,
        d_model=256,
        d_ff=512,
        vocab=512,
        n_heads=4,
        n_kv_heads=2,
        head_dim=64,
        layer_block=(("attn", "dense"),),
        rope_theta=1e6,
        mlp_kind="swiglu",
        tie_embeddings=False,
        dtype="float32",
        source="hf:mistralai/Mistral-Large-Instruct-2407",
    )
