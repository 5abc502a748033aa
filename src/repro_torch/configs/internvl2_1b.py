"""InternVL2-1B [arXiv:2404.16821] — InternViT vision encoder + LM decoder.
Assigned: 24L d_model=896 14H (kv=2) d_ff=4864 vocab=151655.

Backbone only: the InternViT encoder + MLP projector are a stub frontend
providing 256 patch embeddings as a prefix (``models/frontends.py``)."""
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b",
        arch_type="vlm",
        n_layers=24,
        d_model=896,
        d_ff=4864,
        vocab=151655,
        n_heads=14,
        n_kv_heads=2,
        head_dim=64,
        layer_block=(("attn", "dense"),),
        rope_theta=1e6,
        mlp_kind="swiglu",
        tie_embeddings=True,
        modality="vision",
        n_prefix_tokens=256,
        dtype="bfloat16",
        source="arXiv:2404.16821",
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b-reduced",
        arch_type="vlm",
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
        tie_embeddings=True,
        modality="vision",
        n_prefix_tokens=8,
        dtype="float32",
        source="arXiv:2404.16821",
    )
