"""MusicGen-large [arXiv:2306.05284] — decoder-only over EnCodec tokens.
Assigned: 48L d_model=2048 32H (kv=32, MHA) d_ff=8192 vocab=2048.

Backbone only: the EnCodec conv codec is a stub frontend providing
conditioning-frame embeddings (n_prefix_tokens). The original uses learned
sinusoidal positions + GELU; the reference, and so the port, use RoPE,
shared with the other configs (DESIGN.md §7). vocab=2048 is the per-codebook
EnCodec cardinality; the delay-pattern codebook interleave is represented as
a single flattened token stream."""
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large",
        arch_type="audio",
        n_layers=48,
        d_model=2048,
        d_ff=8192,
        vocab=2048,
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        layer_block=(("attn", "dense"),),
        mlp_kind="gelu",
        tie_embeddings=False,
        modality="audio",
        n_prefix_tokens=256,      # conditioning frames (stub frontend)
        dtype="bfloat16",
        source="arXiv:2306.05284",
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large-reduced",
        arch_type="audio",
        n_layers=2,
        d_model=256,
        d_ff=512,
        vocab=256,
        n_heads=4,
        n_kv_heads=4,
        head_dim=64,
        layer_block=(("attn", "dense"),),
        mlp_kind="gelu",
        tie_embeddings=False,
        modality="audio",
        n_prefix_tokens=8,
        dtype="float32",
        source="arXiv:2306.05284",
    )
