"""Jamba-1.5-Large 398B [arXiv:2403.19887] — Mamba+attention 1:7 interleave,
MoE every other layer (16e top-2). Assigned: 72L d_model=8192 64H (kv=8)
d_ff=24576 vocab=65536. 72 layers = 9 x (8-layer Jamba block: attention at
index 3, MoE on odd layers).

Each Mamba layer (d_inner 16384, 16 states per channel) carries per-row
recurrent states beside the attention layer's paged K/V blocks: a conv
window of 3 x 16384 inputs and a float32 SSM state of 16384 x 16. A depth
cut must cut the block itself (``ModelConfig.n_blocks`` takes whole
blocks): ``dataclasses.replace(cfg, n_layers=4,
layer_block=cfg.layer_block[:4])`` keeps three Mamba layers, the
attention layer and two MoE layers."""
from repro_torch.models.transformer import ModelConfig

_BLOCK = (
    ("mamba", "dense"), ("mamba", "moe"),
    ("mamba", "dense"), ("attn", "moe"),
    ("mamba", "dense"), ("mamba", "moe"),
    ("mamba", "dense"), ("mamba", "moe"),
)


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b",
        arch_type="hybrid",
        n_layers=72,
        d_model=8192,
        d_ff=24576,
        moe_d_ff=24576,
        vocab=65536,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        layer_block=_BLOCK,
        n_experts=16,
        top_k=2,
        mlp_kind="swiglu",
        ssm_state=16,
        tie_embeddings=False,
        dtype="bfloat16",
        source="arXiv:2403.19887",
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b-reduced",
        arch_type="hybrid",
        n_layers=8,
        d_model=256,
        d_ff=512,
        moe_d_ff=512,
        vocab=512,
        n_heads=4,
        n_kv_heads=2,
        head_dim=64,
        layer_block=_BLOCK,
        n_experts=4,
        top_k=2,
        mlp_kind="swiglu",
        ssm_state=8,
        tie_embeddings=False,
        dtype="float32",
        source="arXiv:2403.19887",
    )
