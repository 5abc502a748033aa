"""DBRX 132B [hf:databricks/dbrx-base] — fine-grained MoE, 16 experts top-4
on every layer. Assigned: 40L d_model=6144 48H (kv=8) d_ff=10752(expert)
vocab=100352."""
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b",
        arch_type="moe",
        n_layers=40,
        d_model=6144,
        d_ff=10752,
        moe_d_ff=10752,
        vocab=100352,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        layer_block=(("attn", "moe"),),
        n_experts=16,
        top_k=4,
        rope_theta=5e5,
        mlp_kind="swiglu",
        tie_embeddings=False,
        dtype="bfloat16",
        source="hf:databricks/dbrx-base",
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b-reduced",
        arch_type="moe",
        n_layers=2,
        d_model=256,
        d_ff=512,
        moe_d_ff=512,
        vocab=512,
        n_heads=4,
        n_kv_heads=2,
        head_dim=64,
        layer_block=(("attn", "moe"),),
        n_experts=4,
        top_k=2,
        rope_theta=5e5,
        mlp_kind="swiglu",
        tie_embeddings=False,
        dtype="float32",
        source="hf:databricks/dbrx-base",
    )
