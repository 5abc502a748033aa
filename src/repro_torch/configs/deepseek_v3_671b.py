"""DeepSeek-V3 671B [arXiv:2412.19437] — MLA + 1 shared/256 routed top-8 MoE
+ MTP. Assigned: 61L d_model=7168 128H d_ff=2048(expert) vocab=129280.

The MTP head is implemented as the paper's learned forecasting module
(forecast_horizon=2): predictive sampling verifies its drafts with the
Gumbel-max acceptance, which keeps the samples exact. The port runs every
layer: the three dense-prefix layers and the 58 MoE layers (no-drop in
serving). On one 80 GB card a depth cut such as
``dataclasses.replace(config(), n_layers=4)`` (3 dense + 1 MoE) serves."""
from repro_torch.models.transformer import ModelConfig

_MLA = dict(q_lora_rank=1536, kv_lora_rank=512, qk_rope_dim=64,
            qk_nope_dim=128, v_head_dim=128)


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b",
        arch_type="moe",
        n_layers=61,
        d_model=7168,
        d_ff=18432,                 # dense-prefix FFN width [paper §4]
        moe_d_ff=2048,              # assigned expert width
        vocab=129280,
        n_heads=128,
        n_kv_heads=128,
        head_dim=128,
        layer_prefix=(("mla", "dense"),) * 3,   # first-3-dense [paper]
        layer_block=(("mla", "moe"),),
        n_experts=256,
        n_shared_experts=1,
        top_k=8,
        router_score="sigmoid",     # DeepSeek-V3 scoring
        mlp_kind="swiglu",
        tie_embeddings=False,
        forecast_horizon=2,         # MTP depth 1 == forecast offsets {0,1}
        forecast_hidden=0,
        dtype="bfloat16",
        source="arXiv:2412.19437",
        **_MLA,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b-reduced",
        arch_type="moe",
        n_layers=2,
        d_model=256,
        d_ff=512,
        moe_d_ff=128,
        vocab=512,
        n_heads=4,
        n_kv_heads=4,
        head_dim=64,
        layer_prefix=(("mla", "dense"),),
        layer_block=(("mla", "moe"),),
        n_experts=4,
        n_shared_experts=1,
        top_k=2,
        router_score="sigmoid",
        mlp_kind="swiglu",
        tie_embeddings=False,
        forecast_horizon=2,
        q_lora_rank=64, kv_lora_rank=32, qk_rope_dim=16, qk_nope_dim=48,
        v_head_dim=64,
        dtype="float32",
        source="arXiv:2412.19437",
    )
