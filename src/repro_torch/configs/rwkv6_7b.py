"""RWKV-6 "Finch" 7B [arXiv:2404.05892] — attention-free, data-dependent
decay. Assigned: 32L d_model=4096 d_ff=14336 vocab=65536.

Each layer is a time mix (the WKV recurrence over 64 heads of width 64)
and a channel mix; the verify window runs the recurrence from the state
snapshot at the accept point and returns the state after every position,
and the engine adopts the one after the last accepted token (DESIGN.md
§5). No layer has a KV cache: the per-row state is 64 x 64 x 64 plus two
token-shift rows of 4096 per layer."""
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b",
        arch_type="ssm",
        n_layers=32,
        d_model=4096,
        d_ff=14336,
        vocab=65536,
        layer_block=(("rwkv", "rwkv_cmix"),),
        rwkv_head_dim=64,
        tie_embeddings=False,
        dtype="bfloat16",
        source="arXiv:2404.05892",
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b-reduced",
        arch_type="ssm",
        n_layers=2,
        d_model=256,
        d_ff=512,
        vocab=512,
        layer_block=(("rwkv", "rwkv_cmix"),),
        rwkv_head_dim=32,
        tie_embeddings=False,
        dtype="float32",
        source="arXiv:2404.05892",
    )
