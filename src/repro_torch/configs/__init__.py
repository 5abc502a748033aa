"""Architecture registry: ``get_config(arch_id)`` returns the exact assigned
config; ``get_config(arch_id, reduced=True)`` the CPU-sized variant of the
same family. The port serves the dense GQA path, DeepSeek-V3 (MLA with
its dense-prefix and MoE FFNs), DBRX (GQA with MoE FFNs) and RWKV-6 (time
and channel mix); the other architectures of the reference raise until
their mixers are ported."""
from __future__ import annotations

import importlib

from repro_torch.models.transformer import ModelConfig

ARCHS = (
    "deepseek-v3-671b",
    "qwen3-1.7b",
    "musicgen-large",
    "gemma-2b",
    "gemma3-1b",
    "rwkv6-7b",
    "jamba-1.5-large-398b",
    "internvl2-1b",
    "mistral-large-123b",
    "dbrx-132b",
)

PORTED = {"qwen3-1.7b": "repro_torch.configs.qwen3_1_7b",
          "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
          "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
          "dbrx-132b": "repro_torch.configs.dbrx_132b"}


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    if arch not in PORTED:
        raise NotImplementedError(
            f"{arch!r} is not ported yet (ROADMAP.md §1, Slices D-E)")
    mod = importlib.import_module(PORTED[arch])
    return mod.reduced_config() if reduced else mod.config()


__all__ = ["ARCHS", "get_config", "ModelConfig"]
