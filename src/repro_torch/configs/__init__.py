"""Architecture registry: ``get_config(arch_id)`` returns the exact assigned
config; ``get_config(arch_id, reduced=True)`` the CPU-sized variant of the
same family. The port serves and trains all ten: the dense GQA decoders
(qwen3-1.7b, gemma-2b, gemma3-1b with its 5:1 sliding-window layers,
mistral-large-123b), DeepSeek-V3 (MLA with its dense-prefix and MoE FFNs),
DBRX (GQA with MoE FFNs), RWKV-6 (time and channel mix), the hybrid jamba
(Mamba-1 and GQA layers, dense and MoE FFNs), and the two multimodal
backbones, musicgen-large (MHA, GELU, an untied head) and internvl2-1b,
whose frozen encoders are stood in for by a prefix of embeddings
(``models/frontends.py``)."""
from __future__ import annotations

import importlib

from repro_torch.configs.shapes import SHAPES, InputShape, shape_applicable
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

PORTED = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
          for a in ARCHS}


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    mod = importlib.import_module(PORTED[arch])
    return mod.reduced_config() if reduced else mod.config()


def list_archs():
    return list(ARCHS)


__all__ = ["ARCHS", "get_config", "list_archs", "SHAPES",
           "shape_applicable", "InputShape", "ModelConfig"]
