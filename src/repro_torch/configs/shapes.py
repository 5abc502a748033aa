"""Assigned input shapes and (arch x shape) applicability."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

# long_500k needs sub-quadratic context handling: runnable for SSM/hybrid and
# the 5:1 sliding-window gemma3; skipped (and documented in DESIGN.md §5) for
# pure full-attention archs.
_LONG_OK = {"rwkv6-7b", "jamba-1.5-large-398b", "gemma3-1b"}


def shape_applicable(arch: str, shape: str) -> tuple[bool, str]:
    """(runnable, reason-if-skipped)."""
    if shape == "long_500k" and arch not in _LONG_OK:
        return False, ("pure full-attention architecture: 500k dense KV "
                       "decode skipped per brief (see DESIGN.md §5)")
    return True, ""
