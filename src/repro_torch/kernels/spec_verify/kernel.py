"""Launcher of the CUDA spec_verify kernel (``csrc/spec_verify.cu``).

Imports nothing GPU-only at module import; the library is built and loaded
at the first launch."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import bind, check_status, count_launch, stream_ptr

_TARGET_BLOCKS = 4 * 132      # a few waves over the H100's 132 SMs
_FN = None


def _splits(R: int, V: int) -> tuple[int, int]:
    """(chunk, nsplit): contiguous vocab chunks per row, a multiple of 4
    values wide, enough of them that the grid fills the card."""
    nsplit = max(1, min(-(-V // 1024), -(-_TARGET_BLOCKS // R)))
    chunk = -(-V // nsplit)
    chunk = -(-chunk // 4) * 4
    return chunk, -(-V // chunk)


def _launcher():
    global _FN
    if _FN is None:
        _FN = bind("spec_verify_launch", [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    return _FN


def spec_verify_cuda(logits: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """(R, V) float32 CUDA tensors, contiguous -> (R,) int32. One call
    launches two kernels (the split pass and the final reduction) and counts
    one launch of ``spec_verify``."""
    R, V = logits.shape
    chunk, nsplit = _splits(R, V)
    # one allocation for the output and both partial arrays (value, index)
    ws = torch.empty((R * (2 * nsplit + 1),), dtype=torch.int32,
                     device=logits.device)
    base = ws.data_ptr()
    vec4 = int(V % 4 == 0 and logits.data_ptr() % 16 == 0
               and eps.data_ptr() % 16 == 0)
    status = _launcher()(logits.data_ptr(), eps.data_ptr(),
                         base + 4 * R, base + 4 * R * (1 + nsplit), base,
                         R, V, chunk, nsplit, vec4,
                         stream_ptr(logits.device))
    check_status("spec_verify", status)
    count_launch("spec_verify")
    return ws[:R]
