"""Public op: batched Gumbel-max verify.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises. Shapes beyond 2D are flattened to rows."""
from __future__ import annotations

import torch

from repro_torch.kernels.spec_verify.kernel import spec_verify_cuda
from repro_torch.kernels.spec_verify.ref import spec_verify_ref


def spec_verify(logits: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """argmax(logits + eps) over the last axis; any leading shape; int32."""
    if logits.shape != eps.shape:
        raise ValueError(f"logits {tuple(logits.shape)} vs eps "
                         f"{tuple(eps.shape)}")
    shape = logits.shape[:-1]
    V = logits.shape[-1]
    lg = logits.reshape(-1, V)
    ep = eps.reshape(-1, V)
    if lg.device.type == "cpu" and ep.device.type == "cpu":
        return spec_verify_ref(lg, ep).reshape(shape)
    if lg.device.type != "cuda" or ep.device != lg.device:
        raise ValueError(f"spec_verify: tensors on {lg.device} and "
                         f"{ep.device}; want one CUDA device")
    if lg.dtype != torch.float32 or ep.dtype != torch.float32:
        raise TypeError(f"spec_verify wants float32, got {lg.dtype}, "
                        f"{ep.dtype}")
    if V >= 2 ** 31 or lg.shape[0] == 0:
        raise ValueError(f"spec_verify: unsupported shape {tuple(lg.shape)}")
    return spec_verify_cuda(lg.contiguous(), ep.contiguous()).reshape(shape)
