"""Plain PyTorch version of the spec_verify kernel."""
import torch


def spec_verify_ref(logits, eps):
    """argmax(logits + eps, axis=-1): (R, V) -> (R,) int32; ties go to the
    lowest index."""
    return torch.argmax(logits.float() + eps.float(), dim=-1).to(torch.int32)
