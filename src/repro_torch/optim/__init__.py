from repro_torch.optim.optimizers import (adafactor, adamw, apply_updates,
                                          clip_by_global_norm, sgd,
                                          zero_frozen)
from repro_torch.optim.schedules import (constant_schedule, cosine_schedule,
                                         exponential_decay,
                                         linear_warmup_cosine)

__all__ = [
    "adamw", "adafactor", "sgd", "clip_by_global_norm", "apply_updates",
    "zero_frozen",
    "constant_schedule", "cosine_schedule", "linear_warmup_cosine",
    "exponential_decay",
]
