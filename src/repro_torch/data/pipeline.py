"""Host -> device data pipeline: places each host batch on the device
(one device, no mesh)."""
from __future__ import annotations

import numpy as np
import torch


class TokenPipeline:
    """Wraps a host batch generator of numpy arrays; yields each batch as
    a tensor on ``device``."""

    def __init__(self, host_iter, device):
        self.host_iter = host_iter
        self.device = torch.device(device)

    def __iter__(self):
        return self

    def __next__(self):
        batch = np.asarray(next(self.host_iter))
        return torch.from_numpy(batch).to(self.device, non_blocking=True)
