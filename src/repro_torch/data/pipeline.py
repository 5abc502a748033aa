"""Host -> device data pipelines: ``TokenPipeline`` places each host batch
on one device; ``ShardedTokenPipeline``, the port of the reference's, keeps
this rank's rows of it (``rules.batch_sharding``: split over "data", or
under ``no_tp`` over "data" and "model" jointly)."""
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


class ShardedTokenPipeline(TokenPipeline):
    """Yields this rank's rows of each host batch on ``device``, cut as the
    reference's step cuts a batch placed by ``batch_sharding``: the leading
    dim into ``accum_steps`` microbatches (``launch.train``'s gradient
    accumulation), each into ``axis.size`` equal blocks in rank order,
    block ``axis.rank`` of each kept (``axis``: the data axis, or the joint
    axis under ``no_tp``, ``launch.train.batch_axis``). So this rank's
    microbatch ``i`` holds its rows of the global microbatch ``i``, and
    the MoE layer's token groups and the last microbatch's metrics are the
    reference's. ``rows`` cuts any other per-example input alike (the
    frontend's prefix)."""

    def __init__(self, host_iter, device, axis, accum_steps: int = 1):
        super().__init__(host_iter, device)
        self.axis = axis
        self.accum_steps = accum_steps

    def rows(self, x):
        """``x``'s rows of this rank (its leading dim cut as above)."""
        n, a = self.axis.size, self.accum_steps
        if x.shape[0] % (n * a):
            raise ValueError(f"batch {x.shape[0]} does not split into {a} "
                             f"microbatches over {n} ranks")
        b = x.shape[0] // (n * a)
        r = self.axis.rank
        mbs = x.reshape(a, n * b, *x.shape[1:])[:, r * b:(r + 1) * b]
        return mbs.reshape(a * b, *x.shape[1:])

    def __next__(self):
        batch = np.asarray(next(self.host_iter))
        return torch.from_numpy(self.rows(batch)).to(self.device,
                                                     non_blocking=True)
