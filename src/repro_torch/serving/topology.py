"""Serving topology: how one ``ServingEngine`` maps onto a data-parallel
mesh — the port of the reference's ``serving/topology.py``.

* **Slot partition** — the ``batch`` slots split into ``data_size``
  contiguous ranges; shard ``s`` owns slots ``[s * B_local, (s + 1) *
  B_local)``.
* **Block sub-pools** — each shard owns its own paged cache on its own
  device: a block pool with its own sink block 0 and its own prefix cache
  (``ShardedBlockPool``), and the recurrent state rows of its slots. Block
  tables hold shard-local ids; ``block_offset`` gives the reference's
  global pool id of a shard's local block 0.
* **Round dispatch** — the reference runs its round under ``shard_map``
  manual over ``data``; here the engine dispatches each shard's round loop
  in turn over that shard's rows, tables and pool, and reads every
  shard's stats only after all are dispatched. No tensor ever crosses
  shards on the round path, and each shard's loop stops on its own rows.
* **Exactness** — noise streams (``Request.seq_id``) are
  placement-independent and the round is row-local, so a mesh engine's
  tokens equal the single-device engine's.

* **Model axis** — ``auto_axes`` names it where its size is > 1: this
  process is then one model rank (``model_rank``, ``model_axis``), holding
  its slice of the tensor-parallel parameters (``place_params``, the
  counterpart of the reference's ``launch/serve.py:place_params``) and a
  whole replica of each of its data shards' pools; the host tier stays
  per rank, each rank's arena over its own replicas.

``ServingTopology()`` (no mesh) is the single-device case: one shard on
the engine's device, so the engine keeps one code path.
"""
from __future__ import annotations

import torch

from repro_torch.core.device import resolve_device


class ServingTopology:
    """Mesh, data-axis name and partition math of a mesh engine.
    ``mesh=None`` is one shard."""

    def __init__(self, mesh=None, data_axis: str = "data"):
        if mesh is not None and data_axis not in mesh.axis_names:
            raise ValueError(f"{data_axis!r} not in {mesh.axis_names}")
        self.mesh = mesh
        self.data_axis = data_axis

    @property
    def data_size(self) -> int:
        return 1 if self.mesh is None else int(self.mesh.shape[self.data_axis])

    @property
    def auto_axes(self) -> frozenset:
        """Mesh axes other than data, of size > 1: the model axis, over
        which the parameters are tensor-parallel."""
        if self.mesh is None:
            return frozenset()
        return frozenset(a for a in self.mesh.axis_names
                         if a != self.data_axis and self.mesh.shape[a] > 1)

    @property
    def model_axis(self):
        """This process's model axis (``collectives.Axis``), None where
        the mesh has none of size > 1."""
        return None if self.mesh is None else self.mesh.group

    @property
    def model_rank(self) -> int:
        return 0 if self.mesh is None else self.mesh.model_rank

    def place_params(self, cfg, params):
        """This rank's slice of every tensor-parallel leaf
        (``rules.serving_param_specs``), cut on the leaf's device and
        copied to data shard 0's; the whole tree where there is no model
        axis."""
        if self.model_axis is None:
            return params
        from repro_torch.sharding.tensor_parallel import place_params
        return place_params(cfg, params, self.mesh, self.model_axis,
                            self.device(0))

    def __repr__(self):
        if self.mesh is None:
            return "ServingTopology(single-device)"
        rank = (f", model rank {self.model_rank}"
                if self.model_axis is not None else "")
        return (f"ServingTopology(mesh={dict(self.mesh.shape)}, "
                f"data_axis={self.data_axis!r}{rank})")

    # -- slot / block partition math ------------------------------------------
    def slots_per_shard(self, batch: int) -> int:
        if batch % self.data_size:
            raise ValueError(f"batch {batch} not divisible by data shards "
                             f"{self.data_size}")
        return batch // self.data_size

    def shard_of_slot(self, b: int, batch: int) -> int:
        return b // self.slots_per_shard(batch)

    def slot_range(self, shard: int, batch: int) -> range:
        per = self.slots_per_shard(batch)
        return range(shard * per, (shard + 1) * per)

    def global_slot(self, shard: int, local_row: int, batch: int) -> int:
        """The batch slot of ``local_row`` on ``shard`` (the staged loop
        reports displaced episodes by local row)."""
        per = self.slots_per_shard(batch)
        if not 0 <= local_row < per:
            raise ValueError(f"local row {local_row} of {per}")
        return shard * per + local_row

    def block_offset(self, shard: int, blocks_per_shard: int) -> int:
        """The reference's global pool id of a shard's local block 0 (its
        sink): the shards' pools laid end to end."""
        return shard * blocks_per_shard

    # -- placement ------------------------------------------------------------
    def device(self, shard: int, default=None) -> torch.device:
        """The device of data shard ``shard``; without a mesh, ``default``
        (``None`` is the GPU, as everywhere in the port)."""
        if self.mesh is None:
            return resolve_device(default)
        return self.mesh.devices[shard]

    def host_tier(self, capacity_bytes: int, *, integrity: bool = True, faults=None, breaker=None,
                  disk=None, device=None):
        """The engine's host cache tier: one arena (one byte budget for the
        process) with a key space for each shard, beside the shards' own
        device prefix caches, and one staging ring for each distinct shard
        device. ``device`` is the single-device engine's."""
        from repro_torch.serving.hostcache import HostTier
        return HostTier(capacity_bytes, num_shards=self.data_size,
                        device=[self.device(s, device)
                                for s in range(self.data_size)],
                        integrity=integrity, faults=faults, breaker=breaker,
                        disk=disk)
