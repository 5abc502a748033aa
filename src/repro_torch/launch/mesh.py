"""Device meshes for the serving engine: the port of the reference's
``launch/mesh.py``.

A mesh here is a plain record, not a runtime object: the names of its
axes, their sizes, and one ``torch.device`` for each data shard. The
mesh engine (``serving/topology.py``) runs every data shard from one
process, each shard's tensors on its own device, so the data axis needs no
process group. The model axis (tensor and expert parallelism over
``torch.distributed``) is ROADMAP item 20b; a mesh with ``model > 1``
raises until then. Importing this module touches no device.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Mesh:
    """``axis_names`` in order, ``shape`` as ``{axis: size}``, and
    ``devices``, the device of each data shard in shard order."""
    axis_names: tuple
    shape: dict
    devices: tuple


def make_host_mesh(data: int = 1, model: int = 1, devices=None) -> Mesh:
    """A ``(data, model)`` mesh. ``devices=None`` puts data shard ``s`` on
    ``cuda:s`` and raises when there are fewer cards than shards; an
    explicit list names each shard's device (two shards may share one
    card, or run on the CPU)."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh ({data}, {model}): sizes must be >= 1")
    if model > 1:
        raise NotImplementedError(
            "a model axis (tensor and expert parallelism over "
            "torch.distributed) is ROADMAP item 20b; use model=1")
    if devices is None:
        have = torch.cuda.device_count()
        if have < data:
            raise RuntimeError(
                f"a data={data} mesh needs {data} CUDA devices, have "
                f"{have}; name the shards' devices explicitly to share one")
        devices = [f"cuda:{s}" for s in range(data)]
    devices = tuple(torch.device(d) for d in devices)
    if len(devices) != data:
        raise ValueError(f"{len(devices)} devices for {data} data shards")
    return Mesh(axis_names=("data", "model"),
                shape={"data": data, "model": model}, devices=devices)
