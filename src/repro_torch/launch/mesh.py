"""Device meshes for the serving engine and the trainer: the port of the
reference's ``launch/mesh.py``.

A mesh here is a plain record, not a runtime object: the names of its
axes, their sizes, and one ``torch.device`` for each data shard of this
process. The mesh engine (``serving/topology.py``) runs every data shard
from one process, each shard's tensors on its own device, so the data
axis needs no process group. The model axis (tensor and expert
parallelism) is one process per rank over ``torch.distributed``: with
``model > 1`` the record also names this process's model rank, the world
size, the backend and the model axis (``sharding.collectives.Axis``, its
process group and collectives). ``launch/serve.py --mesh D,M`` spawns the
M ranks itself; a process that builds such a mesh otherwise joins the
group through ``rank`` and ``store_path`` (a ``FileStore``), unless
``sharding.collectives.init_axes`` has already made it.

A training mesh (``make_train_mesh``) is one process per ``(data, model)``
rank, ``data * model`` in all, each on one device: FSDP needs the data
axis's collectives, so there every axis has a process group, and the
record also carries this process's ``axes`` (``{"data", "model",
collectives.JOINT}``). ``launch/train.py --mesh D,M`` spawns the ranks.
Importing this module touches no device.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Mesh:
    """``axis_names`` in order, ``shape`` as ``{axis: size}``,
    ``devices``, the device of each of this process's data shards in
    shard order; on a model axis of size > 1, this process's
    ``model_rank``, the ``world_size``, the ``backend`` and the model
    ``group`` (a ``collectives.Axis``); on a training mesh, this rank's
    ``axes``."""
    axis_names: tuple
    shape: dict
    devices: tuple
    model_rank: int = 0
    world_size: int = 1
    backend: str = None
    group: object = None
    axes: dict = None


def _rank_devices(data: int, model: int, devices):
    """Each model rank's data-shard devices: ``devices=None`` gives rank
    ``r`` the cards ``r * data ..``, one a shard (an error with fewer
    cards); a list of ``data`` devices is every rank's (ranks share them),
    one of ``data * model`` is cut rank by rank."""
    if devices is None:
        have = torch.cuda.device_count()
        if have < data * model:
            raise RuntimeError(
                f"a ({data}, {model}) mesh needs {data * model} CUDA "
                f"devices, have {have}; name the shards' devices "
                "explicitly to share one")
        devices = [f"cuda:{i}" for i in range(data * model)]
    devices = [torch.device(d) for d in devices]
    if len(devices) == data:
        return [devices] * model
    if len(devices) == data * model:
        return [devices[r * data:(r + 1) * data] for r in range(model)]
    raise ValueError(f"{len(devices)} devices for {data} data shards on "
                     f"{model} model ranks")


def make_host_mesh(data: int = 1, model: int = 1, devices=None,
                   backend: str = None, *, rank: int = None,
                   store_path: str = None) -> Mesh:
    """A ``(data, model)`` mesh. ``devices=None`` puts data shard ``s`` of
    model rank ``r`` on ``cuda:{r * data + s}`` and raises when there are
    fewer cards; an explicit list names the shards' devices (see
    ``_rank_devices``: two shards or two ranks may share one card, or run
    on the CPU). With ``model > 1`` this process is one model rank:
    ``backend`` (default ``collectives.choose_backend``: NCCL when each
    rank has cards of its own, gloo otherwise) is printed when the group
    is made."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh ({data}, {model}): sizes must be >= 1")
    per_rank = _rank_devices(data, model, devices)
    shape = {"data": data, "model": model}
    if model == 1:
        return Mesh(axis_names=("data", "model"), shape=shape,
                    devices=tuple(per_rank[0]))
    from repro_torch.sharding import collectives
    import torch.distributed as dist
    backend = backend or collectives.choose_backend(per_rank)
    if backend == "nccl" and data > 1:
        raise NotImplementedError(
            "NCCL binds one card to each rank; several data shards a rank "
            "under NCCL is ROADMAP item 20c (gloo serves them)")
    axis = collectives.AXES.get("model")
    if axis is None:
        if dist.is_initialized():
            raise RuntimeError("a process group exists without the model "
                               "axis; build it with collectives.init_axes")
        if rank is None or store_path is None:
            raise ValueError(
                "a model axis needs this process's rank and the group's "
                "store_path (or run it through launch.serve --mesh D,M, "
                "which spawns the ranks)")
        axis = collectives.init_axes(
            rank, model, model, store_path=store_path, backend=backend,
            device=per_rank[rank][0])["model"]
    if axis.size != model:
        raise ValueError(f"the process group's model axis has "
                         f"{axis.size} ranks, the mesh {model}")
    return Mesh(axis_names=("data", "model"), shape=shape,
                devices=tuple(per_rank[axis.rank]), model_rank=axis.rank,
                world_size=dist.get_world_size(), backend=axis.backend,
                group=axis)


def make_train_mesh(data: int, model: int, devices=None, *, rank: int,
                    store_path: str) -> Mesh:
    """This process's rank ``rank`` of a ``(data, model)`` training mesh of
    ``data * model`` processes, joined through the ``FileStore`` at
    ``store_path`` (``collectives.init_axes``: ranks model fastest).
    ``devices=None`` puts rank ``r`` on ``cuda:{r}`` and raises when there
    are fewer cards; an explicit list names one device every rank shares,
    or one a rank. The backend is ``collectives.choose_backend``'s: NCCL
    when each rank has a card of its own, gloo otherwise."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh ({data}, {model}): sizes must be >= 1")
    world = data * model
    if devices is None:
        have = torch.cuda.device_count()
        if have < world:
            raise RuntimeError(
                f"a ({data}, {model}) training mesh needs {world} CUDA "
                f"devices, have {have}; name the ranks' devices "
                "explicitly to share one")
        devices = [f"cuda:{i}" for i in range(world)]
    devices = [torch.device(d) for d in devices]
    if len(devices) == 1:
        devices = devices * world
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    from repro_torch.sharding import collectives
    backend = collectives.choose_backend([[d] for d in devices])
    axes = collectives.init_axes(rank, world, model, store_path=store_path,
                                 backend=backend, device=devices[rank])
    return Mesh(axis_names=("data", "model"),
                shape={"data": data, "model": model},
                devices=(devices[rank],), model_rank=axes["model"].rank,
                world_size=world, backend=backend, group=axes["model"],
                axes=axes)
