"""The model axis over ``torch.distributed``: process groups, the
collectives GSPMD inserts in the reference, written out, and the spawner
that runs one process per rank.

* ``Axis`` — one mesh axis of this process: its name, this process's rank
  on it, its size and its process group. ``all_reduce`` (a sum),
  ``all_gather`` (along a dim) and ``reduce_scatter`` (a sum, then this
  rank's slice along a dim) are the collectives the port issues; each is
  counted in ``STATS`` (``{(axis, kind): [count, bytes]}``, the bytes of
  the result on this rank), and while it runs ``current_axis()`` names
  its axis, so the op census (``analysis/census.py``) files the c10d op
  under it. Gloo has no reduce-scatter: there it is an all-reduce and a
  slice, and it is counted as the all-reduce it is. ``agree`` compares a
  host value across the axis (the serving engine's digest of the accepted
  tokens, the trainer's of its replicated leaves) and raises on a
  mismatch; ``broadcast_bytes`` sends one rank's host bytes to the others
  (the serving engine's clock reading, its replayed journal). Both run on
  the axis's gloo ``host_group``; the broadcast is counted in ``STATS``
  as ``host-broadcast`` (the ``host-`` kinds move host bytes, not device
  tensors), and never runs inside a checked dispatch.
* The differentiable forms, ``torch.autograd.Function``s whose backward
  issues the transposed collective on the same axis (counted alike):
  ``reduce_from`` (Megatron's g: forward all-reduce, backward the
  identity, the incoming gradient being whole and equal on every rank),
  ``copy_to`` (f: forward the identity, backward all-reduce; it goes where
  a whole activation enters a rank-local product), ``gather_from``
  (forward all-gather, backward this rank's slice) and ``fsdp_gather``
  (forward all-gather of a leaf split over data, backward reduce-scatter:
  each data rank's gradient of the whole leaf summed, this rank's slice
  kept). Where no gradient is wanted they run the plain collective (in
  place for ``reduce_from``, as the serving path always has).
* The backend is chosen once and printed: NCCL when every rank has a card
  of its own, gloo otherwise. NCCL refuses two ranks on one device; gloo
  stages CUDA tensors through the host (which synchronizes), and is the
  backend of the CPU. A collective that fails fails the run: nothing falls
  back.
* ``init_axes`` joins the world and builds a ``(data, model)`` layout's
  axes, ``layout_axes`` another layout's over the same world; besides
  "data" and "model", each layout has the joint axis ``JOINT`` over both,
  the world in rank order ``d * model + m``, on which ``no_tp`` splits a
  leaf (the reference's ``("data", "model")`` spec entry).
* ``spawn(fn, world, *args)`` runs ``fn(rank, world, store_path, *args)``
  in ``world`` processes (the ``spawn`` start method, a ``FileStore`` in a
  temporary directory) and returns their results in rank order.

Importing this module touches no device and starts no process.
"""
from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import threading
import time
import zlib

import torch
import torch.distributed as dist

STATS: dict = {}
# the joint axis over ("data", "model"): ``no_tp``'s split of a leaf
JOINT = "data+model"
_CUR = threading.local()
# the axes this process holds, by name, while their groups live
AXES: dict = {}


def current_axis():
    """The name of the axis whose collective is running, or None."""
    return getattr(_CUR, "axis", None)


def stats_by_axis(before: dict = None) -> dict:
    """``{axis: {kind: {"count", "bytes"}}}``, less ``before`` (an earlier
    copy of ``STATS``)."""
    before = before or {}
    out: dict = {}
    for (axis, kind), (n, b) in STATS.items():
        n0, b0 = before.get((axis, kind), (0, 0))
        if n - n0:
            out.setdefault(axis, {})[kind] = {"count": n - n0,
                                              "bytes": b - b0}
    return out


def stages_through_host() -> bool:
    """Whether a collective of this process stages CUDA tensors through the
    host: a gloo axis of size > 1 on a card. Such a collective
    synchronizes, so the sync-debug check (``analysis.census.
    sync_debug_error``) is off while one is held; it stays on under NCCL."""
    return any(a.size > 1 and a.backend == "gloo" and a.device.type == "cuda"
               for a in AXES.values())


def choose_backend(rank_devices) -> str:
    """NCCL when every rank's devices are cards no other rank uses, gloo
    otherwise (ranks sharing a card, or on the CPU). ``rank_devices`` holds
    one list of devices per rank."""
    seen, shared = set(), False
    for devs in rank_devices:
        devs = {torch.device(d) for d in devs}
        if any(d.type != "cuda" for d in devs) or devs & seen:
            shared = True
        seen |= devs
    return "gloo" if shared else "nccl"


class Axis:
    """One mesh axis of this process (see the module docstring). A size-1
    axis has no group and its collectives are the identity. The joint axis
    holds its ``parts``, the (data, model) axes it joins."""

    parts = None

    def __init__(self, name: str, rank: int, size: int, group=None,
                 backend: str = "gloo", host_group=None, device=None):
        self.name, self.rank, self.size = name, rank, size
        self.group, self.backend = group, backend
        # host values (digests) go over gloo whatever the tensors' backend
        self.host_group = host_group if host_group is not None else group
        self.device = torch.device(device or "cpu")

    def __repr__(self):
        return (f"Axis({self.name!r}, rank {self.rank} of {self.size}, "
                f"{self.backend})")

    @contextlib.contextmanager
    def _issuing(self, kind: str, nbytes: int):
        prev = current_axis()
        _CUR.axis = self.name
        try:
            yield
        finally:
            _CUR.axis = prev
        rec = STATS.setdefault((self.name, kind), [0, 0])
        rec[0] += 1
        rec[1] += nbytes

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the axis, in place; returns ``t``."""
        if self.size == 1:
            return t
        with self._issuing("all-reduce", t.numel() * t.element_size()):
            dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The axis's ``t`` concatenated along ``dim`` in rank order."""
        if self.size == 1:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        with self._issuing("all-gather",
                           self.size * t.numel() * t.element_size()):
            dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim=dim)

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The sum of ``t`` (the same shape on every rank) over the axis,
        this rank's slice of it along ``dim``: NCCL's reduce-scatter; over
        gloo, which has none, an all-reduce of a copy, then the slice."""
        if self.size == 1:
            return t
        n = t.shape[dim] // self.size
        if self.backend != "nccl":
            return self.all_reduce(t.clone()).narrow(
                dim, self.rank * n, n).contiguous()
        src = t.movedim(dim, 0).contiguous()
        out = src.new_empty((n,) + tuple(src.shape[1:]))
        with self._issuing("reduce-scatter", out.numel() * t.element_size()):
            dist.reduce_scatter_tensor(out, src, group=self.group)
        return out.movedim(0, dim).contiguous()

    def broadcast_bytes(self, data, src: int = 0, size: int = None) -> bytes:
        """Rank ``src``'s ``data`` (the others pass None) on every rank of
        the axis, over the host group. ``size``, where every rank knows it,
        spares the broadcast of the length: then one operation."""
        if self.size == 1:
            return data
        root = dist.get_global_rank(self.host_group, src)
        if size is None:
            n = torch.tensor([len(data) if self.rank == src else 0],
                             dtype=torch.int64)
            dist.broadcast(n, src=root, group=self.host_group)
            size = int(n)
        if self.rank == src and len(data) != size:
            raise ValueError(f"{len(data)} bytes to broadcast, size {size}")
        if not size:
            return b""
        buf = (torch.frombuffer(bytearray(data), dtype=torch.uint8)
               if self.rank == src else torch.empty(size, dtype=torch.uint8))
        with self._issuing("host-broadcast", size):
            dist.broadcast(buf, src=root, group=self.host_group)
        return bytes(data) if self.rank == src else buf.numpy().tobytes()

    def agree(self, data: bytes, what: str) -> int:
        """Compare a digest of ``data`` across the axis on the host; raise
        ``RankDivergence`` if any rank's differs. Returns the digest."""
        digest = zlib.crc32(data)
        if self.size == 1:
            return digest
        mine = torch.tensor([digest], dtype=torch.int64)
        every = [torch.empty_like(mine) for _ in range(self.size)]
        dist.all_gather(every, mine, group=self.host_group)
        got = [int(x) for x in every]
        if len(set(got)) != 1:
            raise RankDivergence(f"{what}: the {self.name} ranks disagree "
                                 f"(digests {got}; this is rank "
                                 f"{self.rank})")
        return digest


class RankDivergence(RuntimeError):
    """The ranks of an axis computed different host-visible values: the
    schedules would part, and the collectives after them would not
    match."""


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        return axis.all_reduce(t.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce(g.clone(
            memory_format=torch.contiguous_format)), None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return axis.all_gather(t, dim)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // ctx.axis.size
        return g.narrow(ctx.dim, ctx.axis.rank * n, n), None, None


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return axis.all_gather(t, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.reduce_scatter(g, ctx.dim), None, None


def _wants_grad(t) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def reduce_from(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of ``t`` over ``axis`` (a rank-local product's partial
    sums); its gradient passes unchanged. Without a gradient, in place."""
    if axis.size == 1:
        return t
    return _ReduceFrom.apply(t, axis) if _wants_grad(t) else \
        axis.all_reduce(t)


def copy_to(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``t`` (whole and equal on every rank) as it enters a rank-local
    product; its gradient, each rank's partial, is summed over ``axis``."""
    if axis.size == 1 or not _wants_grad(t):
        return t
    return _CopyTo.apply(t, axis)


def gather_from(t: torch.Tensor, axis: Axis, dim: int = -1) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim``; its gradient (whole and
    equal on every rank) is cut back to this rank's slice."""
    if axis.size == 1:
        return t
    return _GatherFrom.apply(t, axis, dim) if _wants_grad(t) else \
        axis.all_gather(t, dim)


def fsdp_gather(t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """A leaf split over ``axis`` on ``dim`` (FSDP) gathered whole for use;
    its gradient, each rank's from its own rows of the batch, is
    reduce-scattered: summed over ``axis``, this rank's slice kept."""
    if axis.size == 1:
        return t
    return _FsdpGather.apply(t, axis, dim) if _wants_grad(t) else \
        axis.all_gather(t, dim)


def init_axes(rank: int, world: int, model: int, *, store_path: str,
              backend: str, device=None) -> dict:
    """Join the world's process group (a ``FileStore`` at ``store_path``)
    and build this rank's axes of the ``(world // model, model)`` layout
    (``layout_axes``). Every process calls this in the same order: the
    groups are made collectively."""
    if world % model:
        raise ValueError(f"world {world} is not a multiple of model {model}")
    device = torch.device(device or "cpu")
    if backend == "nccl" and device.type == "cuda":
        torch.cuda.set_device(device)
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)
    return layout_axes(model, backend, device)


def layout_axes(model: int, backend: str, device=None) -> dict:
    """This rank's axes of a ``(data, model)`` layout over the world
    already joined: ranks laid out model fastest, so rank ``r`` is data
    ``r // model``, model ``r % model``. Returns ``{"data": Axis, "model":
    Axis, JOINT: Axis}`` (the joint axis the world, rank ``r``; the serving
    engine runs its data shards in one process, so there "data" has size
    1). Every rank calls it in the same order (the groups are made
    collectively); the axes become ``AXES``."""
    rank, world = dist.get_rank(), dist.get_world_size()
    if world % model:
        raise ValueError(f"world {world} is not a multiple of model {model}")
    device = torch.device(device or "cpu")
    data = world // model
    d, m = divmod(rank, model)
    groups = {}
    for name, members in (
            ("model", [[dd * model + mm for mm in range(model)]
                       for dd in range(data)]),
            ("data", [[dd * model + mm for dd in range(data)]
                      for mm in range(model)]),
            (JOINT, [list(range(world))])):
        for ranks in members:
            g = dist.new_group(ranks, backend=backend)
            h = (dist.new_group(ranks, backend="gloo") if backend != "gloo"
                 else g)
            if rank in ranks:
                groups[name] = (g, h)
    axes = {name: Axis(name, r, n, groups[name][0], backend=backend,
                       host_group=groups[name][1], device=device)
            for name, r, n in (("model", m, model), ("data", d, data),
                               (JOINT, rank, world))}
    axes[JOINT].parts = (axes["data"], axes["model"])
    AXES.clear()
    AXES.update(axes)
    print(f"rank {rank} of {world}: {backend} process group, "
          f"{axes['model']}, {axes['data']}", flush=True)
    return axes


def shutdown() -> None:
    """Leave the process group (every rank calls it)."""
    AXES.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def _child(rank, world, store_path, fn, args, queue):
    try:
        out = fn(rank, world, store_path, *args)
        queue.put((rank, True, out))
    except BaseException as e:          # reported to the parent, re-raised
        import traceback
        queue.put((rank, False, f"{type(e).__name__}: {e}\n"
                   + traceback.format_exc()))
        raise
    finally:
        shutdown()


def spawn(fn, world: int, *args, timeout: float = 600.0) -> list:
    """Run ``fn(rank, world, store_path, *args)`` in ``world`` new
    processes (``spawn`` start method; ``fn`` must be importable) and
    return their results in rank order; raise if any rank raised or a
    process died. Every process is joined (and killed past ``timeout``)
    before this returns."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    store_path = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_child,
                         args=(r, world, store_path, fn, args, queue))
             for r in range(world)]
    results, errors = {}, []
    try:
        for p in procs:
            p.start()
        got = 0
        deadline = time.monotonic() + timeout
        while got < world:
            if not queue.empty():
                rank, ok, out = queue.get()
                got += 1
                (results.__setitem__(rank, out) if ok
                 else errors.append(f"rank {rank}: {out}"))
                if not ok:
                    break
                continue
            if any(p.exitcode not in (None, 0) for p in procs):
                errors.append("a rank died: exit codes "
                              f"{[p.exitcode for p in procs]}")
                break
            if time.monotonic() > deadline:
                errors.append(f"ranks still running after {timeout} s")
                break
            time.sleep(0.01)
    finally:
        for p in procs:
            p.join(timeout=5 if errors else 60)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise RuntimeError("; ".join(errors))
    return [results[r] for r in range(world)]
