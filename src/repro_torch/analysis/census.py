"""The op census: what a region of eager PyTorch did, op by op.

The counterpart of the reference's ``analysis/hlo.py``. The reference
walks a traced jaxpr and the compiled post-SPMD HLO text; an eager torch
program has neither, so the port runs the region once under a
``TorchDispatchMode`` and records every op that reaches the dispatcher:

* each op's name and, per output, its shape, dtype, device and bytes, and
  whether the output is a fresh tensor or an alias of an input;
* the tensors it wrote in place, and whether one of them shares storage
  with a *watched* tensor (the engine's pool leaves);
* the devices a copy ran between (``_to_copy`` / ``copy_``), which tells
  device-to-host copies and synchronous pageable uploads apart;
* c10d ops, which stand in for the reference's ``find_collectives`` /
  ``parse_collective_bytes``: each filed under the mesh axis that issued
  it (``sharding.collectives.current_axis``; the data-parallel mesh engine
  runs its shards from one process and issues none), and the axes'
  collectives with their bytes (``collectives_by_axis``, the deltas of
  ``sharding.collectives.STATS``);
* the peak of live bytes the region allocated: on the card from the
  caching allocator (``max_memory_allocated`` less what was allocated
  before; the peak statistics are reset on entry), elsewhere from the
  fresh outputs' storages, each counted until its storage is freed.

The hand-written kernels are launched through ``ctypes`` and never pass
the dispatcher, so the census also takes the deltas of
``kernels.LAUNCHES`` over the region (the port's ``pallas_calls``) and of
``kernels.META_CALLS`` (the launches a meta-device run stands for).

Where a CUDA device is present the region also runs under
``torch.cuda.set_sync_debug_mode("error")`` (``sync_debug_error``): any
synchronizing CUDA call raises there. Not while this process holds a
model axis whose collectives stage CUDA tensors through the host (gloo,
ranks sharing a card): each of those synchronizes by design, so the
check holds under tensor parallelism only on NCCL, which needs a card a
rank.
"""
from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import kernels
from repro_torch.sharding import collectives as _coll

# the reference's collective spellings, keyed by the c10d ops that are them
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
_C10D = {"allreduce_": "all-reduce", "all_reduce": "all-reduce",
         "allgather_": "all-gather", "all_gather_into_tensor": "all-gather",
         "_allgather_base_": "all-gather",
         "reduce_scatter_": "reduce-scatter",
         "reduce_scatter_tensor": "reduce-scatter",
         "_reduce_scatter_base_": "reduce-scatter",
         "alltoall_": "all-to-all", "all_to_all_single": "all-to-all",
         "alltoall_base_": "all-to-all", "send": "collective-permute",
         "recv_": "collective-permute"}
_C10D_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")


@dataclass
class TensorInfo:
    shape: tuple
    dtype: str
    device: str
    nbytes: int
    fresh: bool          # a new tensor, not an alias of an input


@dataclass
class OpRecord:
    name: str                       # the overload packet, e.g. "index_put_"
    op: str                         # the full overload, "aten.index_put_.default"
    outputs: list = field(default_factory=list)     # [TensorInfo]
    writes: list = field(default_factory=list)      # [TensorInfo] written in place
    writes_watched: bool = False    # an in-place write into a watched tensor
    copy: tuple = ()                # (src device, dst device, src pinned)
    axis: str = None                # the mesh axis of a c10d op

    @property
    def rank(self) -> int:
        return max((len(t.shape) for t in self.outputs + self.writes),
                   default=0)

    def __str__(self):
        shapes = ", ".join(f"{t.dtype}{list(t.shape)}" for t in self.outputs)
        return f"{self.op} -> ({shapes})"


@contextlib.contextmanager
def sync_debug_error(device):
    """``set_sync_debug_mode("error")`` around a region on a CUDA device
    (a synchronizing call raises there); nothing elsewhere, nor while a
    host-staged model axis is held (``collectives.stages_through_host``)."""
    if (device is None or device.type != "cuda"
            or _coll.stages_through_host()):
        yield
        return
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _info(t: torch.Tensor, fresh: bool) -> TensorInfo:
    return TensorInfo(tuple(t.shape), str(t.dtype).replace("torch.", ""),
                      str(t.device), t.numel() * t.element_size(), fresh)


class Census(TorchDispatchMode):
    """Record every dispatched op of a ``with Census(...)`` region.

    ``watch`` are tensors whose in-place writes are flagged (the pool
    leaves). After the region: ``ops`` (``OpRecord`` list), ``launches``
    and ``meta_calls`` (kernel count deltas by name), ``collectives``
    (count per reference spelling), ``collectives_by_axis`` (``{axis:
    {kind: {"count", "bytes"}}}``), ``peak_bytes`` and ``device``."""

    def __init__(self, watch=()):
        super().__init__()
        self.watch = {t.untyped_storage().data_ptr() for t in watch
                      if t.device.type != "meta"}
        self.ops: list[OpRecord] = []
        self.launches: dict = {}
        self.meta_calls: dict = {}
        self.collectives = dict.fromkeys(COLLECTIVES, 0)
        self.collectives_by_axis: dict = {}
        self.peak_bytes = 0
        self.device = None
        self._live = 0
        self._storages = weakref.WeakSet()
        self._cuda = False
        self._debug = contextlib.ExitStack()

    # -- region --------------------------------------------------------
    def __enter__(self):
        self._l0 = dict(kernels.LAUNCHES)
        self._c0 = {k: tuple(v) for k, v in _coll.STATS.items()}
        self._m0 = dict(kernels.META_CALLS)
        self._cuda = torch.cuda.is_available()
        if self._cuda:
            torch.cuda.synchronize()
            self._alloc0 = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            self._debug.enter_context(sync_debug_error(torch.device("cuda")))
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._debug.close()
        self.launches = {k: v - self._l0[k]
                         for k, v in kernels.LAUNCHES.items()}
        self.meta_calls = {k: v - self._m0[k]
                           for k, v in kernels.META_CALLS.items()}
        self.collectives_by_axis = _coll.stats_by_axis(self._c0)
        if self.device == "cuda":
            torch.cuda.synchronize()
            self.peak_bytes = torch.cuda.max_memory_allocated() - self._alloc0
        return out

    def _freed(self, nbytes: int):
        self._live -= nbytes

    def _track(self, t: torch.Tensor):
        s = t.untyped_storage()
        if s in self._storages:
            return
        self._storages.add(s)
        n = s.nbytes()
        self._live += n
        self.peak_bytes = max(self.peak_bytes, self._live)
        weakref.finalize(s, self._freed, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        schema = func._schema
        rec = OpRecord(func.overloadpacket.__name__, str(func))
        for i, a in enumerate(schema.arguments):
            if a.alias_info is None or not a.alias_info.is_write:
                continue
            val = args[i] if i < len(args) else kwargs.get(a.name)
            for t in _tensors(val):
                rec.writes.append(_info(t, False))
                if t.device.type != "meta" and \
                        t.untyped_storage().data_ptr() in self.watch:
                    rec.writes_watched = True
        if rec.name == "set_" and rec.writes_watched and \
                isinstance(args[1], torch.Tensor):
            # a watched tensor moved to new storage: watch that from here on
            self.watch.add(args[1].untyped_storage().data_ptr())
        if rec.name in ("_to_copy", "copy_"):
            src = args[1] if rec.name == "copy_" else args[0]
            dst_dev = (args[0].device if rec.name == "copy_" else
                       torch.device(kwargs.get("device") or src.device))
            pinned = (src.device.type == "cpu" and dst_dev.type == "cuda"
                      and src.is_pinned())
            rec.copy = (src.device.type, dst_dev.type, pinned)
        out = func(*args, **kwargs)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        rets = schema.returns
        for j, t in enumerate(outs):
            if not isinstance(t, torch.Tensor):
                continue
            fresh = j >= len(rets) or rets[j].alias_info is None
            rec.outputs.append(_info(t, fresh))
            if self.device is None and t.device.type != "cpu":
                self.device = t.device.type
            if fresh and t.device.type != "cuda":
                self._track(t)
        if func.namespace in _C10D_NAMESPACES:
            # a collective works on its buffers in place
            rec.writes = [_info(t, False) for t in _tensors(args)]
            rec.axis = _coll.current_axis()
            kind = _C10D.get(rec.name)
            if kind is not None:
                self.collectives[kind] += 1
        self.ops.append(rec)
        return out

    # -- summaries -----------------------------------------------------
    def op_counts(self) -> dict:
        counts: dict = {}
        for r in self.ops:
            counts[r.name] = counts.get(r.name, 0) + 1
        return counts
