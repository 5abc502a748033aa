"""Declarative invariant rules over an op census.

The port of the reference's ``analysis/rules.py``. Each rule is a small
object with a ``name`` and a ``check(program) -> list[Violation]``
method; :class:`~repro_torch.analysis.contracts.Contract` bundles rules
and :func:`~repro_torch.analysis.contracts.check_program` runs them
against one program. A :class:`Program` is a callable, its arguments and
the pool leaves it must update in place; its ``census`` runs the callable
once under :class:`~repro_torch.analysis.census.Census` (an eager program
has no trace to read without running it) and keeps the result in
``output``, so a checked dispatch is the real one.

The rules, as the reference writes them down:

* ``NoCollectives`` — the verify round is device-local: any c10d op is a
  placement bug that scales round latency with the mesh.
* ``NoPoolRankedScatters`` — a pool write happens in place, inside the
  fused writeback (on the card the kernel, on the CPU its plain version's
  in-place index assignment into the pool). A scatter-family op of rank
  >= ``min_rank`` that is not that in-place write is the dense round trip
  sneaking back; with ``pool_shapes`` any op that makes a fresh
  pool-shaped tensor other than a plain copy is too.
* ``DonationAliasCovers`` — the reference's donation, where the port has
  none to establish: every pool leaf keeps its storage across the region
  and no second pool-sized tensor is made there (two live copies of the
  cache per round otherwise).
* ``NoHostCallbacks`` — ops that read device data on the host
  (``_local_scalar_dense``, the ``.item()`` / ``int()`` / ``bool()``
  path; ``nonzero``; ``masked_select``; ``unique``), device-to-host
  copies and synchronous pageable uploads; on the card the region also
  runs under ``set_sync_debug_mode("error")``.
* ``NoF64Leaks`` — a float64 / complex128 output doubles bandwidth and
  breaks the bf16/f32 exactness story.
* ``MaxLiveBytes`` — the region's peak of live bytes it allocated.
* ``RecompileHazard`` — distinct argument signatures per program label:
  the graphs a CUDA-graph capture of the program would need.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.analysis.census import Census

SCATTER_OPS = frozenset((
    "index_put", "index_put_", "_index_put_impl_", "_unsafe_index_put",
    "scatter", "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
    "scatter_reduce_", "index_copy", "index_copy_", "index_add",
    "index_add_", "index_reduce", "index_reduce_", "index_fill",
    "index_fill_", "masked_scatter", "masked_scatter_", "slice_scatter",
    "select_scatter", "diagonal_scatter", "as_strided_scatter"))
HOST_SYNC_OPS = frozenset((
    "_local_scalar_dense", "item", "is_nonzero", "equal", "nonzero",
    "nonzero_numpy", "masked_select", "unique", "_unique", "_unique2",
    "unique_dim", "unique_consecutive", "unique_dim_consecutive"))
# ops that allocate or copy without computing: no scatter whatever their
# shape (a pool-sized copy is DonationAliasCovers' concern)
COPY_OPS = frozenset((
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "clone", "_to_copy", "copy", "zeros", "zeros_like",
    "new_zeros", "full", "full_like", "new_full", "ones", "ones_like",
    "lift_fresh", "lift_fresh_copy", "detach", "set_", "alias"))
F64 = ("float64", "complex128")


@dataclass
class Violation:
    """One structured contract violation: which rule, where (the op), and
    the numeric evidence (rank / bytes / counts)."""
    rule: str
    summary: str
    site: str = ""                 # the op, e.g. "aten.nonzero.default"
    evidence: dict = field(default_factory=dict)

    def __str__(self):
        loc = f" [{self.site}]" if self.site else ""
        ev = (" " + ", ".join(f"{k}={v}" for k, v in self.evidence.items())
              if self.evidence else "")
        return f"{self.rule}: {self.summary}{loc}{ev}"


def _leaves(x) -> list:
    if isinstance(x, dict):
        return [y for v in x.values() for y in _leaves(v)]
    if isinstance(x, (list, tuple)):
        return [y for v in x for y in _leaves(v)]
    return [x]


def signature(args) -> tuple:
    """The argument signature of a call: each tensor's (shape, dtype), each
    other value itself (an int argument is a static: a window width),
    ``None`` nothing — as a pytree flattening drops it."""
    sig = []
    for leaf in _leaves(args):
        if leaf is None:
            continue
        if isinstance(leaf, torch.Tensor):
            sig.append((tuple(leaf.shape), str(leaf.dtype)))
        else:
            sig.append((type(leaf).__name__, leaf))
    return tuple(sig)


class Program:
    """One call of ``fn(*args)`` for rules to read.

    ``pool`` are the block pools and ``state`` the other tensors the call
    must update in place (the engine's recurrent rows): every one keeps its
    storage, and no fresh tensor the size of a pool leaf may be made (a
    state row is too small for that test). ``census`` runs the call once,
    under the census, and keeps its return value in ``output``; a
    ``RuntimeError`` that the card's sync-debug mode raised is kept as
    ``sync_error`` (the call did not finish). ``label`` keys the
    per-process registry :class:`RecompileHazard` reads. A Program built
    from a ``census`` alone (fixtures) has no call."""

    def __init__(self, fn=None, args=(), *, pool=(), state=(),
                 label: str = "", census: Census = None):
        self.fn = fn
        self.args = tuple(args)
        self.pool = list(pool)
        self.state = list(state)
        self.label = label or (getattr(fn, "__name__", "") or "<program>")
        self._census = census
        self.output = None
        self.sync_error = None
        self.moved = []            # pool leaves whose storage changed

    @property
    def census(self) -> Census:
        if self._census is None:
            if self.fn is None:
                raise ValueError(f"{self.label}: no call and no census")
            kept = self.pool + self.state
            ptrs = [t.untyped_storage().data_ptr() for t in kept]
            self._census = Census(watch=self.pool)
            try:
                with self._census:
                    self.output = self.fn(*self.args)
            except RuntimeError as e:
                if "synchroniz" not in str(e):
                    raise
                self.sync_error = e
            self.moved = [i for i, (t, p) in enumerate(zip(kept, ptrs))
                          if t.untyped_storage().data_ptr() != p]
        return self._census

    def pool_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in self.pool + self.state)


class Rule:
    """Base: subclasses set ``name`` and implement ``check``."""
    name = "rule"

    def check(self, program: Program) -> list[Violation]:
        raise NotImplementedError


class NoCollectives(Rule):
    """Zero c10d collectives in the region, but those of the mesh axes
    ``allow_axes`` (the model axis of a tensor-parallel program, whose
    collectives are its contractions); a collective of another axis, or
    of none, still fails."""
    name = "NoCollectives"

    def __init__(self, allow_axes=()):
        self.allow_axes = tuple(allow_axes)

    def check(self, program):
        return [Violation(self.name, f"collective `{r.name}` on the hot path"
                          f" (axis {r.axis})", site=r.op, evidence={
                              "op": r.name, "axis": r.axis, "bytes": sum(
                                  t.nbytes for t in r.outputs + r.writes)})
                for r in program.census.ops
                if r.op.split(".")[0] in ("c10d", "_c10d_functional",
                                          "c10d_functional")
                and r.axis not in self.allow_axes]


def _pool_scatters(census: Census, min_rank: int, pool_shapes=None) -> list:
    """The ops NoPoolRankedScatters flags (see its docstring)."""
    hits = []
    for r in census.ops:
        if r.writes_watched or r.name in COPY_OPS:
            continue
        if r.name in SCATTER_OPS and r.rank >= min_rank and (
                pool_shapes is None or any(
                    t.shape in pool_shapes for t in r.outputs + r.writes)):
            hits.append(r)
        elif pool_shapes is not None and any(
                t.fresh and t.shape in pool_shapes for t in r.outputs):
            hits.append(r)
    return hits


class NoPoolRankedScatters(Rule):
    """Zero scatter-family ops of rank >= ``min_rank`` outside the fused
    writeback's in-place pool writes. ``pool_shapes`` (optional) narrows
    the rule from the rank proxy to the real invariant: only ops whose
    output has one of the given pool leaf shapes count, so the high-rank
    scatters other archs run per round by design (MoE dispatch buffers,
    recurrent state rows) pass, while a pool-shaped result made out of
    place (a dense writeback) is caught. ``pool_shapes=None`` keeps the
    plain rank filter (fixtures, and callers with no pool in hand)."""
    name = "NoPoolRankedScatters"

    def __init__(self, min_rank: int = 3, pool_shapes=None):
        self.min_rank = min_rank
        self.pool_shapes = (None if pool_shapes is None else
                            frozenset(tuple(s) for s in pool_shapes))

    def check(self, program):
        return [Violation(
            self.name,
            f"pool-ranked `{r.name}` (rank {r.rank} >= {self.min_rank}) "
            "outside the fused writeback", site=r.op,
            evidence={"rank": r.rank, "shape": list(max(
                (t.shape for t in r.outputs + r.writes), key=len)),
                "op": str(r)})
            for r in _pool_scatters(program.census, self.min_rank,
                                    self.pool_shapes)]


class DonationAliasCovers(Rule):
    """Every pool leaf and state tensor of the program keeps its storage
    across the region and no fresh tensor the size of a pool leaf (shape
    and dtype) is made there: the in-place update that the reference's
    donation establishes. Passes when the program names no pool."""
    name = "DonationAliasCovers"

    def check(self, program):
        census = program.census
        leaves = {(tuple(t.shape), str(t.dtype).replace("torch.", ""))
                  for t in program.pool}
        copies = [r for r in census.ops if any(
            t.fresh and (t.shape, t.dtype) in leaves for t in r.outputs)]
        if not program.moved and not copies:
            return []
        copy_bytes = sum(t.nbytes for r in copies for t in r.outputs
                         if t.fresh)
        return [Violation(
            self.name,
            f"{len(program.moved)} of {len(program.pool + program.state)} "
            "pool and state tensors moved, "
            f"{len(copies)} pool-sized tensor(s) made: the pool is not "
            "updated in place",
            site=copies[0].op if copies else "",
            evidence={"moved_leaves": len(program.moved),
                      "copy_bytes": copy_bytes,
                      "pool_bytes": program.pool_bytes()})]


class NoHostCallbacks(Rule):
    """Zero ops that read device data on the host, device-to-host copies
    and synchronous pageable uploads; and, on the card, no synchronizing
    call under ``set_sync_debug_mode("error")``."""
    name = "NoHostCallbacks"

    @staticmethod
    def callbacks(census: Census) -> list:
        return [r for r in census.ops if r.name in HOST_SYNC_OPS or (
            r.copy and ((r.copy[0] != "cpu" and r.copy[1] == "cpu") or (
                r.copy[0] == "cpu" and r.copy[1] == "cuda"
                and not r.copy[2])))]

    def check(self, program):
        out = [Violation(self.name, f"host read `{r.name}` on the hot path",
                         site=r.op, evidence={"op": str(r)})
               for r in self.callbacks(program.census)]
        if program.sync_error is not None:
            out.append(Violation(
                self.name, "a synchronizing CUDA call under sync-debug "
                "mode 'error'", evidence={"error": str(
                    program.sync_error)[:300]}))
        return out


class NoF64Leaks(Rule):
    """Zero float64/complex128 outputs."""
    name = "NoF64Leaks"

    def check(self, program):
        return [Violation(self.name,
                          f"`{r.name}` produces a 64-bit float output",
                          site=r.op, evidence={"rank": r.rank, "op": str(r)})
                for r in program.census.ops
                if any(t.dtype in F64 for t in r.outputs)]


class MaxLiveBytes(Rule):
    """The region's peak of live bytes it allocated must not exceed
    ``budget``. Workload-parameterized, so the named contracts don't carry
    it: extend a contract with it where a budget is known
    (``ROUND_CONTRACT.extend(MaxLiveBytes(b))``)."""
    name = "MaxLiveBytes"

    def __init__(self, budget: int):
        self.budget = int(budget)

    def check(self, program):
        live = program.census.peak_bytes
        if live <= self.budget:
            return []
        return [Violation(
            self.name, f"live {live} bytes > budget {self.budget}",
            evidence={"live_bytes": live, "budget": self.budget})]


class RecompileHazard(Rule):
    """The same program label called with more than ``max_shapes``
    distinct argument signatures (:func:`signature`) in this process:
    each is a graph a CUDA-graph capture would record. The engine's W grid
    and power-of-two prefill chunks bound them; a caller whose ragged
    shapes reach the program trips this."""
    name = "RecompileHazard"

    # label -> set of signatures, process-global by design
    _registry: dict = {}

    def __init__(self, max_shapes: int = 8):
        self.max_shapes = int(max_shapes)

    def check(self, program):
        seen = self._registry.setdefault(program.label, set())
        seen.add(signature(program.args))
        if len(seen) <= self.max_shapes:
            return []
        return [Violation(
            self.name,
            f"`{program.label}` called at {len(seen)} distinct argument "
            f"signatures (> {self.max_shapes}) this process",
            evidence={"distinct_shapes": len(seen),
                      "max_shapes": self.max_shapes})]


def census(program: Program) -> dict:
    """The summary numbers attached to each Report: pool-ranked scatters
    (the rank proxy, as the reference counts them), host callbacks, kernel
    launches (the port's ``pallas_calls``: ``kernels.LAUNCHES`` deltas),
    collectives by the reference's spelling, aten ops and the peak of
    live bytes."""
    c = program.census
    return {
        "pool_scatters": len(_pool_scatters(c, 3)),
        "host_callbacks": len(NoHostCallbacks.callbacks(c)),
        "kernel_launches": sum(c.launches.values()),
        "kernel_calls": {k: v for k, v in c.launches.items() if v},
        "collectives": dict(c.collectives),
        "collectives_by_axis": c.collectives_by_axis,
        "aten_ops": len(c.ops),
        "peak_bytes": c.peak_bytes,
    }
