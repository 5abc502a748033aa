"""Logical-axis sharding: named activation and parameter axes -> mesh
axes. The port of the reference's ``sharding/api.py``.

Model code of the reference annotates tensors with *logical* axis names
(``constrain(h, ("batch", "seq", "embed"))``) and the launcher activates a
rule set that maps them to physical mesh axes. A spec here is a plain
tuple with one entry per dimension: ``None`` (replicated), a mesh-axis
name, or a tuple of them (batch -> ("pod", "data")).

The port has no partitioner: its activations are placed by the code that
makes them (``sharding/tensor_parallel.py`` and ``sharding/moe_shard.py``
write the collectives GSPMD inserts), so ``constrain`` is the identity
here, under an active rule set too. ``shard_map`` has no counterpart:
each rank of the model axis is a process of its own, and the data axis
runs its shards in one process (``serving/topology.py``).
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Mapping, NamedTuple, Sequence

_STATE = threading.local()


@dataclass(frozen=True)
class Rules:
    """Logical-axis -> mesh-axis mapping."""
    mapping: Mapping[str, object]

    def spec(self, names: Sequence) -> tuple:
        axes, used = [], set()
        for n in names:
            ax = self.mapping.get(n) if n is not None else None
            comps = (() if ax is None
                     else ((ax,) if isinstance(ax, str) else tuple(ax)))
            # a mesh axis may be consumed at most once per spec
            if comps and not (set(comps) & used):
                used.update(comps)
                # one axis is its name, as a PartitionSpec canonicalizes it
                axes.append(comps[0] if len(comps) == 1 else comps)
            else:
                axes.append(None)
        return tuple(axes)


class NamedSharding(NamedTuple):
    """A spec on a mesh (``launch.mesh.Mesh``, or any record with
    ``shape`` and ``axis_names``)."""
    mesh: object
    spec: tuple


@contextlib.contextmanager
def use_rules(mesh, rules: Rules):
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = (mesh, rules)
    try:
        yield
    finally:
        _STATE.ctx = prev


def current_rules():
    """The active ``(mesh, rules)``, or None."""
    return getattr(_STATE, "ctx", None)


def logical_sharding(names: Sequence):
    """The ``NamedSharding`` of ``names`` under the active rules, or None
    outside a rule context."""
    ctx = current_rules()
    if ctx is None:
        return None
    mesh, rules = ctx
    return NamedSharding(mesh, rules.spec(names))


def constrain(x, names: Sequence):
    """The identity, under active rules too: the port places activations
    explicitly where they are made (``sharding/tensor_parallel.py``), so
    there is no constraint for a partitioner to honour."""
    return x
