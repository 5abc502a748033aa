"""Tensor-parallel parameters: each rank's slice of the sharded leaves, and
the collectives their products need — what GSPMD derives in the reference
from ``serving_param_shardings``, written out.

**Placement.** ``place(tree, specs, axes)`` keeps, of every leaf whose spec
names an axis in ``axes`` (``{name: collectives.Axis}``, sizes > 1), the
rank's contiguous slice along that dim, cut on the leaf's own device (on
the host for a host tree) before the copy to ``device``. The slice carries
a ``Placement`` (the axis, the dim, the full shape) as an attribute of the
tensor (per axis), which ``placement_of`` reads: the layer that is handed the leaf
(``nn/core.py``'s ``Dense``, ``Embedding`` and ``RMSNorm``, and
``models/moe.py``'s ``MoE``) branches on it, and nothing matches leaf
names at call time. A tree with no placement runs exactly as before.
``place_params`` is the serving placement (the counterpart of the
reference's ``launch/serve.py:place_params``).

**The products** (``M`` ranks on the axis, activations whole on every
rank unless stated):

(a) row-parallel, the model on a ``Dense`` input dim: the rank's slice of
    the input times its rows, then ``all_reduce``; an input that is already
    the rank's slice (the output of (b) kept sharded) is taken as it is;
(b) column-parallel, the model on the output dim: the local columns, then
    ``all_gather``; with ``keep_sharded`` (the MLP's ``up`` and ``gate``,
    which feed ``down`` row-parallel on the same dim) the columns stay on
    the rank, and the MLP costs one ``all_reduce``;
(c) the vocab-sharded embedding: a masked lookup of the rank's rows plus
    ``all_reduce`` (exact: every other rank adds zeros); its tied readout,
    and an untied ``head/w`` by (b), gives local logits over the rank's
    vocabulary slice, gathered, so the verify sees the whole vocabulary
    with its tie rule unchanged;
(d) a 1-D leaf split by the rule (DBRX's stacked norm scales): gathered
    whole before use, since the norm needs the whole row.

Attention runs on full heads on every rank (its q, k, v and output
products are (a)), against the rank's replica of the pool. Row-parallel
sums reorder float additions, so values agree with a single device's to
rounding, not bitwise; every rank gets the same bits (the reduction's
result is one value everywhere), so the ranks' tokens agree bitwise.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

_ATTR = "_placement"


@dataclass(frozen=True, eq=False)
class Placement:
    """A leaf's split: ``dim`` of the full ``shape`` over ``axis`` (a
    ``collectives.Axis``), the rank holding rows ``[lo, lo + size)``."""
    axis: object
    dim: int
    shape: tuple

    @property
    def size(self) -> int:
        return self.shape[self.dim] // self.axis.size

    @property
    def lo(self) -> int:
        return self.axis.rank * self.size


def placements_of(t) -> dict:
    """``{axis name: Placement}`` of a placed leaf, empty for any other
    tensor."""
    return getattr(t, _ATTR, None) or {}


def placement_of(t, axis: str = "model"):
    """The placement of a placed leaf over ``axis``, None for any other
    tensor."""
    return placements_of(t).get(axis)


def carry(src, dst):
    """``dst`` (a copy of ``src``, e.g. on another device) with ``src``'s
    placements."""
    pls = getattr(src, _ATTR, None)
    if pls and dst is not src:
        setattr(dst, _ATTR, pls)
    return dst


def _axis_dim(spec, axes):
    """The ``(axis name, dim)`` pairs of ``spec`` over the axes of
    ``axes``; a dim over two axes raises (ROADMAP item 20c)."""
    hits = []
    for d, comp in enumerate(spec):
        names = () if comp is None else (
            (comp,) if isinstance(comp, str) else tuple(comp))
        live = [a for a in names if a in axes]
        if len(live) > 1 or (live and len(names) > 1):
            raise NotImplementedError(
                f"spec {spec}: a dim over several axes (the inference EP "
                "layout, no_tp FSDP) is ROADMAP item 20c")
        hits += [(live[0], d)] if live else []
    if len(hits) > 1 and any(n == hits[0][0] for n, _ in hits[1:]):
        raise ValueError(f"spec {spec} uses an axis twice")
    return hits


def place_leaf(t: torch.Tensor, spec, axes: dict, device=None):
    """``t``'s slice on this process's ranks of ``axes`` (along each dim
    the spec gives one of them), on ``device``, carrying its placements."""
    full = tuple(t.shape)
    pls = {}
    out = t
    for name, d in _axis_dim(spec, axes):
        pl = Placement(axes[name], d, full)
        out = out.narrow(d, pl.lo, pl.size)
        pls[name] = pl
    if pls:
        # a clone: the slice must not keep the whole leaf's storage alive
        out = out.clone(memory_format=torch.contiguous_format)
    out = out.to(device) if device is not None else out
    if pls:
        setattr(out, _ATTR, pls)
    return out


def place(tree, specs, axes: dict, device=None):
    """``tree`` with every leaf placed by its spec (``specs`` mirrors the
    tree) over ``axes`` (``{name: Axis}``; an axis of size 1 splits
    nothing)."""
    axes = {k: a for k, a in axes.items() if a.size > 1}
    if isinstance(tree, dict):
        return {k: place(v, specs[k], axes, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [place(v, s, axes, device) for v, s in zip(tree, specs)]
    return place_leaf(tree, specs, axes, device)


def place_params(cfg, params, mesh, axis, device):
    """The serving placement: ``serving_param_specs`` (tensor parallelism
    over "model", data axes stripped) on ``mesh``, each leaf sliced for
    ``axis``'s rank on its own device and then copied to ``device``."""
    from repro_torch.sharding.rules import serving_param_specs
    return place(params, serving_param_specs(cfg, params, mesh),
                 {"model": axis}, device)


def is_placed(tree) -> bool:
    """Whether any leaf of ``tree`` carries a placement."""
    if isinstance(tree, dict):
        return any(is_placed(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(is_placed(v) for v in tree)
    return bool(placements_of(tree))


def whole(t: torch.Tensor) -> torch.Tensor:
    """A placed leaf gathered to its full shape (d); any other as it is."""
    pl = placement_of(t)
    return t if pl is None else pl.axis.all_gather(t, dim=pl.dim)


def dense(params, x, keep_sharded: bool = False):
    """``Dense.apply`` of a placed weight: (a) or (b) above."""
    w = params["w"]
    pl = placement_of(w)
    if "b" in params:
        # no layer the model axis serves has one: the recurrent mixers'
        # products do (ROADMAP item 20c)
        raise NotImplementedError("a placed Dense with a bias")
    if pl.dim == 0:                                 # (a) rows: the input dim
        full, own = pl.shape[pl.dim], w.shape[-2]
        if x.shape[-1] == full:
            x = x[..., pl.lo:pl.lo + own]
        elif x.shape[-1] != own:
            raise ValueError(f"input width {x.shape[-1]}: want {full} or "
                             f"the rank's {own}")
        return pl.axis.all_reduce(x @ w)
    y = x @ w                                        # (b) columns
    return y if keep_sharded else pl.axis.all_gather(y, dim=-1)


def embed(params, ids):
    """``Embedding.apply`` of a placed table: (c), or a gather of the
    rank's columns where the rule split the width."""
    t = params["table"]
    pl = placement_of(t)
    if pl.dim == 0:
        idx = ids - pl.lo
        mine = (idx >= 0) & (idx < pl.size)
        h = t[idx.clamp(0, pl.size - 1)]
        return pl.axis.all_reduce(h.masked_fill_(~mine[..., None], 0))
    return pl.axis.all_gather(t[ids], dim=-1)


def attend(params, x):
    """``Embedding.attend`` of a placed table: local logits over the
    rank's vocabulary gathered (c), or partial logits over the rank's
    width reduced."""
    t = params["table"]
    pl = placement_of(t)
    if pl.dim == 0:
        return pl.axis.all_gather(x @ t.T, dim=-1)
    return pl.axis.all_reduce(x[..., pl.lo:pl.lo + pl.size] @ t.T)
