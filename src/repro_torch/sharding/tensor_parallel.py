"""Tensor-parallel and FSDP parameters: each rank's slice of the sharded
leaves, and the collectives their products need — what GSPMD derives in
the reference from ``param_shardings`` (training) and
``serving_param_shardings`` (serving), written out.

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
reference's ``launch/serve.py:place_params``): tensor parallelism over
"model" only. ``place_train_params`` is the training one: ``param_specs``
whole, so a large leaf is split over "model" on one dim and over "data"
(FSDP) on the next, or under ``no_tp`` over both jointly (the axis
``collectives.JOINT``) on one.

**On use** (``on_use``), a leaf split over "data" or the joint axis is
gathered whole along that dim (``collectives.fsdp_gather``: its gradient
is reduce-scattered, each data rank's summed), keeping its model
placement for the products below. A leaf split over "data" alone (data D
x model 1) is then whole, and runs as on one device.

**The products** (``M`` ranks on the model axis, activations whole and
equal on every model rank unless stated; each collective differentiable,
``collectives.copy_to`` / ``reduce_from`` / ``gather_from``):

(a) row-parallel, the model on a ``Dense`` input dim: the rank's slice of
    the input times its rows, then ``reduce_from``; a whole input goes
    through ``copy_to`` before the slice is taken (so its gradient, each
    rank's slice, is summed), an input that is already the rank's slice
    (the output of (b) kept sharded) is taken as it is;
(b) column-parallel, the model on the output dim: ``copy_to`` of the
    input, the local columns, then ``gather_from``; with ``keep_sharded``
    (the MLP's ``up`` and ``gate``, which feed ``down`` row-parallel on the
    same dim) the columns stay on the rank, and the MLP costs one
    all-reduce forward;
(c) the vocab-sharded embedding: a masked lookup of the rank's rows plus
    ``reduce_from`` (exact: every other rank adds zeros); its tied readout,
    and an untied ``head/w`` by (b), gives local logits over the rank's
    vocabulary slice, gathered, so the verify and the loss see the whole
    vocabulary (in training, each rank's B x S x V logits: 1.24 GB of bf16
    a forward at qwen3-1.7b's B = 2, S = 2048; a vocab-parallel loss is
    later work);
(d) a 1-D leaf split by the rule (DBRX's stacked norm scales): gathered
    whole before use (``whole``), since the norm needs the whole row.

Attention runs on full heads on every rank (its q, k, v and output
products are (a)), against the rank's replica of the pool. Row-parallel
sums reorder float additions, so values agree with a single device's to
rounding, not bitwise; every rank gets the same bits (the reduction's
result is one value everywhere), so the ranks' tokens, and the gradients
of leaves every rank holds whole, agree bitwise.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.sharding.collectives import (JOINT, copy_to, fsdp_gather,
                                              gather_from, reduce_from)

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
    ``axes``: an entry over one live axis names it; ``("data", "model")``
    names the joint axis (``no_tp``) wherever that is live, even where
    one of the two has a single rank, since the batch is split over it;
    the inference EP layout, ``("model", "data")`` over both, raises
    (ROADMAP item 20c)."""
    hits = []
    for d, comp in enumerate(spec):
        names = () if comp is None else (
            (comp,) if isinstance(comp, str) else tuple(comp))
        live = [a for a in names if a in axes]
        joint = JOINT in axes and {"data", "model"} <= set(names)
        if joint or len(live) > 1:
            if not joint or tuple(a for a in names if a in (
                    "data", "model")) != ("data", "model"):
                raise NotImplementedError(
                    f"spec {spec}: experts over ('model', 'data') jointly "
                    "(the inference EP layout) is ROADMAP item 20c")
            live = [JOINT]
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


class _Sizes:
    """A mesh as the rules see it: axis names and sizes."""

    def __init__(self, axes):
        self.axis_names = ("data", "model")
        self.shape = {k: axes[k].size for k in self.axis_names}


def place_train_params(cfg, params, axes, no_tp: bool = False):
    """The training placement: ``param_specs`` (tensor parallelism over
    "model", FSDP over "data"; under ``no_tp`` FSDP over both jointly) for
    this process's ``axes`` (``collectives.init_axes``), each leaf sliced
    on its own device. The optimizer state made from the placed tree
    (``optim.optimizers``) is placed alike."""
    from repro_torch.sharding.rules import param_specs
    return place(params, param_specs(cfg, params, _Sizes(axes), no_tp),
                 axes)


def is_placed(tree) -> bool:
    """Whether any leaf of ``tree`` carries a placement."""
    if isinstance(tree, dict):
        return any(is_placed(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(is_placed(v) for v in tree)
    return bool(placements_of(tree))


def reduced_placement(t, p, dim: int):
    """``t``, a statistic of the placed leaf ``p`` with ``p``'s dim ``dim``
    reduced away (Adafactor's factored moments), carrying ``p``'s
    placements on the dims that survive."""
    dim %= p.ndim
    pls = {}
    for name, pl in placements_of(p).items():
        if pl.dim != dim:
            pls[name] = Placement(pl.axis, pl.dim - (pl.dim > dim),
                                  pl.shape[:dim] + pl.shape[dim + 1:])
    if pls:
        setattr(t, _ATTR, pls)
    return t


def on_use(t: torch.Tensor) -> torch.Tensor:
    """A placed leaf as the model axis's products take it: gathered over
    its "data" or joint placement (``fsdp_gather``), carrying its model
    placement, if any; any other leaf as it is."""
    pls = placements_of(t)
    out = t
    for name, pl in pls.items():
        if name != "model":
            out = fsdp_gather(out, pl.axis, pl.dim)
    if out is not t and "model" in pls:
        setattr(out, _ATTR, {"model": pls["model"]})
    return out


def whole(t: torch.Tensor) -> torch.Tensor:
    """A placed leaf gathered to its full shape: (d), and the checkpoint's
    gather (under ``no_grad``, every rank calls it); any other as it
    is."""
    t = on_use(t)
    pl = placement_of(t)
    return t if pl is None else gather_from(t, pl.axis, pl.dim)


def whole_tree(tree):
    """``tree`` with every placed leaf gathered whole (collective: every
    rank calls it, leaves in the same order)."""
    if isinstance(tree, dict):
        return {k: whole_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [whole_tree(v) for v in tree]
    return whole(tree)


def agree_replicas(tree, axes: dict, what: str) -> None:
    """Raise ``collectives.RankDivergence`` unless every leaf of ``tree``
    that no axis splits holds the same bits on every rank of each axis of
    ``axes`` (a crc32 of their bytes, compared on the host)."""
    def rec(node):
        if isinstance(node, dict):
            return [x for k in sorted(node) for x in rec(node[k])]
        if isinstance(node, (list, tuple)):
            return [x for v in node for x in rec(v)]
        return [] if placements_of(node) else [node]
    flat = [t.detach().reshape(-1).view(torch.uint8) for t in rec(tree)]
    data = torch.cat(flat).cpu().numpy().tobytes() if flat else b""
    for axis in axes.values():
        axis.agree(data, what)


def dense(params, x, keep_sharded: bool = False):
    """``Dense.apply`` of a placed weight: (a) or (b) above, after the
    FSDP gather."""
    if "b" in params:
        # no layer the model axis runs has one: the recurrent mixers'
        # products do (ROADMAP item 20c)
        raise NotImplementedError("a placed Dense with a bias")
    w = on_use(params["w"])
    pl = placement_of(w)
    if pl is None:                                   # split over data alone
        return x @ w
    if pl.dim == 0:                                 # (a) rows: the input dim
        full, own = pl.shape[pl.dim], w.shape[-2]
        if x.shape[-1] == full:
            x = copy_to(x, pl.axis)[..., pl.lo:pl.lo + own]
        elif x.shape[-1] != own:
            raise ValueError(f"input width {x.shape[-1]}: want {full} or "
                             f"the rank's {own}")
        return reduce_from(x @ w, pl.axis)
    y = copy_to(x, pl.axis) @ w                      # (b) columns
    return y if keep_sharded else gather_from(y, pl.axis, -1)


def embed(params, ids):
    """``Embedding.apply`` of a placed table: (c), or a gather of the
    rank's columns where the rule split the width."""
    t = on_use(params["table"])
    pl = placement_of(t)
    if pl is None:
        return t[ids]
    if pl.dim == 0:
        idx = ids - pl.lo
        mine = (idx >= 0) & (idx < pl.size)
        h = t[idx.clamp(0, pl.size - 1)]
        return reduce_from(h.masked_fill_(~mine[..., None], 0), pl.axis)
    return gather_from(t[ids], pl.axis, -1)


def attend(params, x):
    """``Embedding.attend`` of a placed table: local logits over the
    rank's vocabulary gathered (c), or partial logits over the rank's
    width reduced."""
    t = on_use(params["table"])
    pl = placement_of(t)
    if pl is None:
        return x @ t.T
    x = copy_to(x, pl.axis)
    if pl.dim == 0:
        return gather_from(x @ t.T, pl.axis, -1)
    return reduce_from(x[..., pl.lo:pl.lo + pl.size] @ t.T, pl.axis)
