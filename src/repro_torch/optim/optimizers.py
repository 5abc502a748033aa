"""Optimizers as (init, update, step) triples over the port's parameter
trees (nested dicts and lists of tensors), the reference's optax-style
transformations without optax.

``update(grads, state, params) -> (updates, state)`` returns float32
updates, applied with ``apply_updates(params, updates)`` (``p + u`` in
float32, then cast to ``p``'s dtype), as the reference does.
``step(grads, state, params, grad_scale=None) -> (params, state)`` gives the
same numbers leaf by leaf and in place: each leaf's update is computed,
added to the parameter and dropped before the next leaf's, and the state
leaves are replaced one by one, so no float32 copy of the whole tree is
held (on DeepSeek-V3's 5.46 B parameters that copy alone is 21.8 GB).
``grad_scale`` multiplies each gradient leaf in float32 first, which is
what ``clip_by_global_norm`` returns, without materialising the clipped
tree. Leaves are visited in the reference's order (dict keys sorted).
``torch.optim`` is not used: its AdamW decays and rounds differently.

**Placed leaves** (``sharding/tensor_parallel.py``: a rank's slice of a
leaf split over "model", "data" or both). The state of a leaf is its
slice and carries its placement: AdamW's ``mu`` and ``nu`` are the slice's,
Adafactor's ``vr`` and ``vc`` follow the slice on the dims that survive the
mean; each mean of a factored moment over a split dim, the row mean of
``vr`` and the update's RMS are all-reduced over the axis that splits
them, and ``global_norm`` sums each slice's squares and all-reduces the
partial sums over the axes they are split on. So a rank's update of its
slice is the single-device update's slice, to the order of float sums.
The reference places its state with ``param_shardings(opt_shape)``, whose
paths start with the optimizer's own keys, so a state leaf there may be
split otherwise than its parameter; the values are the same.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.sharding import tensor_parallel as tp


class Optimizer(NamedTuple):
    init: Callable
    update: Callable
    step: Callable


def _paths(tree, prefix=()):
    """Key paths of the tensor leaves, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in _paths(tree[k],
                                                        prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [q for i, v in enumerate(tree) for q in _paths(v,
                                                              prefix + (i,))]
    return [prefix]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _set(tree, path, value):
    _get(tree, path[:-1])[path[-1]] = value


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the leaves at the same places
    of ``rest``), keeping dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *[r[k] for r in rest])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *[r[i] for r in rest])
               for i, v in enumerate(tree)]
        return tuple(out) if isinstance(tree, tuple) else out
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves in the reference's order (dict keys sorted)."""
    return [_get(tree, p) for p in _paths(tree)]


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves``, given in
    ``tree_leaves`` order."""
    out = tree_map(lambda x: x, like)
    for path, leaf in zip(_paths(like), leaves, strict=True):
        _set(out, path, leaf)
    return out


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def zero_frozen(tree):
    """Zero the gradients or updates of non-trainable buffers: any leaf
    under a dict key that starts with '_'."""
    if isinstance(tree, dict):
        return {k: (tree_map(torch.zeros_like, v) if k.startswith("_")
                    else zero_frozen(v)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [zero_frozen(v) for v in tree]
        return tuple(out) if isinstance(tree, tuple) else out
    return tree


def global_norm(tree):
    """sqrt(sum of squares) of all leaves, in float32. The squares of
    placed leaves are summed on each slice, in one partial sum per set of
    axes the leaves are split on (none, model, data, both, or the joint
    axis), and each partial sum is all-reduced over its axes: every
    element counts once, a replicated leaf's once. The groups' order is
    the leaves', the same on every rank."""
    groups: dict = {}
    for g in tree_leaves(tree):
        key = tuple(pl.axis for _, pl in sorted(tp.placements_of(g).items()))
        sq = torch.sum(torch.square(g.float()))
        groups[key] = sq if key not in groups else groups[key] + sq
    total = 0
    for axes, sq in groups.items():
        for axis in axes:
            sq = axis.all_reduce(sq)
        total = total + sq
    return torch.sqrt(total)


def clip_scale(gn, max_norm: float):
    return torch.clamp(max_norm / (gn + 1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to global norm <= max_norm, in float32; the norm)."""
    gn = global_norm(grads)
    scale = clip_scale(gn, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), gn


def _schedule(lr):
    if callable(lr):
        return lr
    return lambda step: lr


def _optimizer(init, hyper, leaf, slots) -> Optimizer:
    """Builds the triple from ``hyper(step) -> per-step scalars`` and
    ``leaf(g, p, leaf_state, scalars) -> (update, new leaf_state)``;
    ``slots`` names the state trees that hold one entry per leaf."""

    def update(grads, state, params):
        step = state["step"] + 1
        hp = hyper(step)
        updates = tree_map(lambda g: g, grads)
        new = {"step": step}
        new.update({k: tree_map(lambda x: x, state[k]) for k in slots})
        for path in _paths(grads):
            u, ls = leaf(_get(grads, path), _get(params, path),
                         {k: _get(state[k], path) for k in slots}, hp)
            _set(updates, path, u)
            for k in slots:
                _set(new[k], path, ls[k])
        return updates, new

    @torch.no_grad()
    def step_in_place(grads, state, params, grad_scale=None):
        step = state["step"] + 1
        hp = hyper(step)
        for path in _paths(grads):
            g = _get(grads, path)
            if grad_scale is not None:
                g = g.float() * grad_scale
            p = _get(params, path)
            u, ls = leaf(g, p, {k: _get(state[k], path) for k in slots}, hp)
            p.copy_(p + u)
            for k in slots:
                _set(state[k], path, ls[k])
        state["step"] = step
        return params, state

    return Optimizer(init, update, step_in_place)


def _step0(params):
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def sgd(lr) -> Optimizer:
    lr_fn = _schedule(lr)

    def init(params):
        return {"step": _step0(params)}

    def leaf(g, p, s, lr_t):
        if isinstance(lr_t, torch.Tensor):       # promote as jnp does
            g = g.to(torch.promote_types(g.dtype, lr_t.dtype))
        return -lr_t * g, {}

    return _optimizer(init, lr_fn, leaf, ())


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0,
          moment_dtype=torch.float32) -> Optimizer:
    """AdamW with decoupled weight decay; moments in ``moment_dtype``."""
    lr_fn = _schedule(lr)

    def init(params):
        def zeros(p):
            return tp.carry(p, torch.zeros_like(p, dtype=moment_dtype))
        return {"step": _step0(params), "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params)}

    def hyper(step):
        t = step.float()
        return 1.0 - b1 ** t, 1.0 - b2 ** t, lr_fn(step)

    def leaf(g, p, s, hp):
        bc1, bc2, step_size = hp
        g32 = g.float()
        mu = (b1 * s["mu"].float() + (1 - b1) * g32).to(moment_dtype)
        nu = (b2 * s["nu"].float() + (1 - b2) * g32 * g32).to(moment_dtype)
        m_hat = mu.float() / bc1
        v_hat = nu.float() / bc2
        u = -step_size * (m_hat / (torch.sqrt(v_hat) + eps)
                          + weight_decay * p.float())
        return u.float(), {"mu": tp.carry(p, mu), "nu": tp.carry(p, nu)}

    return _optimizer(init, hyper, leaf, ("mu", "nu"))


def _split_axis(p, dim: int):
    """The axis that splits the placed leaf ``p``'s dim ``dim``, or None."""
    dim %= p.ndim
    return next((pl.axis for pl in tp.placements_of(p).values()
                 if pl.dim == dim), None)


def _mean(x, dim: int, axis, keepdim: bool = False):
    """The mean of ``x`` over ``dim``, which ``axis`` (or None) splits in
    equal slices: the slices' means averaged over the axis."""
    m = torch.mean(x, dim=dim, keepdim=keepdim)
    if axis is None or axis.size == 1:
        return m
    return axis.all_reduce(m) / axis.size


def adafactor(lr, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0,
              weight_decay: float = 0.0) -> Optimizer:
    """Adafactor (Shazeer & Stern 2018): factored second moments for
    leaves of 2 or more dimensions, a plain one for vectors, no first
    moment, update clipping to RMS <= ``clip_threshold``. On a placed leaf
    the means over a split dim are taken over the axis (module
    docstring)."""
    lr_fn = _schedule(lr)

    def init(params):
        def per_leaf(p):
            if p.ndim >= 2:
                return {"vr": tp.reduced_placement(torch.zeros(
                            p.shape[:-1], dtype=torch.float32,
                            device=p.device), p, -1),
                        "vc": tp.reduced_placement(torch.zeros(
                            p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                            device=p.device), p, -2)}
            return {"v": tp.carry(p, torch.zeros_like(p,
                                                      dtype=torch.float32))}
        return {"step": _step0(params), "v": tree_map(per_leaf, params)}

    def hyper(step):
        return 1.0 - step.float() ** (-decay), lr_fn(step)

    def leaf(g, p, s, hp):
        beta2, step_size = hp
        v = s["v"]
        g32 = g.float()
        g2 = g32 * g32 + eps
        if p.ndim >= 2:
            rows, cols = _split_axis(p, -2), _split_axis(p, -1)
            vr = beta2 * v["vr"] + (1 - beta2) * _mean(g2, -1, cols)
            vc = beta2 * v["vc"] + (1 - beta2) * _mean(g2, -2, rows)
            del g2
            rfac = torch.rsqrt(vr / _mean(vr, -1, rows, keepdim=True)
                               + eps)
            cfac = torch.rsqrt(vc + eps)
            u = g32 * rfac[..., None] * cfac[..., None, :]
            new_v = {"vr": tp.reduced_placement(vr, p, -1),
                     "vc": tp.reduced_placement(vc, p, -2)}
        else:
            vv = beta2 * v["v"] + (1 - beta2) * g2
            u = g32 * torch.rsqrt(vv + eps)
            new_v = {"v": tp.carry(p, vv)}
        ms = torch.mean(u * u)
        for pl in tp.placements_of(p).values():
            ms = pl.axis.all_reduce(ms) / pl.axis.size
        rms = torch.sqrt(ms + 1e-30)
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        u = -step_size * (u + weight_decay * p.float())
        return u, {"v": new_v}

    return _optimizer(init, hyper, leaf, ("v",))
