"""Parameter, cache and batch placements for the production meshes: the
port of the reference's ``sharding/rules.py``.

Strategy (the reference's baseline):

* tensor parallel over "model": the expert dim (EP) when present, else
  the largest divisible weight dim (heads, d_ff and vocab end up there);
* ZeRO-3/FSDP over "data": the next largest divisible dim;
* multi-pod: pure data parallelism over "pod" (batch only);
* scanned-block leading axes and small tensors (< 64k elements)
  replicated.

The rules are size heuristics, not a name table, and they read the
reference's tree: the leaves of its repeating block are stacked on a
leading ``n_blocks`` axis under ``params["blocks"]``, where the port lists
one dict per layer under ``params["layers"]``
(``checkpoint.io.params_from_numpy``). So each port leaf is judged as its
counterpart in the reference's tree: a block layer's leaf by the stacked
shape (its element count against ``REPLICATE_BELOW``, the stacked axis
never split) under the reference's path (``["blocks", "<position in the
block>", ...]``), a prefix or suffix layer's under ``["prefix", "<i>",
...]`` / ``["suffix", "<i>", ...]``. The spec returned for a port leaf is
the reference's with the stacked axis dropped. Ties between equal dims go
to the lower index, as the reference's stable sort gives them.

A spec is a tuple with one entry per dimension (``None``, an axis name or
a tuple of axis names); the ``*_shardings`` functions return trees of
``NamedSharding(mesh, spec)`` mirroring the tree they were given. A mesh
is anything with ``shape`` (``{axis: size}``) and ``axis_names``:
``launch.mesh.Mesh``, or a stand-in with only those.
"""
from __future__ import annotations

import math

from repro_torch.sharding.api import NamedSharding, Rules

REPLICATE_BELOW = 64 * 1024

# module-level switch (the dry run's decode lowering in the reference):
# experts take the inference EP-only layout
MOE_INFERENCE_LAYOUT = False


def default_activation_rules(mesh, shard_embed: bool = False,
                             no_tp: bool = False) -> Rules:
    dp = ("pod", "data") if "pod" in mesh.axis_names else ("data",)
    if no_tp:
        # small-model scheme: the "model" axis becomes extra data
        # parallelism; no tensor-parallel activation collectives at all
        dpm = tuple(dp) + ("model",)
        return Rules({"batch": dpm, "seq": None, "embed": None,
                      "vocab": None, "experts": None, "heads": None})
    return Rules({
        "batch": dp,
        "seq": None,
        "embed": "model" if shard_embed else None,
        "vocab": "model",
        "experts": "model",
        "heads": "model",
    })


def decode_activation_rules(mesh) -> Rules:
    """Activation rules of the serving and decode path: verify-window rows
    over data parallelism, heads and vocab over "model"."""
    dp = ("pod", "data") if "pod" in mesh.axis_names else "data"
    return Rules({
        "batch": dp,
        "seq": None,
        "embed": None,
        "vocab": "model",
        "experts": "model",
        "heads": "model",
    })


def _by_size(dims, start):
    """Dim indices from ``start`` on, largest first, ties in index order."""
    return sorted(range(start, len(dims)), key=lambda i: -dims[i])


def _leaf_spec(path_names, leaf, mesh) -> tuple:
    """The spec of one parameter leaf of the reference's tree (its path
    names and its shape, stacked axis included)."""
    dims = list(leaf.shape)
    n = len(dims)
    model_n = mesh.shape["model"]
    data_n = mesh.shape["data"]
    in_blocks = bool(path_names) and path_names[0] == "blocks"
    start = 1 if in_blocks else 0          # never shard the scan axis

    # MoE: the router replicated, experts model on E, data on dim 1
    if "router" in path_names:
        return (None,) * n
    if "experts" in path_names:
        spec = [None] * n
        if MOE_INFERENCE_LAYOUT:
            # full EP: experts E-wise over both axes, no FSDP
            if dims[start] % (model_n * data_n) == 0:
                spec[start] = ("model", "data")
            elif dims[start] % model_n == 0:
                spec[start] = "model"
            return tuple(spec)
        if dims[start] % model_n == 0:
            spec[start] = "model"
        if n - start >= 2 and dims[start + 1] % data_n == 0:
            spec[start + 1] = "data"
        return tuple(spec)

    if math.prod(dims) < REPLICATE_BELOW:
        return (None,) * n

    spec = [None] * n
    used = None
    # 1) "model" (tensor parallel): the largest divisible dim
    for i in _by_size(dims, start):
        if dims[i] % model_n == 0:
            spec[i] = "model"
            used = i
            break
    # 2) "data" (FSDP): the largest remaining divisible dim
    for i in _by_size(dims, start):
        if i != used and dims[i] % data_n == 0:
            spec[i] = "data"
            break
    return tuple(spec)


def _leaf_spec_no_tp(path_names, leaf, mesh) -> tuple:
    """FSDP only: the largest divisible dim over ALL mesh axes (("pod",)
    "data", "model" flattened); small leaves replicated."""
    dims = list(leaf.shape)
    n = len(dims)
    if math.prod(dims) < REPLICATE_BELOW:
        return (None,) * n
    axes = tuple(a for a in ("pod", "data", "model") if a in mesh.axis_names)
    total = math.prod(mesh.shape[a] for a in axes)
    in_blocks = bool(path_names) and path_names[0] == "blocks"
    start = 1 if in_blocks else 0
    spec = [None] * n
    for i in _by_size(dims, start):
        if dims[i] % total == 0:
            spec[i] = axes
            return tuple(spec)
    for i in _by_size(dims, start):
        if dims[i] % mesh.shape["data"] == 0:
            spec[i] = "data"
            return tuple(spec)
    return tuple(spec)


def _cache_leaf_spec(path_names, leaf, mesh, batch: int) -> tuple:
    """KV caches and recurrent states: batch over dp when divisible,
    "model" over the largest remaining divisible dim."""
    dims = list(leaf.shape)
    n = len(dims)
    model_n = mesh.shape["model"]
    dp = ("pod", "data") if "pod" in mesh.axis_names else ("data",)
    dp_size = math.prod(mesh.shape[a] for a in dp)
    in_blocks = bool(path_names) and path_names[0] == "blocks"
    start = 1 if in_blocks else 0
    spec = [None] * n
    # batch axis: the first dim of size ``batch`` after the scan axis
    b_dim = next((i for i in range(start, n) if dims[i] == batch), None)
    if b_dim is not None and batch % dp_size == 0:
        spec[b_dim] = dp if len(dp) > 1 else dp[0]
    for i in _by_size(dims, start):
        if i != b_dim and spec[i] is None and dims[i] % model_n == 0:
            spec[i] = "model"
            break
    return tuple(spec)


def _strip_axes(spec, drop) -> tuple:
    """``spec`` with the mesh axes ``drop`` removed from every entry."""
    out = []
    for comp in spec:
        if comp is None:
            out.append(None)
            continue
        axes = (comp,) if isinstance(comp, str) else tuple(comp)
        kept = tuple(a for a in axes if a not in drop)
        out.append(None if not kept else
                   (kept[0] if len(kept) == 1 else kept))
    return tuple(out)


# ---------------------------------------------------------------------------
# The port's trees, judged as their counterparts in the reference's
# ---------------------------------------------------------------------------

class _Shape:
    """A leaf as the rules see it: only its shape."""
    __slots__ = ("shape",)

    def __init__(self, shape):
        self.shape = tuple(shape)


def reference_layer(cfg, i: int):
    """``(path names, stacked depth)`` of the port's layer ``i`` in the
    reference's tree: ``(["blocks", "<j>"], n_blocks)`` for the ``j``-th
    layer of a repeat of the block, ``(["prefix", "<i>"], 0)`` and
    ``(["suffix", "<i>"], 0)`` for the others."""
    pre, per = len(cfg.layer_prefix), len(cfg.layer_block)
    body = per * cfg.n_blocks
    if i < pre:
        return ["prefix", str(i)], 0
    if i < pre + body:
        return ["blocks", str((i - pre) % per)], cfg.n_blocks
    return ["suffix", str(i - pre - body)], 0


def map_reference(cfg, tree, fn):
    """``tree`` (the port's parameter or cache tree, tensors of any device,
    the meta device included) with each leaf replaced by ``fn(reference
    path names, a leaf of the reference's shape)``'s spec, the stacked axis
    dropped."""
    def rec(node, path):
        if isinstance(node, dict):
            return {k: rec(v, path + [str(k)]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [rec(v, path + [str(i)]) for i, v in enumerate(node)]
        names, depth = path, 0
        if path and path[0] == "layers":
            prefix, depth = reference_layer(cfg, int(path[1]))
            names = prefix + path[2:]
        shape = tuple(node.shape)
        spec = fn(names, _Shape(((depth,) if depth else ()) + shape))
        if depth:
            if spec[0] is not None:
                raise AssertionError(f"{names}: the stacked axis split")
            spec = spec[1:]
        return spec
    return rec(tree, [])


def _named(mesh, specs):
    if isinstance(specs, dict):
        return {k: _named(mesh, v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_named(mesh, v) for v in specs]
    return NamedSharding(mesh, specs)


def param_specs(cfg, params, mesh, no_tp: bool = False):
    """The spec of every leaf of the port's parameter tree."""
    leaf_fn = _leaf_spec_no_tp if no_tp else _leaf_spec
    return map_reference(cfg, params, lambda p, l: leaf_fn(p, l, mesh))


def param_shardings(cfg, params, mesh, no_tp: bool = False):
    """``NamedSharding`` tree mirroring the port's parameter tree.
    ``no_tp``: FSDP over all mesh axes instead of TP over "model"."""
    return _named(mesh, param_specs(cfg, params, mesh, no_tp))


def serving_param_specs(cfg, params, mesh):
    """``param_specs`` minus the data axes: the serving round runs every
    data shard on whole parameters, so only tensor parallelism over
    "model" survives."""
    drop = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return map_reference(cfg, params, lambda p, l: _strip_axes(
        _leaf_spec(p, l, mesh), drop))


def serving_param_shardings(cfg, params, mesh):
    return _named(mesh, serving_param_specs(cfg, params, mesh))


def cache_specs(cfg, cache, mesh, batch: int):
    """The spec of every leaf of a dense cache (``init_cache``)."""
    return map_reference(cfg, cache,
                         lambda p, l: _cache_leaf_spec(p, l, mesh, batch))


def cache_shardings(cfg, cache, mesh, batch: int):
    return _named(mesh, cache_specs(cfg, cache, mesh, batch))


def paged_cache_shardings(cfg, paged, mesh, data_axis: str = "data"):
    """The serving engine's paged cache: each pool's block dim or each
    state's slot dim over ``data_axis`` (``TransformerLM.
    paged_partition_specs``). The model axis is left off the pool: every
    model rank holds its data shard's whole pool, and attention runs on
    full heads there."""
    from repro_torch.models.transformer import TransformerLM
    return _named(mesh, TransformerLM.paged_partition_specs(
        cfg, paged, data_axis=data_axis))


def batch_sharding(mesh, no_tp: bool = False) -> NamedSharding:
    dp = ("pod", "data") if "pod" in mesh.axis_names else ("data",)
    if no_tp:
        dp = tuple(dp) + ("model",)
    return NamedSharding(mesh, (dp if len(dp) > 1 else dp[0],))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())
