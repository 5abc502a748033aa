"""Checkpoints of the reference, read with numpy alone, and the bridge
between its parameter tree and the port's.

The reference's ``save_pytree`` writes ``ckpt_<step>.npz`` (arrays ``a0,
a1, ...``) plus ``ckpt_<step>.json`` (the flattened path keys in the same
order); lists are keyed ``#i`` and an empty list ``#empty``.

Its ``TransformerLM`` tree keeps homogeneous layers stacked on a leading
``n_blocks`` axis under ``params["blocks"]`` (one entry per layer of the
repeating block) between the ``prefix`` and ``suffix`` lists; the port's
tree lists one dict per layer under ``params["layers"]``, in layer order.
``params_from_numpy`` and ``params_to_numpy`` convert between the two;
every other subtree (the untied ``head``, the forecast heads
``forecast.heads[t]``) has the same layout in both.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

def load_pytree(directory: str, step: int):
    """The nested dict/list tree of numpy arrays ``save_pytree`` wrote."""
    with open(os.path.join(directory, f"ckpt_{step:08d}.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(directory, f"ckpt_{step:08d}.npz"))
    flat = {k: data[f"a{i}"] for i, k in enumerate(manifest["keys"])}
    return _unflatten(flat)


def _unflatten(flat):
    root = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        if parts[-1] != "#empty":
            node[parts[-1]] = val
    return _listify(root)


def _listify(node):
    if not isinstance(node, dict):
        return node
    if node == {}:
        return []
    if all(k.startswith("#") for k in node):
        idx = sorted(int(k[1:]) for k in node if k != "#empty")
        return [_listify(node[f"#{i}"]) for i in idx]
    return {k: _listify(v) for k, v in node.items()}


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _to_tensor(x, dtype, device):
    a = np.asarray(x)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        # ml_dtypes bfloat16 (or its raw 2-byte void form in an npz): the
        # high half of a float32
        bits = a.view(np.uint16).astype(np.uint32) << 16
        t = torch.from_numpy(bits.view(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(dtype=dtype, device=device)


def params_from_numpy(tree, cfg, device=None):
    """The reference's parameter tree (numpy arrays, stacked ``blocks``
    axis included) -> the port's, in ``cfg.param_dtype`` on ``device``."""
    dtype = cfg.param_dtype
    conv = lambda x: _to_tensor(x, dtype, device)  # noqa: E731
    layers = [_map(p, conv) for p in tree.get("prefix", [])]
    if cfg.n_blocks:
        blocks = tree["blocks"]
        for i in range(cfg.n_blocks):
            for spec_p in blocks:
                layers.append(_map(spec_p,
                                   lambda x: conv(np.asarray(x)[i])))
    layers += [_map(p, conv) for p in tree.get("suffix", [])]
    out = {"embed": _map(tree["embed"], conv), "layers": layers,
           "final_norm": _map(tree["final_norm"], conv)}
    for key in ("head", "forecast"):
        if key in tree:
            out[key] = _map(tree[key], conv)
    return out


def params_to_numpy(params, cfg):
    """Inverse of ``params_from_numpy``: the reference's tree layout, as
    float32 numpy arrays."""
    conv = lambda t: t.detach().float().cpu().numpy()  # noqa: E731
    layers = params["layers"]
    n_pre, n_suf = len(cfg.layer_prefix), len(cfg.layer_suffix)
    per = len(cfg.layer_block)
    tree = {"embed": _map(params["embed"], conv),
            "prefix": [_map(p, conv) for p in layers[:n_pre]],
            "suffix": [_map(p, conv)
                       for p in layers[len(layers) - n_suf:]],
            "final_norm": _map(params["final_norm"], conv)}
    if cfg.n_blocks:
        body = layers[n_pre:len(layers) - n_suf]
        tree["blocks"] = [
            _stack([_map(body[i * per + s], conv)
                    for i in range(cfg.n_blocks)])
            for s in range(per)]
    for key in ("head", "forecast"):
        if key in params:
            tree[key] = _map(params[key], conv)
    return tree


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return np.stack(trees)
