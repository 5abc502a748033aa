"""Checkpoints in the reference's format, written and read with numpy
alone, and the bridge between its parameter tree and the port's.

``save_pytree`` writes ``ckpt_<step>.npz`` (arrays ``a0, a1, ...``) plus
``ckpt_<step>.json`` (the flattened path keys in the same order and each
leaf's dtype); lists are keyed ``#i`` and an empty list ``#empty``, as the
reference's ``save_pytree`` does, so each package reads the other's
checkpoints. A bfloat16 leaf is stored as its raw 2-byte words (numpy
dtype ``V2``, manifest dtype ``bfloat16``): numpy has no bfloat16, and
this is how a reference checkpoint's bfloat16 leaves read without
``ml_dtypes``.

Its ``TransformerLM`` tree keeps homogeneous layers stacked on a leading
``n_blocks`` axis under ``params["blocks"]`` (one entry per layer of the
repeating block) between the ``prefix`` and ``suffix`` lists; the port's
tree lists one dict per layer under ``params["layers"]``, in layer order.
``params_from_numpy`` and ``params_to_numpy`` convert between the two;
every other subtree (the untied ``head``, the forecast heads
``forecast.heads[t]``) has the same layout in both. A tree with no
stacked blocks (PixelCNN, PixelForecast, the discrete autoencoder, their
``_mask`` leaves included) has one layout in both packages and converts
leaf for leaf with ``tree_from_numpy`` and ``tree_to_numpy``.
"""
from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from repro_torch.sharding import tensor_parallel as tp


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}/#{i}" if prefix else f"#{i}"))
        if len(tree) == 0:
            out[prefix + "/#empty"] = np.zeros(0)
    else:
        out[prefix] = tree
    return out


def _to_numpy(x):
    """(array, manifest dtype) of a tensor or array leaf."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), \
                "bfloat16"
        x = t.numpy()
    a = np.asarray(x)
    return a, "bfloat16" if a.dtype.kind == "V" else str(a.dtype)


def save_pytree(tree, directory: str, step: int):
    """Write a tree of tensors or numpy arrays as ``ckpt_<step>``."""
    os.makedirs(directory, exist_ok=True)
    arrays = {}
    manifest = {"step": step, "keys": [], "dtypes": {}}
    for i, (k, v) in enumerate(sorted(_flatten(tree).items())):
        arrays[f"a{i}"], manifest["dtypes"][k] = _to_numpy(v)
        manifest["keys"].append(k)
    np.savez(os.path.join(directory, f"ckpt_{step:08d}.npz"), **arrays)
    with open(os.path.join(directory, f"ckpt_{step:08d}.json"), "w") as f:
        json.dump(manifest, f)


def latest_step(directory: str):
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.match(r"ckpt_(\d+)\.json", f))]
    return max(steps) if steps else None


def restore_pytree(directory: str, step: int, device=None):
    """The tree ``save_pytree`` wrote, as tensors of the stored dtypes
    (bfloat16 leaves as bfloat16) on ``device``."""
    return _map(load_pytree(directory, step),
                lambda a: _to_tensor(a, None, device))


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
    """A numpy leaf as a tensor of ``dtype`` (None: the stored dtype)."""
    a = np.asarray(x)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        # ml_dtypes bfloat16 (or its raw 2-byte void form in an npz): the
        # high half of a float32
        t = torch.from_numpy(np.array(a.view(np.int16))).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(dtype=dtype or t.dtype, device=device)


def tree_from_numpy(tree, dtype=None, device=None):
    """A nested dict/list tree of numpy arrays as tensors of ``dtype``
    (None: each leaf's own) on ``device``."""
    return _map(tree, lambda a: _to_tensor(a, dtype, device))


def tree_to_numpy(tree):
    """Inverse of ``tree_from_numpy``: numpy arrays of the tensors' dtypes
    (bfloat16 leaves as float32, which numpy can compute with)."""
    def conv(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return _map(tree, conv)


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


def reference_tree(params, cfg):
    """Inverse of ``params_from_numpy``: the port's parameters in the
    reference's tree layout (the repeating block's layers stacked on a
    leading ``n_blocks`` axis), tensors of the parameters' dtype. The
    stacked leaves are built on the host, so writing a checkpoint costs no
    device memory. ``save_pytree`` of it is a checkpoint either package
    loads. A placed tree (``sharding/tensor_parallel.py``, a rank's slices
    on a training mesh) is gathered whole first, leaf by leaf: every rank
    of the mesh calls this, and one writes."""
    if tp.is_placed(params):
        with torch.no_grad():
            params = tp.whole_tree(params)
    layers = params["layers"]
    n_pre, n_suf = len(cfg.layer_prefix), len(cfg.layer_suffix)
    per = len(cfg.layer_block)
    tree = {"embed": params["embed"],
            "prefix": layers[:n_pre],
            "suffix": layers[len(layers) - n_suf:],
            "final_norm": params["final_norm"]}
    if cfg.n_blocks:
        body = layers[n_pre:len(layers) - n_suf]
        tree["blocks"] = [_stack([body[i * per + s]
                                  for i in range(cfg.n_blocks)])
                          for s in range(per)]
    for key in ("head", "forecast"):
        if key in params:
            tree[key] = params[key]
    return tree


def params_to_numpy(params, cfg):
    """The reference's tree layout, as float32 numpy arrays."""
    return _map(reference_tree(params, cfg),
                lambda t: t.detach().float().cpu().numpy())


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack([t.detach().cpu() for t in trees])
