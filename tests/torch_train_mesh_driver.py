"""Child process of ``test_torch_train_mesh.py`` (not a test file). It
imports only the port, spawns the ranks of one scenario over gloo on the
CPU (``sharding.collectives.spawn``, one torch thread a rank), writes the
leaves it gathers whole into ``DIR`` (rank 0) and prints the ranks'
readings as one JSON list, rank by rank, on its last line.

* ``w4 DIR`` — world 4: reduced qwen3-1.7b at data 2 x model 2, then with
  ``no_tp`` (FSDP over both axes jointly); reduced dbrx-132b's MoE layer
  at data 2 x model 2 and under ``no_tp`` (capacity None and 1.25, an
  Adafactor step); an AdamW run's checkpoint written at 2 x 2; reduced
  dbrx-132b whole at data 2 x model 2 with two microbatches a step.
* ``w2 DIR`` — world 2: reduced qwen3-1.7b at data 1 x model 2, then the
  same ranks under ``no_tp``, then at data 2 x model 1 (a second
  layout's groups in the same world).

Each qwen layout: the step's loss, global norm and every leaf's gradient
gathered whole (``sync_grads`` after ``local_grads``), the same under each
planted fault that the layout can show (``chip_smoke.TRAIN_FAULTS``, the
model axis's under ``no_tp`` counted as data's), then two steps each
of SGD and AdamW and one of Adafactor from the same weights (``STEPS``),
the replicated leaves
checked bitwise across the ranks after every step; the inputs and the
single-process references come from ``DIR`` (weights from JAX's init).

* ``gpu BACKEND`` — world 2 on the card (``tests/test_torch_gpu.py``):
  reduced qwen3-1.7b in float32 (the port's weights, seed 0, TF32 off) at
  data 1 x model 2, both ranks on ``cuda:0`` over gloo, or a card each
  over NCCL: ``chip_smoke.train_mesh_layout`` (phase 24's layout: step 1
  against the single-device step on ``cuda:0``, the planted faults, two
  AdamW steps with flash on its kernel route).

Usage: ``python torch_train_mesh_driver.py {w4,w2} DIR`` or ``python
torch_train_mesh_driver.py gpu {gloo,nccl}``
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import optim  # noqa: E402
from repro_torch.checkpoint.io import (load_pytree, params_from_numpy,  # noqa: E402,E501
                                       reference_tree, save_pytree)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import ShardedTokenPipeline  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models.moe import MoE  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves, tree_map  # noqa: E402
from repro_torch.sharding import collectives  # noqa: E402
from repro_torch.sharding import tensor_parallel as tp  # noqa: E402
from repro_torch.sharding.collectives import JOINT  # noqa: E402

from chip_smoke import TRAIN_FAULTS, mesh_step_grads  # noqa: E402

CPU = torch.device("cpu")
LR = {"sgd": 0.1, "adamw": 1e-3, "adafactor": 1e-3}
STEPS = {"sgd": 2, "adamw": 2, "adafactor": 1}
MOE_AUX = 1.0           # the aux's weight in the MoE layer's test loss


def make_opt(name):
    return {"sgd": optim.sgd, "adamw": optim.adamw,
            "adafactor": optim.adafactor}[name](LR[name])


def flat(tree, prefix=""):
    """``{path: float32 numpy array}`` of a tree's leaves."""
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree)
                for k2, v2 in flat(tree[k], f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in flat(v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree.detach().float().cpu().numpy()}


def rel_errs(got: dict, want: dict) -> dict:
    """Each leaf's max |got - want| over max |want|."""
    return {k: float(np.abs(got[k] - w).max() / max(np.abs(w).max(), 1e-30))
            for k, w in want.items()}


def qwen_layout(axes, no_tp, tag, directory):
    """One layout's readings: see the module docstring."""
    d_, m_ = axes["data"].size, axes["model"].size
    cfg = get_config("qwen3-1.7b", reduced=True)
    ref = dict(np.load(directory / "ref.npz"))
    inp = np.load(directory / "inputs.npz")
    axis = train.batch_axis(axes, no_tp)
    n = inp["b0"].shape[0] // axis.size

    def rows(b):
        return torch.from_numpy(b[axis.rank * n:(axis.rank + 1) * n])

    def fresh():
        params = params_from_numpy(load_pytree(str(directory), 0), cfg,
                                   device=CPU)
        return tp.place_train_params(cfg, params, axes, no_tp)

    out = {"tag": tag, "data": d_, "model": m_, "no_tp": no_tp,
           "rank": axes[JOINT].rank}
    params = fresh()
    out["n_split"] = {k: sum(1 for t in tree_leaves(params)
                             if k in tp.placements_of(t))
                      for k in ("data", "model", JOINT)}
    step = train.shard_train_step(cfg, make_opt("sgd"), axes, remat=True,
                                  no_tp=no_tp)
    faults = [f for f, shows in TRAIN_FAULTS.items()
              if (shows(d_ * m_, 1) if no_tp else shows(d_, m_))]
    got, _ = mesh_step_grads(step, params, rows(inp["b0"]), axis, faults,
                             lambda g: flat(tp.whole_tree(g)))
    want = {k[5:]: v for k, v in ref.items() if k.startswith("grad/")}
    loss, gn, g = got.pop(None)
    errs = rel_errs(g, want)
    out["sound"] = {"loss": loss, "gnorm": gn,
                    "grad_rel": max(errs.values()), "by_leaf": errs}
    if axes[JOINT].rank == 0:
        np.savez(directory / f"grads_{tag}.npz", **g)
    out["faults"] = {f: {"gnorm": fgn,
                         "grad_rel": max(rel_errs(fg, want).values())}
                     for f, (_, fgn, fg) in got.items()}

    for name in LR:
        opt = make_opt(name)
        params = fresh()
        state = opt.init(params)
        step = train.shard_train_step(cfg, opt, axes, remat=True,
                                      no_tp=no_tp)
        losses = []
        for i, b in enumerate((inp["b0"], inp["b1"])[:STEPS[name]]):
            params, state, m = step(params, state, rows(b))
            tp.agree_replicas(params, {JOINT: axes[JOINT]},
                              f"{tag} {name} step {i + 1}")
            losses.append(float(m["loss"]))
        with torch.no_grad():
            got = {f"params/{k}": v for k, v in
                   flat(tp.whole_tree(params)).items()}
            slots = {k: v for k, v in state.items() if k != "step"}
            got.update({f"{k}/{p}": v for k, v in slots.items()
                        for p, v in flat(tp.whole_tree(v)).items()})
        errs = rel_errs(got, {k[len(name) + 1:]: v for k, v in ref.items()
                              if k.startswith(name + "/")})
        out[name] = {"losses": losses, "rel": max(errs.values()),
                     "by_leaf": errs}
        if name == "adamw" and tag == "2x2":
            tree = reference_tree(params, cfg)
            if axes[JOINT].rank == 0:
                save_pytree(tree, str(directory / "ckpt_2x2"), 2)
                np.savez(directory / "params_2x2.npz",
                         **{k[7:]: v for k, v in got.items()
                            if k.startswith("params/")})
    return out


def moe_layer(axes, no_tp, directory):
    """Reduced dbrx-132b's MoE layer at data 2 x model 2, or under
    ``no_tp`` (the experts split over the joint axis, each rank's own row):
    this rank's rows through the placed layer at capacity None and 1.25,
    the test loss sum(y * r) / D + MOE_AUX * aux / R (R the batch axis's
    ranks: summed over them, the per-data-rank emulation's gradient), its
    gradients gathered whole, then one Adafactor step on the placed leaves
    at 1.25. Rank 0 writes them."""
    data, model = axes["data"], axes["model"]
    axis = train.batch_axis(axes, no_tp)
    tag0 = "no_tp" if no_tp else "2x2"
    cfg = get_config("dbrx-132b", reduced=True)
    params = params_from_numpy(load_pytree(str(directory / "dbrx"), 0), cfg,
                               device=CPU)
    moe_i = next(i for i, (_, f) in enumerate(cfg.layer_specs())
                 if f == "moe")
    layer = tp.place_train_params(cfg, params, axes, no_tp)[
        "layers"][moe_i]["ffn"]
    inp = np.load(directory / "moe_inputs.npz")
    b = inp["x"].shape[0] // axis.size
    sl = slice(axis.rank * b, (axis.rank + 1) * b)
    out, saved = {}, {}
    for cap, tag in ((None, "none"), (1.25, "1.25")):
        p = tree_map(lambda t: tp.carry(t, t.detach().requires_grad_(True)),
                     layer)
        x = torch.from_numpy(inp["x"][sl]).requires_grad_(True)
        y, aux = MoE.apply(p, x, cfg, capacity_factor=cap)
        aux_w = 0.0 if cap is None else MOE_AUX
        loss = ((y.float() * torch.from_numpy(inp["r"][sl])).sum()
                / data.size + aux_w * aux / axis.size)
        leaves = tree_leaves(p)
        gl = torch.autograd.grad(loss, [x] + leaves)
        grads = tree_map(tp.carry, p, train.tree_unflatten(p, list(gl[1:])))
        grads = train.sync_grads(grads, axis)
        tp.agree_replicas(grads, {JOINT: axes[JOINT]}, f"router grad {tag}")
        with torch.no_grad():
            saved.update({f"{tag}/grad/{k}": v for k, v in
                          flat(tp.whole_tree(grads)).items()})
            saved[f"{tag}/y"] = axis.all_gather(y.detach(), 0).numpy()
            saved[f"{tag}/grad_x"] = axis.all_gather(gl[0], 0).numpy()
        out[f"aux_{tag}"] = float(aux.detach())
        if not no_tp:
            model.agree(y.detach().numpy().tobytes(), f"y {tag}")
        if cap is not None:
            opt = optim.adafactor(LR["adafactor"])
            state = opt.init(layer)
            opt.step(grads, state, layer)
            with torch.no_grad():
                saved.update({f"adafactor/{k}": v for k, v in
                              flat(tp.whole_tree(state["v"])).items()})
                saved.update({f"adafactor/params/{k}": v for k, v in
                              flat(tp.whole_tree(layer)).items()})
    if axes[JOINT].rank == 0:
        np.savez(directory / f"moe_{tag0}.npz", **saved)
    out["experts_local"] = int(layer["experts"]["up"].shape[0])
    out["split"] = sorted({k for t in tree_leaves(layer)
                           for k in tp.placements_of(t)})
    return out


def dbrx_accum(axes, directory):
    """Reduced dbrx-132b whole at data 2 x model 2 with ``accum_steps=2``:
    this rank's rows of ``dbrx_batch.npz`` cut by microbatch
    (``ShardedTokenPipeline``), step 1's gradient summed over the ranks
    and gathered whole (rank 0 writes it) and the metrics averaged over
    data, as the reference's step logs its last microbatch's."""
    cfg = get_config("dbrx-132b", reduced=True)
    params = tp.place_train_params(cfg, params_from_numpy(
        load_pytree(str(directory / "dbrx"), 0), cfg, device=CPU), axes)
    axis = train.batch_axis(axes)
    step = train.shard_train_step(cfg, make_opt("sgd"), axes, remat=True,
                                  accum_steps=2)
    rows = ShardedTokenPipeline(iter(()), CPU, axis, step.accum_steps).rows
    batch = np.load(directory / "dbrx_batch.npz")["b"]
    m, g = step.local_grads(params, torch.from_numpy(rows(batch)))
    metrics = train._mean_metrics(m, axis)
    g = train.sync_grads(g, axis)
    with torch.no_grad():
        got = flat(tp.whole_tree(g))
    if axes[JOINT].rank == 0:
        np.savez(directory / "grads_dbrx_accum.npz", **got)
    return {k: float(v) for k, v in metrics.items()}


def w4_rank(rank, world, store_path, directory):
    torch.set_num_threads(1)
    directory = Path(directory)
    axes = collectives.init_axes(rank, world, 2, store_path=store_path,
                                 backend="gloo")
    return {"2x2": qwen_layout(axes, False, "2x2", directory),
            "no_tp": qwen_layout(axes, True, "no_tp", directory),
            "moe": moe_layer(axes, False, directory),
            "moe_no_tp": moe_layer(axes, True, directory),
            "dbrx_accum": dbrx_accum(axes, directory)}


def w2_rank(rank, world, store_path, directory):
    torch.set_num_threads(1)
    directory = Path(directory)
    axes = collectives.init_axes(rank, world, 2, store_path=store_path,
                                 backend="gloo")
    out = {"1x2": qwen_layout(axes, False, "1x2", directory),
           "1x2_no_tp": qwen_layout(axes, True, "1x2_no_tp", directory)}
    axes = collectives.layout_axes(1, "gloo")
    out["2x1"] = qwen_layout(axes, False, "2x1", directory)
    return out


GPU_SPEC = dict(B=4, S=64, steps=2)


def gpu_rank(rank, world, store_path, backend, base):
    from repro_torch import kernels
    from chip_smoke import train_mesh_layout
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    kernels.build()
    torch.cuda.set_device(dev)
    cfg = get_config("qwen3-1.7b", reduced=True)
    axes = collectives.init_axes(rank, world, 2, store_path=store_path,
                                 backend=backend, device=dev)
    out = train_mesh_layout(cfg, axes, base, dev, GPU_SPEC)
    out["backend"] = axes["model"].backend
    return out


def gpu_main(backend):
    from repro_torch import kernels
    from chip_smoke import train_mesh_baseline
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build()
    cfg = get_config("qwen3-1.7b", reduced=True)
    base, single = train_mesh_baseline(cfg, torch.device("cuda", 0),
                                       GPU_SPEC)
    ranks = collectives.spawn(gpu_rank, 2, backend, base, timeout=300)
    return [dict(r, single=single) for r in ranks]


if __name__ == "__main__":
    scenario, arg = sys.argv[1:3]
    if scenario == "gpu":
        print(json.dumps(gpu_main(arg)))
    else:
        fn, world = {"w4": (w4_rank, 4), "w2": (w2_rank, 2)}[scenario]
        print(json.dumps(collectives.spawn(fn, world, arg, timeout=300)))
