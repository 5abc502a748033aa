"""Training launcher:

    python -m repro_torch.launch.train --arch qwen3-1.7b --steps 3 \\
        --batch 2 --seq 2048
    python -m repro_torch.launch.train --arch qwen3-1.7b --reduced \\
        --device cpu --steps 2 --batch 2 --seq 16 --log-every 1
    python -m repro_torch.launch.train --arch qwen3-1.7b --reduced \\
        --device cpu --mesh 2,2 --steps 2 --batch 4 --seq 16

Initializes random weights from seed 0 (or restores the latest checkpoint
of ``--ckpt-dir``), streams the synthetic token pipeline (with a config's
frontend, a random prefix of ``n_prefix_tokens`` embeddings per step,
drawn from ``fold_in(PRNGKey(0), step)`` as the reference draws it) and
runs ``make_train_step``: the loss and its gradient (accumulated over
``accum_steps`` microbatches in float32), ``zero_frozen``, clipping to a
global norm of 1, and the optimizer's update, applied leaf by leaf in
place. Runs on the GPU unless ``--device cpu``.

**The mesh.** ``--mesh D[,M]`` with ``D * M > 1`` spawns ``D * M`` rank
processes over ``torch.distributed`` (``launch/mesh.py:make_train_mesh``,
ranks model fastest; NCCL when each rank has a card of its own, gloo on a
shared card or the CPU; ``--mesh-devices`` names the ranks' devices, one
shared or one a rank), and each runs ``shard_train_step``, the port of
the reference's ``shard_jit_train_step``: the parameters and the
optimizer state placed by ``param_specs`` (tensor parallelism over
"model", FSDP over "data" on the next dim; ``REPRO_NO_TP=1``: FSDP over
both jointly), each rank's rows of every batch
(``data.pipeline.ShardedTokenPipeline``), the forward on placed leaves
(``sharding/tensor_parallel.py``, ``sharding/moe_shard.py``), the
backward through the differentiable collectives, and the optimizer on
each rank's slices. Rank 0 logs, the losses averaged over the batch's
ranks; ``--ckpt-dir`` saves the leaves gathered whole, written by rank 0,
and a restore loads on every rank and places. MLA and the recurrent mixers
on a mesh raise (ROADMAP item 20c).
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch import optim
from repro_torch.checkpoint.io import (latest_step, load_pytree,
                                       params_from_numpy, reference_tree,
                                       save_pytree)
from repro_torch.configs import get_config
from repro_torch.core import random as jr
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import ShardedTokenPipeline, TokenPipeline
from repro_torch.data.synthetic import token_batches
from repro_torch.models import frontends
from repro_torch.models.losses import lm_loss
from repro_torch.models.transformer import TransformerLM
from repro_torch.optim.optimizers import (clip_scale, global_norm, tree_leaves,
                                          tree_map, tree_unflatten)
from repro_torch.sharding import tensor_parallel as tp
from repro_torch.sharding.collectives import JOINT


def make_optimizer(cfg, steps: int = 10_000, peak_lr: float = 3e-4):
    """Adafactor for the configs of d_model >= 6144 (their AdamW moments
    would not fit), AdamW otherwise, both on a linear-warmup cosine."""
    sched = optim.linear_warmup_cosine(peak_lr, min(1000, steps // 10 + 1),
                                       steps)
    big = cfg.d_model >= 6144
    return optim.adafactor(sched) if big else optim.adamw(sched)


def make_train_step(cfg, optimizer, remat: bool = True,
                    accum_steps: int = 1):
    """``train_step(params, opt_state, batch, prefix_emb=None) ->
    (params, opt_state, metrics)``; the parameters and the optimizer state
    are updated in place. The loss is ``lm_loss``: MoE entries past the
    capacity factor ``TRAIN_MOE_CAPACITY`` (1.25) drop, as the reference
    trains. ``prefix_emb`` (B, n_prefix_tokens, d_model), the frontend's
    stand-in, is used where the config has a frontend and ignored
    otherwise, as in the reference. ``accum_steps > 1`` splits the batch's
    leading axis (and the prefix's) into microbatches and sums their
    gradients in float32; the metrics are then the last microbatch's, as in
    the reference."""
    return _train_step(cfg, optimizer, remat, accum_steps, None)


def batch_axis(axes: dict, no_tp: bool = False):
    """The axis a training mesh splits the batch over
    (``rules.batch_sharding``): "data", or under ``no_tp`` the joint
    axis."""
    return axes[JOINT] if no_tp else axes["data"]


def check_train_mesh(cfg) -> None:
    """What the training mesh does not run yet raises here: MLA and the
    recurrent mixers, whose weights are read other than through the
    placed layers."""
    other = sorted({m for m, f in cfg.layer_specs()
                    if m not in ("attn", "local")}
                   | {f for m, f in cfg.layer_specs()
                      if f not in ("dense", "moe")})
    if other:
        raise NotImplementedError(
            f"{cfg.name}: {other} on a training mesh is ROADMAP item 20c")


def shard_train_step(cfg, optimizer, axes: dict, remat: bool = True,
                     accum_steps: int = None, no_tp: bool = None):
    """The port of the reference's ``shard_jit_train_step``: ``train_step``
    as ``make_train_step``'s over parameters placed by
    ``tensor_parallel.place_train_params(cfg, params, axes, no_tp)`` (and
    the optimizer state made from them), on this rank's rows of the batch
    (and of the prefix). ``axes`` is this rank's (``collectives.
    init_axes``). ``accum_steps`` defaults to ``REPRO_ACCUM_STEPS`` (4 for
    d_model >= 6144, else 1) and ``no_tp`` to ``REPRO_NO_TP == "1"``, as in
    the reference.

    Each rank's loss is its rows' mean, and its gradient is taken of that
    mean over the R ranks of the batch's axis (``batch_axis``), so the
    gradients summed over those ranks are the global batch's: a leaf split
    over data gets the sum from ``fsdp_gather``'s backward, any other is
    all-reduced over the batch's axes it is not split on after the
    backward (``sync_grads``), and a model-axis split needs no sum, each
    model rank holding its slice's gradient or the same whole one. The
    metrics are averaged over the batch's ranks, values only.
    ``train_step.local_grads(params, batch, prefix_emb=None) -> (metrics,
    grads)`` is the step's gradient before ``sync_grads``, each leaf
    carrying its parameter's placement. ``train_step.accum_steps`` is the
    count in use: each rank's rows must be cut by it
    (``data.pipeline.ShardedTokenPipeline``), so that its microbatch ``i``
    holds its rows of the global microbatch ``i``. With ``remat`` each
    layer's forward, its collectives included, is recomputed in the
    backward (non-reentrant), in the same order on every rank."""
    if accum_steps is None:
        default = "4" if cfg.d_model >= 6144 else "1"
        accum_steps = int(os.environ.get("REPRO_ACCUM_STEPS", default))
    if no_tp is None:
        no_tp = os.environ.get("REPRO_NO_TP") == "1"
    if axes[JOINT].size > 1:
        check_train_mesh(cfg)
    return _train_step(cfg, optimizer, remat, accum_steps,
                       batch_axis(axes, no_tp))


def sync_grads(grads, axis):
    """``grads`` (placed like their parameters) with every leaf summed over
    the parts of ``axis`` (the batch's axis) it is not split on: over the
    whole axis, or under ``no_tp`` over "model" alone for a leaf split over
    "data" alone. Leaves are summed in one flat buffer per axis and
    dtype."""
    if axis.size == 1:
        return grads
    parts = axis.parts
    buckets: dict = {}
    leaves = tree_leaves(grads)
    for i, g in enumerate(leaves):
        pls = tp.placements_of(g)
        if JOINT in pls or (parts is None and "data" in pls):
            continue
        over = parts[1] if parts is not None and "data" in pls else axis
        buckets.setdefault((over, g.dtype), []).append(i)
    for (over, _), idx in buckets.items():
        flat = over.all_reduce(torch.cat([leaves[i].reshape(-1)
                                          for i in idx]))
        for i, part in zip(idx, flat.split([leaves[i].numel()
                                            for i in idx])):
            leaves[i] = tp.carry(leaves[i], part.view_as(leaves[i]))
    return tree_unflatten(grads, leaves)


def _train_step(cfg, optimizer, remat, accum_steps, axis):
    """``make_train_step``, and with ``axis`` (the batch's axis of a
    training mesh) ``shard_train_step``."""
    has_prefix = cfg.n_prefix_tokens > 0
    scale = 1.0 if axis is None else 1.0 / axis.size

    def grads_of(params, batch, prefix_emb):
        params_l = tree_leaves(params)
        leaves = [tp.carry(p, p.detach().requires_grad_(True))
                  for p in params_l]
        loss, metrics = lm_loss(tree_unflatten(params, leaves), cfg, batch,
                                prefix_emb if has_prefix else None,
                                remat=remat)
        grads = torch.autograd.grad(loss * scale if scale != 1.0 else loss,
                                    leaves)
        return ({k: v.detach() for k, v in metrics.items()},
                tree_unflatten(params, grads))

    def local_grads(params, batch, prefix_emb=None):
        if accum_steps == 1:
            metrics, grads = grads_of(params, batch, prefix_emb)
        else:
            B = batch.shape[0]
            if B % accum_steps:
                raise ValueError(f"batch {B} is not a multiple of "
                                 f"accum_steps {accum_steps}")

            def split(x):
                return x.reshape(accum_steps, B // accum_steps, *x.shape[1:])
            pes = ([None] * accum_steps if prefix_emb is None
                   else split(prefix_emb))
            grads = None
            for mb, pe in zip(split(batch), pes):
                metrics, g = grads_of(params, mb, pe)
                if grads is None:
                    grads = tree_map(lambda a: a.float(), g)
                else:
                    tree_map(lambda acc, a: acc.add_(a.float()), grads, g)
            grads = tree_map(lambda a: a / accum_steps, grads)
        return metrics, tree_map(tp.carry, params, grads)

    def train_step(params, opt_state, batch, prefix_emb=None):
        metrics, grads = local_grads(params, batch, prefix_emb)
        if axis is not None:
            grads = sync_grads(grads, axis)
            metrics = _mean_metrics(metrics, axis)
        grads = optim.zero_frozen(grads)
        gnorm = global_norm(grads)
        params, opt_state = optimizer.step(grads, opt_state, params,
                                           grad_scale=clip_scale(gnorm, 1.0))
        return params, opt_state, dict(metrics, grad_norm=gnorm)

    train_step.local_grads = local_grads
    train_step.accum_steps = accum_steps
    return train_step


def _mean_metrics(metrics, axis):
    """The metrics averaged over ``axis`` (values: the replicated outputs
    of the reference's step)."""
    if axis.size == 1:
        return metrics
    vals = axis.all_reduce(torch.stack([v.float() for v in metrics.values()]))
    return {k: v for k, v in zip(metrics, vals / axis.size)}


def main(argv=None):
    """Run the CLI; returns the trained parameters and the logged
    ``(step, loss)`` pairs (for drivers such as the examples; on a mesh,
    rank 0's pairs and no parameters)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    ap.add_argument("--mesh", default=None, metavar="DATA[,MODEL]",
                    help="train on a (DATA, MODEL) mesh, one process a "
                         "rank: FSDP over data, tensor parallelism over "
                         "model")
    ap.add_argument("--mesh-devices", default=None, metavar="D0,D1,...",
                    help="with --mesh: one device every rank shares, or "
                         "one a rank (default: a card a rank, or the CPU "
                         "with --device cpu)")
    args = ap.parse_args(argv)
    if args.mesh:
        from repro_torch.launch.serve import mesh_sizes
        data, model = mesh_sizes(args.mesh)
        if data * model > 1:
            return None, _spawn_ranks(args, data, model)
    return _train(args)


def _spawn_ranks(args, data, model):
    """The kernels built here (on a card) so the ranks load one build,
    then ``data * model`` processes, each ``_train`` as one rank. Returns
    rank 0's logged pairs."""
    from repro_torch.sharding import collectives
    if args.device != "cpu" and torch.cuda.is_available():
        from repro_torch import kernels
        kernels.build()
    return collectives.spawn(_rank_main, data * model, args, data,
                             model)[0]


def _rank_main(rank, world, store_path, args, data, model):
    from repro_torch.launch.mesh import make_train_mesh
    devices = (args.mesh_devices.split(",") if args.mesh_devices
               else ["cpu"] if args.device == "cpu" else None)
    mesh = make_train_mesh(data, model, devices, rank=rank,
                           store_path=store_path)
    return _train(args, mesh)[1]


def _train(args, mesh=None):
    device = (resolve_device(args.device) if mesh is None
              else mesh.devices[0])
    lead = mesh is None or mesh.axes[JOINT].rank == 0
    cfg = get_config(args.arch, reduced=args.reduced)
    optimizer = make_optimizer(cfg, args.steps, args.lr)
    start = 0
    if args.ckpt_dir and (s := latest_step(args.ckpt_dir)) is not None:
        params = params_from_numpy(load_pytree(args.ckpt_dir, s), cfg,
                                   device)
        start = s
        if lead:
            print(f"restored step {s}")
    else:
        params = TransformerLM.init(cfg, seed=0, device=device)
    host = token_batches(max(512, args.batch * 8), args.batch, args.seq,
                         cfg.vocab)
    if mesh is None:
        step_fn = make_train_step(cfg, optimizer, remat=False)
        pipe = TokenPipeline(host, device)
        rows = None
    else:
        no_tp = os.environ.get("REPRO_NO_TP") == "1"
        params = tp.place_train_params(cfg, params, mesh.axes, no_tp)
        step_fn = shard_train_step(cfg, optimizer, mesh.axes, remat=False,
                                   no_tp=no_tp)
        pipe = ShardedTokenPipeline(host, device,
                                    batch_axis(mesh.axes, no_tp),
                                    step_fn.accum_steps)
        rows = pipe.rows
        if lead:
            print(f"training on a (data {mesh.shape['data']}, model "
                  f"{mesh.shape['model']}) mesh, {mesh.world_size} ranks "
                  f"({mesh.backend})", flush=True)
    opt_state = optimizer.init(params)
    key = jr.prng_key(0, device)
    logged = []
    t0 = time.perf_counter()
    for it, batch in zip(range(start, args.steps), pipe):
        pre = frontends.random_prefix(jr.fold_in(key, it), cfg, args.batch)
        if rows is not None and pre is not None:
            pre = rows(pre)
        params, opt_state, m = step_fn(params, opt_state, batch, pre)
        if (it + 1) % args.log_every == 0:
            loss, xent = float(m["loss"]), float(m["xent"])
            logged.append((it + 1, loss))
            dt = (time.perf_counter() - t0) / args.log_every
            if mesh is not None:
                tp.agree_replicas(params, {JOINT: mesh.axes[JOINT]},
                                  f"step {it + 1}'s replicated leaves")
            if lead:
                print(f"step {it + 1} loss {loss:.4f} xent {xent:.4f} "
                      f"{dt * 1e3:.0f} ms/step", flush=True)
            t0 = time.perf_counter()
        if args.ckpt_dir and (it + 1) % args.ckpt_every == 0:
            tree = reference_tree(params, cfg)
            if lead:
                save_pytree(tree, args.ckpt_dir, it + 1)
    if lead:
        print("done")
    return params, logged


if __name__ == "__main__":
    main()
