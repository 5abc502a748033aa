"""Training launcher:

    python -m repro_torch.launch.train --arch qwen3-1.7b --steps 3 \\
        --batch 2 --seq 2048
    python -m repro_torch.launch.train --arch qwen3-1.7b --reduced \\
        --device cpu --steps 2 --batch 2 --seq 16 --log-every 1

Initializes random weights from seed 0 (or restores the latest checkpoint
of ``--ckpt-dir``), streams the synthetic token pipeline (with a config's
frontend, a random prefix of ``n_prefix_tokens`` embeddings per step,
drawn from ``fold_in(PRNGKey(0), step)`` as the reference draws it) and
runs ``make_train_step``: the loss and its gradient (accumulated over
``accum_steps`` microbatches in float32), ``zero_frozen``, clipping to a
global norm of 1, and the optimizer's update, applied leaf by leaf in
place. One device and no sharding. Runs on the GPU unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import optim
from repro_torch.checkpoint.io import (latest_step, load_pytree,
                                       params_from_numpy, reference_tree,
                                       save_pytree)
from repro_torch.configs import get_config
from repro_torch.core import random as jr
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.data.synthetic import token_batches
from repro_torch.models import frontends
from repro_torch.models.losses import lm_loss
from repro_torch.models.transformer import TransformerLM
from repro_torch.optim.optimizers import (clip_scale, global_norm, tree_leaves,
                                          tree_map, tree_unflatten)


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
    has_prefix = cfg.n_prefix_tokens > 0

    def grads_of(params, batch, prefix_emb):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        loss, metrics = lm_loss(tree_unflatten(params, leaves), cfg, batch,
                                prefix_emb if has_prefix else None,
                                remat=remat)
        grads = torch.autograd.grad(loss, leaves)
        return ({k: v.detach() for k, v in metrics.items()},
                tree_unflatten(params, grads))

    def train_step(params, opt_state, batch, prefix_emb=None):
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
        grads = optim.zero_frozen(grads)
        gnorm = global_norm(grads)
        params, opt_state = optimizer.step(grads, opt_state, params,
                                           grad_scale=clip_scale(gnorm, 1.0))
        return params, opt_state, dict(metrics, grad_norm=gnorm)

    return train_step


def main(argv=None):
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
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    optimizer = make_optimizer(cfg, args.steps, args.lr)
    start = 0
    if args.ckpt_dir and (s := latest_step(args.ckpt_dir)) is not None:
        params = params_from_numpy(load_pytree(args.ckpt_dir, s), cfg,
                                   device)
        start = s
        print(f"restored step {s}")
    else:
        params = TransformerLM.init(cfg, seed=0, device=device)
    opt_state = optimizer.init(params)
    step_fn = make_train_step(cfg, optimizer, remat=False)
    pipe = TokenPipeline(token_batches(max(512, args.batch * 8), args.batch,
                                       args.seq, cfg.vocab), device)
    key = jr.prng_key(0, device)
    t0 = time.perf_counter()
    for it, batch in zip(range(start, args.steps), pipe):
        pre = frontends.random_prefix(jr.fold_in(key, it), cfg, args.batch)
        params, opt_state, m = step_fn(params, opt_state, batch, pre)
        if (it + 1) % args.log_every == 0:
            loss, xent = float(m["loss"]), float(m["xent"])
            dt = (time.perf_counter() - t0) / args.log_every
            print(f"step {it + 1} loss {loss:.4f} xent {xent:.4f} "
                  f"{dt * 1e3:.0f} ms/step", flush=True)
            t0 = time.perf_counter()
        if args.ckpt_dir and (it + 1) % args.ckpt_every == 0:
            save_pytree(reference_tree(params, cfg), args.ckpt_dir, it + 1)
    print("done")


if __name__ == "__main__":
    main()
