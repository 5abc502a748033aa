"""Quickstart, on the PyTorch port: predictive sampling of a PixelCNN.

Trains a tiny PixelCNN on procedural binary stroke images, then samples
with (a) ancestral sampling and (b) ARM fixed-point iteration (paper
Algorithm 2), and asserts that the samples are bit-identical while FPI
takes no more ARM calls. The port of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/quickstart_torch.py              # GPU
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import optim
from repro_torch.core import predictive_sampling as ps
from repro_torch.core import random as jr
from repro_torch.core.device import resolve_device
from repro_torch.core.reparam import gumbel
from repro_torch.data.synthetic import binary_strokes
from repro_torch.models.pixelcnn import PixelCNN, PixelCNNConfig
from repro_torch.optim.optimizers import tree_leaves, tree_unflatten


def train(params, loss_fn, data, steps, lr=2e-3, batch=32, log_every=50):
    """``steps`` AdamW steps of ``loss_fn(params, batch)`` on random batches
    of ``data``, the frozen leaves (the masks) zeroed."""
    opt = optim.adamw(lr)
    state = opt.init(params)
    rng = np.random.default_rng(0)
    for it in range(steps):
        idx = torch.from_numpy(rng.integers(0, data.shape[0], size=batch))
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        loss = loss_fn(tree_unflatten(params, leaves), data[idx.to(
            data.device)])
        grads = optim.zero_frozen(tree_unflatten(
            params, torch.autograd.grad(loss, leaves)))
        params, state = opt.step(grads, state, params)
        if (it + 1) % log_every == 0:
            print(f"  step {it + 1}: {float(loss.detach()):.3f}")
    return params


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200,
                    help="training steps")
    ap.add_argument("--samples", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = PixelCNNConfig(height=12, width=12, channels=1, categories=2,
                         filters=24, n_res=2, first_kernel=5)
    print(f"training a {cfg.filters}-filter PixelCNN on "
          f"{cfg.height}x{cfg.width} binary strokes on {dev} (bits/dim) ...")
    data = torch.from_numpy(binary_strokes(256, 12, 12, seed=0)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = train(PixelCNN.init(gen, cfg, device=dev),
                   lambda p, b: PixelCNN.bpd(p, b, cfg), data, args.steps)

    arm_fn = PixelCNN.make_arm_fn(params, cfg)
    eps = gumbel(jr.prng_key(7, dev), (args.samples, cfg.d, cfg.categories))
    with torch.no_grad():
        t0 = time.perf_counter()
        x_naive, st_naive = ps.ancestral_sample(arm_fn, eps)
        t_naive = time.perf_counter() - t0
        t0 = time.perf_counter()
        x_fpi, st_fpi = ps.predictive_sample(arm_fn, ps.fpi_forecast, eps)
        t_fpi = time.perf_counter() - t0

    exact = torch.equal(x_naive, x_fpi)
    print(f"\nancestral: {int(st_naive.arm_calls)} ARM calls "
          f"({t_naive:.2f}s)")
    print(f"FPI:       {int(st_fpi.arm_calls)} ARM calls ({t_fpi:.2f}s)")
    print(f"samples bit-identical: {exact}   "
          f"(paper claim 3: exact samples from the true model)")
    assert exact, "FPI's samples differ from ancestral sampling's"
    assert int(st_fpi.arm_calls) <= int(st_naive.arm_calls), (
        st_fpi.arm_calls, st_naive.arm_calls)

    img = x_fpi[0].reshape(12, 12).cpu().numpy()
    print("\na sample:")
    for row in img:
        print("  " + "".join("#" if v else "." for v in row))


if __name__ == "__main__":
    main()
