"""Paper §4.2 end to end, on the PyTorch port: a discrete autoencoder, a
latent ARM and predictive sampling, trained in the paper's two phases.

  phase 1: train the straight-through-argmax autoencoder on MSE;
  phase 2: freeze it and train a PixelCNN on the encoder's latents jointly
           with its forecasting module (loss weight 0.01);
  sample:  FPI in latent space, asserted bitwise equal to ancestral
           sampling with no more ARM calls, then decoded to images.

Both training phases are written here. The port of
``examples/latent_autoencoder.py``.

    PYTHONPATH=src python examples/latent_autoencoder_torch.py
    PYTHONPATH=src python examples/latent_autoencoder_torch.py --device cpu
"""
import argparse

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import optim
from repro_torch.configs.paper import AE_REDUCED, LATENT_ARM_REDUCED, \
    forecast_cfg
from repro_torch.core import predictive_sampling as ps
from repro_torch.core import random as jr
from repro_torch.core.device import resolve_device
from repro_torch.core.forecasting import PixelForecast
from repro_torch.core.reparam import gumbel
from repro_torch.data.synthetic import quantized_textures
from repro_torch.models.autoencoder import DiscreteAutoencoder as AE
from repro_torch.models.losses import pixelcnn_loss
from repro_torch.models.pixelcnn import PixelCNN
from repro_torch.optim.optimizers import tree_leaves, tree_unflatten


def train(tree, loss_fn, data, steps, batch, lr=2e-3):
    """``steps`` AdamW steps of ``loss_fn(tree, batch)`` on random batches
    of ``data``, the frozen leaves zeroed; returns the tree and the last
    loss."""
    opt = optim.adamw(lr)
    state = opt.init(tree)
    rng = np.random.default_rng(0)
    loss = torch.tensor(float("nan"))
    for _ in range(steps):
        idx = torch.from_numpy(rng.integers(0, data.shape[0], size=batch))
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(tree)]
        loss = loss_fn(tree_unflatten(tree, leaves), data[idx.to(
            data.device)])
        grads = optim.zero_frozen(tree_unflatten(
            tree, torch.autograd.grad(loss, leaves)))
        tree, state = opt.step(grads, state, tree)
    return tree, float(loss.detach())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ae-steps", type=int, default=250,
                    help="phase 1 training steps")
    ap.add_argument("--arm-steps", type=int, default=250,
                    help="phase 2 training steps")
    ap.add_argument("--samples", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    ae_cfg, arm_cfg = AE_REDUCED, LATENT_ARM_REDUCED

    data = quantized_textures(512, ae_cfg.height, ae_cfg.width, 3, 256,
                              seed=0)
    x = torch.from_numpy(data).to(dev).float() / 127.5 - 1.0
    print(f"phase 1: training the discrete autoencoder on {dev} ...")
    gen = torch.Generator(device=dev).manual_seed(0)
    ae, mse = train(AE.init(gen, ae_cfg, device=dev),
                    lambda p, b: AE.mse_loss(p, b, ae_cfg), x,
                    args.ae_steps, batch=16)
    print(f"  MSE {mse:.4f} (paper: 0.0065 CIFAR10 at full scale)")

    print("phase 2: frozen encoder -> latents -> PixelCNN prior ...")
    with torch.no_grad():
        z, _ = AE.quantize(AE.encode_logits(ae, x, ae_cfg))
    fcfg = forecast_cfg(arm_cfg, horizon=1)
    gen = torch.Generator(device=dev).manual_seed(1)
    tree = {"arm": PixelCNN.init(gen, arm_cfg, device=dev),
            "forecast": PixelForecast.init(gen, fcfg, device=dev)}
    tree, loss = train(tree, lambda t, b: pixelcnn_loss(
        t["arm"], t["forecast"], b, arm_cfg, fcfg)[0], z, args.arm_steps,
        batch=32)
    print(f"  bits/dim + 0.01 KL: {loss:.4f}")

    print("sampling latents with fixed-point iteration ...")
    arm_fn = PixelCNN.make_arm_fn(tree["arm"], arm_cfg)
    eps = gumbel(jr.prng_key(3, dev),
                 (args.samples, arm_cfg.d, arm_cfg.categories))
    with torch.no_grad():
        z_ref, st_ref = ps.ancestral_sample(arm_fn, eps)
        z_fpi, st_fpi = ps.predictive_sample(arm_fn, ps.fpi_forecast, eps)
    exact = torch.equal(z_ref, z_fpi)
    print(f"  ancestral {int(st_ref.arm_calls)} calls vs "
          f"FPI {int(st_fpi.arm_calls)} calls; exact: {exact}")
    assert exact, "FPI's latents differ from ancestral sampling's"
    assert int(st_fpi.arm_calls) <= int(st_ref.arm_calls)

    z_img = z_fpi.reshape(args.samples, *ae_cfg.latent_hw,
                          ae_cfg.latent_channels)
    with torch.no_grad():
        xhat = AE.decode(ae, F.one_hot(z_img, ae_cfg.latent_categories)
                         .float(), ae_cfg)
    finite = bool(torch.isfinite(xhat).all())
    print(f"  decoded images: {tuple(xhat.shape)}, finite: {finite}")
    assert finite and xhat.shape == (args.samples, ae_cfg.height,
                                     ae_cfg.width, 3)


if __name__ == "__main__":
    main()
