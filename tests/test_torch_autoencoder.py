"""The port's discrete autoencoder (paper §4.2) against the JAX package's:
encoder logits, the quantizer, the decoder, the MSE and its
straight-through gradient, on the reference's parameters; and the
reduced latent pipeline (encode, a PixelCNN prior over the latents,
predictive sampling, decode) in the port.

Tolerances: encoder logits and reconstructions 1e-4 absolute plus 1e-4
relative (strided and transposed convolutions summed in another order);
the latent codes bitwise (their top-2 logit margins are checked to exceed
the logits' gap); the MSE 1e-5 relative; gradients 1e-4 of each leaf's
largest gradient plus 1e-7.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.autoencoder import AutoencoderConfig as JConfig
from repro.models.autoencoder import DiscreteAutoencoder as JAE
from repro_torch.checkpoint.io import tree_from_numpy, tree_to_numpy
from repro_torch.configs import paper
from repro_torch.core import predictive_sampling as ps
from repro_torch.models.autoencoder import (AutoencoderConfig,
                                            DiscreteAutoencoder as AE)
from repro_torch.models.pixelcnn import PixelCNN
from repro_torch.optim.optimizers import tree_leaves, tree_unflatten

CFG = AutoencoderConfig(height=16, width=16, channels=3, width_filters=16,
                        latent_channels=2, latent_categories=8)
CONFIGS = {"test": CFG, "reduced": paper.AE_REDUCED}


def _setup(cfg, seed=0, B=2):
    jp = JAE.init(jax.random.PRNGKey(seed), JConfig(**vars(cfg)))
    x = np.random.default_rng(seed).uniform(
        -1, 1, size=(B, cfg.height, cfg.width, cfg.channels)).astype(
            np.float32)
    return jp, tree_from_numpy(jax.tree.map(np.asarray, jp)), x


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_encode_quantize_decode_match_reference(name):
    cfg = CONFIGS[name]
    jcfg = JConfig(**vars(cfg))
    jp, tp, x = _setup(cfg)
    jl = JAE.encode_logits(jp, jnp.asarray(x), jcfg)
    tl = AE.encode_logits(tp, torch.from_numpy(x), cfg)
    h, w = cfg.latent_hw
    assert tl.shape == (2, h, w, cfg.latent_channels, cfg.latent_categories)
    _close(tl, jl, 1e-4, 1e-4)
    # codes bitwise where the top-2 margin exceeds the logits' gap
    top2 = np.sort(np.asarray(jl), axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 1e-4
    jz, jst = JAE.quantize(jl)
    tz, tst = AE.quantize(tl)
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    _close(tst, jst, 1e-5)
    _close(AE.decode(tp, torch.from_numpy(np.asarray(jst)), cfg),
           JAE.decode(jp, jst, jcfg), 1e-4, 1e-4)
    xhat, z = AE.reconstruct(tp, torch.from_numpy(x), cfg)
    assert xhat.shape == x.shape and z.shape == (2, h, w,
                                                 cfg.latent_channels)
    _close(AE.mse_loss(tp, torch.from_numpy(x), cfg),
           JAE.mse_loss(jp, jnp.asarray(x), jcfg), 0, 1e-5)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_straight_through_gradient_matches_jax_grad(name):
    cfg = CONFIGS[name]
    jp, tp, x = _setup(cfg, seed=1)
    jg = jax.grad(lambda p: JAE.mse_loss(p, jnp.asarray(x),
                                         JConfig(**vars(cfg))))(jp)
    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    loss = AE.mse_loss(tree_unflatten(tp, leaves), torch.from_numpy(x), cfg)
    got = tree_to_numpy(list(torch.autograd.grad(loss, leaves)))
    want = [np.asarray(g) for g in jax.tree.leaves(jg)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, 1e-4 * np.abs(w).max() + 1e-7)
    # the encoder receives gradient through the quantizer
    n_enc = len(jax.tree.leaves(jg["dec"]))   # "dec" sorts before "enc"
    assert any(np.abs(g).max() > 0 for g in got[n_enc:])


def test_latent_pipeline_samples_exactly_and_decodes():
    """Reduced §4.2 in the port: encode images to latents, a PixelCNN
    prior over them samples by fpi exactly as by ancestral sampling, and
    the sampled codes decode to finite images."""
    cfg, lat = paper.AE_REDUCED, paper.LATENT_ARM_REDUCED
    _, tp, x = _setup(cfg, B=3)
    _, z = AE.reconstruct(tp, torch.from_numpy(x), cfg)
    assert z.shape == (3, lat.height, lat.width, lat.channels)
    arm = PixelCNN.make_arm_fn(PixelCNN.init(torch.Generator().manual_seed(3),
                                             lat, device="cpu"), lat)
    eps = torch.from_numpy(np.random.default_rng(4).gumbel(
        size=(2, lat.d, lat.categories)).astype(np.float32))
    z_ref, _ = ps.ancestral_sample(arm, eps)
    z_fpi, stats = ps.predictive_sample(arm, ps.fpi_forecast, eps)
    assert torch.equal(z_ref, z_fpi) and stats.arm_calls <= lat.d
    oh = torch.nn.functional.one_hot(
        z_fpi.reshape(2, lat.height, lat.width, lat.channels),
        lat.categories).float()
    xhat = AE.decode(tp, oh, cfg)
    assert xhat.shape == (2, cfg.height, cfg.width, cfg.channels)
    assert bool(torch.isfinite(xhat).all())
