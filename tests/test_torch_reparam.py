"""The port's ``core/reparam.py`` (Gumbel max, Appendix B's posterior
noise) and ``random.split`` against ``jax.random`` and the reference's
``repro.core.reparam``.

Tolerances: ``split``'s keys and the uniforms under a shaped draw are
integers or exact floats, compared bitwise; the Gumbel floats go through
two ``log``s that each round within one float32 ulp of XLA's, compared
within 1e-5 relative; ``posterior_gumbel`` against the reference's on the
same key within 1e-4 of the values' scale (its logsumexp and logaddexp
round in other orders). Its Appendix-B invariant, argmax(logits + eps) ==
x, holds exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import reparam as jreparam
from repro_torch.core import random as jr
from repro_torch.core import reparam

TINY = float(np.finfo(np.float32).tiny)


def _key_words(jkey):
    return np.asarray(jax.random.key_data(jkey)).astype(np.int64)


@pytest.mark.parametrize("seed,num", [(0, 2), (7, 3), (2 ** 31 + 11, 5)])
def test_split_bitwise(seed, num):
    want = _key_words(jax.random.split(jax.random.PRNGKey(seed), num))
    keys = jr.split(jr.prng_key(seed), num)
    got = np.array([[int(k[0]), int(k[1])] for k in keys])
    np.testing.assert_array_equal(got, want)
    # and a split of a split
    want2 = _key_words(jax.random.split(jax.random.split(
        jax.random.PRNGKey(seed))[1]))
    got2 = np.array([[int(k[0]), int(k[1])]
                     for k in jr.split(jr.split(jr.prng_key(seed))[1])])
    np.testing.assert_array_equal(got2, want2)


@pytest.mark.parametrize("shape", [(2, 9, 4), (3, 784, 2), (1, 12, 256)])
def test_shaped_noise_counts_the_flat_index(shape):
    """A shaped draw's counters are the flat index: the port's flat draw
    reshaped gives JAX's uniforms bitwise and its Gumbel floats within
    the two logs' ulps."""
    jkey = jax.random.PRNGKey(3)
    n = int(np.prod(shape))
    ju = np.asarray(jax.random.uniform(jkey, shape, minval=TINY))
    u = jr.uniform(jr.prng_key(3), n, minval=TINY).reshape(shape)
    np.testing.assert_array_equal(u.numpy(), ju)
    want = np.asarray(jreparam.gumbel(jkey, shape))
    got = reparam.gumbel(jr.prng_key(3), shape).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_categorical_sample_matches_reference():
    logits = np.random.default_rng(0).standard_normal((64, 10)).astype(
        np.float32)
    want = np.asarray(jreparam.categorical_sample(jax.random.PRNGKey(5),
                                                  jnp.asarray(logits)))
    got = reparam.categorical_sample(jr.prng_key(5),
                                     torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed,K,batch", [(0, 2, 1), (1, 3, 7), (2, 12, 4),
                                          (3, 7, 5), (4, 5, 64),
                                          (5, 256, 16)])
def test_posterior_gumbel_consistency(seed, K, batch):
    """argmax(logits + posterior_eps) equals the conditioning sample x,
    exactly (the reference's test_reparam.py invariant), and the noise
    agrees with the reference's on the same key."""
    rng = np.random.default_rng(seed)
    logits = (3.0 * rng.standard_normal((batch, K))).astype(np.float32)
    x = rng.integers(0, K, size=(batch,))
    eps = reparam.posterior_gumbel(jr.prng_key(seed),
                                   torch.from_numpy(logits),
                                   torch.from_numpy(x))
    rec = reparam.reparam_argmax(torch.from_numpy(logits), eps)
    np.testing.assert_array_equal(rec.numpy(), x)
    want = np.asarray(jreparam.posterior_gumbel(
        jax.random.PRNGKey(seed), jnp.asarray(logits), jnp.asarray(x)))
    scale = 1.0 + np.abs(want)
    assert (np.abs(eps.numpy() - want) <= 1e-4 * scale).all()


def test_posterior_gumbel_strictness():
    """Values off the argmax stay strictly below the max (no ties)."""
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(rng.standard_normal((64, 8)).astype(
        np.float32))
    x = torch.from_numpy(rng.integers(0, 8, size=(64,)))
    eps = reparam.posterior_gumbel(jr.prng_key(6), logits, x)
    vals = logits + eps
    mx = torch.gather(vals, -1, x[:, None])
    others = torch.where(torch.nn.functional.one_hot(x, 8).bool(),
                         -torch.inf, vals)
    assert bool((others < mx).all())


def test_posterior_gumbel_marginal():
    """Mixing x ~ softmax(mu) with eps ~ p(eps | x) recovers the standard
    Gumbel prior on eps (Appendix B, Eq. 12): mean Euler's gamma,
    variance pi^2 / 6, within the sampling error of 40,000 draws."""
    n, K = 40000, 3
    logits = torch.tensor([1.0, 0.0, -0.5]).expand(n, K)
    kx, ke = jr.split(jr.prng_key(3))
    x = reparam.categorical_sample(kx, logits)
    eps = reparam.posterior_gumbel(ke, logits, x)
    np.testing.assert_allclose(eps.mean(dim=0).numpy(),
                               np.full(K, np.euler_gamma), atol=0.03)
    np.testing.assert_allclose(eps.var(dim=0, unbiased=False).numpy(),
                               np.full(K, np.pi ** 2 / 6), atol=0.1)
