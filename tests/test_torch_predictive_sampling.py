"""The port's Algorithms 1 and 2 (``repro_torch.core.predictive_sampling``)
against the JAX package's, bit for bit.

The oracle is a toy triangular ARM written twice, in jnp and in torch,
over shared numpy weights. Its logits, its shared representation ``h``
and its learned forecast's logits are sums of multiples of 1/8 below
2^10, which float32 holds exactly in any order of summation, so both
frameworks compute them bitwise; the Gumbel noise is drawn once with
numpy and fed to both. Tolerance: none. The samples ``x``, ``arm_calls``,
``per_sample_calls`` and ``converge_iter`` must equal JAX's exactly for
ancestral sampling, the fpi, zeros, predict-last and learned forecasts
(group 1 and group > 1) and Algorithm 2, and every sampler's ``x`` must
equal ancestral sampling's. The port's exactness is also held on its copy
of the reference's tanh toy ARM (float arithmetic, port only).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import predictive_sampling as jps
from repro_torch.core import predictive_sampling as ps

# (seed, d, K, B)
CASES = [(0, 8, 2, 1), (1, 12, 3, 2), (2, 16, 4, 3), (3, 24, 5, 4),
         (4, 10, 2, 4), (5, 20, 8, 2)]
METHODS = ["ancestral", "fpi", "zeros", "last", "learned_g1",
           "learned_group", "alg2"]
HD = 4          # width of the toy's h


def _dyadic(rng, shape, lim):
    """Multiples of 1/8 in [-lim, lim], float32."""
    return (rng.integers(-8 * lim, 8 * lim + 1, size=shape) / 8.0).astype(
        np.float32)


def toy_weights(seed, d, K):
    rng = np.random.default_rng(seed)
    m = _dyadic(rng, (d, d, K, K), 1)
    m *= np.tril(np.ones((d, d), np.float32), -1)[:, :, None, None]
    return {"m": m,                                   # (p, j, k, c), j < p
            "bias": _dyadic(rng, (d, K), 4),
            "emb": _dyadic(rng, (K, HD), 1),
            "tri": np.tril(np.ones((d, d), np.float32), -1),
            "fc": _dyadic(rng, (HD, 8, K), 1)}        # (h, window, K)


def group_of(d):
    return 4 if d % 4 == 0 else 2


def jax_toy(w, K):
    m, bias, emb, tri = (jnp.asarray(w[k]) for k in ("m", "bias", "emb",
                                                     "tri"))

    def arm_fn(x):
        oh = jax.nn.one_hot(x, K, dtype=jnp.float32)
        logits = bias[None] + jnp.einsum("bjk,pjkc->bpc", oh, m)
        h = jnp.einsum("pj,bjh->bph", tri, emb[x])
        return logits, h
    return arm_fn


def torch_toy(w, K):
    m, bias, emb, tri = (torch.from_numpy(w[k]) for k in ("m", "bias",
                                                          "emb", "tri"))

    def arm_fn(x):
        oh = torch.nn.functional.one_hot(x, K).float()
        logits = bias[None] + torch.einsum("bjk,pjkc->bpc", oh, m)
        h = torch.einsum("pj,bjh->bph", tri, emb[x])
        return logits, h
    arm_fn.h_shape = lambda B: (B, m.shape[0], HD)
    return arm_fn


def forecasts(w, d, method):
    """(JAX per-sample forecast, port batched forecast) of a method."""
    fc = w["fc"]
    g = 1 if method == "learned_g1" else group_of(d)
    window = 3 if g == 1 else 2 * g
    fj, ft = jnp.asarray(fc[:, :window]), torch.from_numpy(
        fc[:, :window].copy())
    jmod = lambda h: jnp.einsum("ph,hwk->pwk", h[::g], fj)        # noqa: E731
    tmod = lambda h: torch.einsum("bph,hwk->bpwk", h[:, ::g], ft)  # noqa: E731
    return (jps.make_learned_forecast(jmod, window, group=g),
            ps.make_learned_forecast(tmod, window, group=g))


def run(method, arm_j, arm_t, eps, w, d):
    ej, et = jnp.asarray(eps), torch.from_numpy(eps)
    if method == "ancestral":
        return jps.ancestral_sample(arm_j, ej), ps.ancestral_sample(arm_t, et)
    if method == "alg2":
        return (jps.fixed_point_sample(arm_j, ej),
                ps.fixed_point_sample(arm_t, et))
    if method.startswith("learned"):
        fj, ft = forecasts(w, d, method)
    else:
        fj, ft = {"fpi": (jps.fpi_forecast, ps.fpi_forecast),
                  "zeros": (jps.zeros_forecast, ps.zeros_forecast),
                  "last": (jps.predict_last_forecast,
                           ps.predict_last_forecast)}[method]
    return (jps.predictive_sample(arm_j, fj, ej),
            ps.predictive_sample(arm_t, ft, et))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("seed,d,K,B", CASES)
def test_samplers_bitwise_equal_jax_on_dyadic_toy(seed, d, K, B, method):
    w = toy_weights(seed, d, K)
    eps = np.random.default_rng(seed + 100).gumbel(
        size=(B, d, K)).astype(np.float32)
    arm_j, arm_t = jax_toy(w, K), torch_toy(w, K)
    (xj, sj), (xt, st) = run(method, arm_j, arm_t, eps, w, d)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    assert st.arm_calls == int(sj.arm_calls)
    np.testing.assert_array_equal(st.per_sample_calls.numpy(),
                                  np.asarray(sj.per_sample_calls))
    np.testing.assert_array_equal(st.converge_iter.numpy(),
                                  np.asarray(sj.converge_iter))
    x_ref, _ = ps.ancestral_sample(arm_t, torch.from_numpy(eps))
    assert torch.equal(xt, x_ref)
    assert st.arm_calls <= (d + 1 if method == "alg2" else d)


@pytest.mark.parametrize("method", ["learned_g1", "learned_group"])
def test_learned_forecast_clamps_the_anchor_of_finished_rows(method):
    """A finished row reaches the forecast with i == d, one anchor past
    the last: the port clamps it as ``dynamic_index_in_dim`` does, and
    gives JAX's forecasts bitwise beside a row that is still running."""
    d, K = 16, 4
    w = toy_weights(7, d, K)
    rng = np.random.default_rng(8)
    x = rng.integers(0, K, size=(2, d))
    prev = rng.integers(0, K, size=(2, d))
    eps = rng.gumbel(size=(2, d, K)).astype(np.float32)
    i = np.array([d, 5])
    h = np.array(jax_toy(w, K)(jnp.asarray(x))[1])
    fj, ft = forecasts(w, d, method)
    want = jax.vmap(fj)(jnp.asarray(x), jnp.asarray(h), jnp.asarray(prev),
                        jnp.asarray(eps), jnp.asarray(i))
    got = ft(torch.from_numpy(x), torch.from_numpy(h),
             torch.from_numpy(prev), torch.from_numpy(eps),
             torch.from_numpy(i))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[0].numpy(), prev[0])


def torch_tanh_toy(seed, d, K, hdim=16, temp=1.0):
    """The reference test's ``make_toy_arm`` in torch: logits[p] = MLP of
    the scaled cumulative sum of the embedded x[<p]."""
    g = torch.Generator().manual_seed(seed)
    emb = torch.randn((K, hdim), generator=g) * 0.5
    w1 = torch.randn((hdim, hdim), generator=g) * 0.5
    w2 = torch.randn((hdim, K), generator=g) * 0.5

    def arm_fn(x):
        e = torch.nn.functional.pad(emb[x], (0, 0, 1, 0))[:, :-1]
        scale = torch.sqrt(1.0 + torch.arange(x.shape[1]))[None, :, None]
        h = torch.tanh((torch.cumsum(e, dim=1) / scale) @ w1)
        return (h @ w2) / temp, h
    arm_fn.h_shape = lambda B: (B, d, hdim)
    return arm_fn, w2


@pytest.mark.parametrize("seed,d,K,B", [(0, 24, 4, 3), (1, 17, 8, 2),
                                        (2, 32, 3, 4)])
def test_every_sampler_equals_ancestral_on_tanh_toy(seed, d, K, B):
    arm_fn, w2 = torch_tanh_toy(seed, d, K)
    eps = torch.from_numpy(np.random.default_rng(seed).gumbel(
        size=(B, d, K)).astype(np.float32))
    x_ref, _ = ps.ancestral_sample(arm_fn, eps)
    # a learned forecast over h: anchor p's window of 3 from h[p]
    learned = ps.make_learned_forecast(
        lambda h: (h @ w2)[:, :, None, :].expand(-1, -1, 3, -1), 3)
    runs = [ps.fixed_point_sample(arm_fn, eps)] + [
        ps.predictive_sample(arm_fn, fc, eps)
        for fc in (ps.fpi_forecast, ps.zeros_forecast,
                   ps.predict_last_forecast, learned)]
    for x, stats in runs:
        assert torch.equal(x, x_ref)
        conv = stats.converge_iter
        assert (conv >= 1).all() and (conv <= stats.arm_calls).all()
        assert (stats.per_sample_calls <= stats.arm_calls).all()
    fpi_calls, alg2_calls = runs[1][1].arm_calls, runs[0][1].arm_calls
    assert fpi_calls <= d and abs(alg2_calls - fpi_calls) <= 1
