"""The port's learned forecast heads (``core/forecasting.py``) and the
sampler's ``use_forecast_heads`` path against the JAX reference.

The heads are held against the reference's ``TokenForecast.apply`` within
1e-5 (float32 matmuls of two libraries). The sampler runs the reduced
deepseek-v3-671b cut to two ``("mla", "dense")`` layers with its two heads:
with the heads filling the window its tokens equal the port's own W = 1
run bitwise (forecasts gate acceptance only, never token values), and the
reference's sampler with the heads under the margin rule at 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.forecasting import TokenForecast as JaxForecast
from repro.core.forecasting import TokenForecastConfig as JaxForecastConfig
from repro.engine.spec_decode import PredictiveSampler as JaxSampler
from repro.engine.spec_decode import make_eps_fn as jax_make_eps_fn
from repro.models.transformer import TransformerLM as JaxLM
from repro_torch.checkpoint.io import _map, _to_tensor, params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.forecasting import TokenForecast, TokenForecastConfig
from repro_torch.engine.agreement import check_token_agreement, top2_margin
from repro_torch.engine.spec_decode import PredictiveSampler

CPU = torch.device("cpu")
EPS_KEY = jax.random.PRNGKey(7)
_CUT = dict(n_layers=2, layer_prefix=(("mla", "dense"),) * 2)

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



@pytest.fixture(scope="module")
def deepseek():
    cfg = dataclasses.replace(get_config("deepseek-v3-671b", reduced=True),
                              **_CUT)
    jcfg = dataclasses.replace(
        jax_get_config("deepseek-v3-671b", reduced=True), **_CUT)
    jparams = JaxLM.init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return cfg, jcfg, jparams, params_from_numpy(tree, cfg)


@pytest.mark.parametrize("hidden", [0, 24])
def test_token_forecast_apply_matches(hidden):
    D, V, T = 32, 96, 3
    jcfg = JaxForecastConfig(D, V, T, hidden)
    jp = JaxForecast.init(jax.random.PRNGKey(hidden + 1), jcfg)
    # non-zero biases, so the bias path is held too
    jp = jax.tree.map(lambda a: a + 0.01 * jnp.arange(a.shape[-1]), jp)
    p = _map(jax.tree.map(np.asarray, jp),
             lambda a: _to_tensor(a, torch.float32, CPU))
    h = np.random.default_rng(hidden).standard_normal((2, 5, D)).astype(
        np.float32)
    got = TokenForecast.apply(p, torch.from_numpy(h),
                              TokenForecastConfig(D, V, T, hidden))
    want = JaxForecast.apply(jp, jnp.asarray(h), jcfg)
    assert got.shape == (2, 5, T, V)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    if not hidden:
        # position 0 reads the zero state: its forecasts are the biases
        np.testing.assert_array_equal(got[:, 0].numpy(),
                                      np.asarray(want)[:, 0])


def test_forecast_heads_generate_equals_window_one_bitwise(deepseek):
    cfg, _, _, params = deepseek
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, size=(2, 3))
    t1, _ = PredictiveSampler(cfg, params, window=1, max_len=48, eps_key=7,
                              device=CPU).generate(prompts, 12)
    s = PredictiveSampler(cfg, params, window=6, max_len=48, eps_key=7,
                          use_forecast_heads=True, device=CPU)
    assert s.use_forecast_heads
    t6, st = s.generate(prompts, 12)
    np.testing.assert_array_equal(t1[:, :15].numpy(), t6[:, :15].numpy())
    assert st["rounds"] <= 12


def test_forecast_heads_generate_matches_jax_under_margin_rule(deepseek):
    cfg, jcfg, jparams, params = deepseek
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, size=(2, 5))
    s = PredictiveSampler(cfg, params, window=6, max_len=40, eps_key=7,
                          use_forecast_heads=True, device=CPU)
    js = JaxSampler(jcfg, jparams, window=6, max_len=40, eps_key=EPS_KEY,
                    use_forecast_heads=True)
    toks, stats = s.generate(prompts, 16)
    jtoks, jstats = js.generate(jnp.asarray(prompts, jnp.int32), 16)
    jeps = jax_make_eps_fn(EPS_KEY, cfg.vocab)
    for b in range(2):
        ref = np.asarray(jtoks[b, :21])

        def margin_at(p, ref=ref, b=b):
            logits, _, _ = JaxLM.apply(jparams, jcfg,
                                       jnp.asarray(ref[None, :p], jnp.int32))
            e = jeps(jnp.asarray([b], jnp.int32),
                     jnp.asarray([[p]], jnp.int32))
            return top2_margin(np.asarray(logits[0, -1] + e[0, 0]))
        res = check_token_agreement(ref, toks[b, :21].numpy(), margin_at,
                                    tol=1e-4, start=5)
        if res is None:     # identical streams: identical call counts
            assert stats["per_seq_calls"][b] == jstats["per_seq_calls"][b]
