"""The port's MLA layers, decoder, sampler and serving engine against the
JAX reference on a cut of reduced deepseek-v3-671b: its two layers both
``("mla", "dense")`` (no MoE), float32, forecast heads kept. The reference's
weights go through ``save_pytree``, the port's numpy reader and
``params_from_numpy``; inputs are made with numpy from a seed.

Tolerances: single layers 1e-5 (float32 matmuls and transcendental
functions of two libraries round differently); decoder logits 1e-4 (the
same, through two layers); integer outputs (``row_stats``, tokens, next
windows) bitwise under the same injected noise; served tokens bitwise
against the port's own solo sampler.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import save_pytree
from repro.configs import get_config as jax_get_config
from repro.engine.spec_decode import PredictiveSampler as JaxSampler
from repro.engine.spec_decode import make_eps_fn as jax_make_eps_fn
from repro.engine.spec_decode import verify_round as jax_verify_round
from repro.models.attention import MLAttention as JaxMLA
from repro.models.transformer import TransformerLM as JaxLM
from repro_torch.checkpoint.io import (load_pytree, params_from_numpy,
                                       params_to_numpy)
from repro_torch.configs import get_config
from repro_torch.engine.spec_decode import PredictiveSampler, verify_round
from repro_torch.models.attention import MLAttention
from repro_torch.models.transformer import TransformerLM
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.serving.admission import Request
from repro_torch.serving.engine import ServingEngine

CPU = torch.device("cpu")
EPS_KEY = jax.random.PRNGKey(9)
EPS_SEED = 9
_CUT = dict(n_layers=2, layer_prefix=(("mla", "dense"),) * 2)


@pytest.fixture(scope="module")
def deepseek(tmp_path_factory):
    cfg = dataclasses.replace(get_config("deepseek-v3-671b", reduced=True),
                              **_CUT)
    jcfg = dataclasses.replace(
        jax_get_config("deepseek-v3-671b", reduced=True), **_CUT)
    assert cfg.n_blocks == 0 and cfg.forecast_horizon == 2
    jparams = JaxLM.init(jax.random.PRNGKey(0), jcfg)
    d = tmp_path_factory.mktemp("deepseek_ckpt")
    save_pytree(jparams, str(d), step=1)
    params = params_from_numpy(load_pytree(str(d), 1), cfg)
    return cfg, jcfg, jparams, params


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _jax_eps_for_port(vocab):
    jeps = jax.jit(jax_make_eps_fn(EPS_KEY, vocab))

    def eps_fn(seq_ids, positions):
        return _t(jeps(jnp.asarray(seq_ids.numpy(), jnp.int32),
                       jnp.asarray(positions.numpy(), jnp.int32)))
    return eps_fn


def test_checkpoint_carries_mla_head_and_forecast_leaves(deepseek):
    cfg, _, jparams, params = deepseek
    mixer = params["layers"][0]["mixer"]
    assert sorted(mixer) == sorted(["wq_a", "q_norm", "wq_b", "wkv_a",
                                    "kv_norm", "wk_b", "wv_b", "wo"])
    assert params["head"]["w"].shape == (cfg.d_model, cfg.vocab)
    assert len(params["forecast"]["heads"]) == cfg.forecast_horizon
    back = params_to_numpy(params, cfg)
    want = jax.tree.map(np.asarray, jparams)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    # the port's own init builds the same tree
    mine = params_to_numpy(TransformerLM.init(cfg, seed=0, device=CPU), cfg)
    assert jax.tree.structure(mine) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(want)):
        assert a.shape == b.shape


def _shapes(tree, lead=()):
    """A dict/list tree's leaves as shape tuples, ``lead`` prepended."""
    if isinstance(tree, dict):
        return {k: _shapes(v, lead) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v, lead) for v in tree]
    return lead + tuple(tree.shape)


def test_full_depth_config_raises_on_moe_layers():
    """The full 61-layer model (3 dense-prefix + 58 MoE layers) builds its
    parameters and paged cache on the meta device, with the reference's
    tree structure and shapes (its MoE layers no longer raise)."""
    cfg = get_config("deepseek-v3-671b")
    assert (cfg.d_model, cfg.n_heads, cfg.kv_lora_rank, cfg.vocab) == (
        7168, 128, 512, 129280)
    params = TransformerLM.init(cfg, device="meta")
    layers = params["layers"]
    assert len(layers) == 61
    assert all(t.device.type == "meta" for t in tree_leaves(params))
    n_pre = len(cfg.layer_prefix)
    for layer in layers[n_pre:]:
        assert _shapes(layer) == _shapes(layers[n_pre])
    # the port's tree in the reference's layout: the MoE block's leaves
    # stacked on a leading axis of 58
    got = dict(_shapes({k: v for k, v in params.items() if k != "layers"}),
               prefix=_shapes(layers[:n_pre]), suffix=[],
               blocks=[_shapes(layers[n_pre], (cfg.n_blocks,))])
    jcfg = jax_get_config("deepseek-v3-671b")
    want = jax.eval_shape(lambda k: JaxLM.init(k, jcfg),
                          jax.random.PRNGKey(0))
    assert got == _shapes(want)
    experts = layers[n_pre]["ffn"]["experts"]
    assert experts["up"].shape == (256, 7168, 2048)
    assert experts["down"].shape == (256, 2048, 7168)
    cache = TransformerLM.init_paged_cache(cfg, 1, 4, 16, device="meta")
    assert len(cache["layers"]) == 61
    assert all(_shapes(c) == {"mixer": {"c_kv": (4, 16, 512),
                                        "k_rope": (4, 16, 64)}}
               for c in cache["layers"])


def _mla_layer0(params, jparams):
    return params["layers"][0]["mixer"], jparams["prefix"][0]["mixer"]


def test_mla_window_matches(deepseek):
    cfg, jcfg, jparams, params = deepseek
    p, jp = _mla_layer0(params, jparams)
    rng = np.random.default_rng(1)
    B, W, S = 2, 8, 32
    x = rng.standard_normal((B, W, cfg.d_model)).astype(np.float32)
    cc = rng.standard_normal((B, S, cfg.kv_lora_rank)).astype(np.float32)
    kc = rng.standard_normal((B, S, cfg.qk_rope_dim)).astype(np.float32)
    cl = np.array([3, 20], np.int32)
    y, c = MLAttention.window(p, _t(x), cfg, {"c_kv": _t(cc),
                                              "k_rope": _t(kc)}, _t(cl))
    jy, jc = JaxMLA.window(jp, jnp.asarray(x), jcfg,
                           {"c_kv": jnp.asarray(cc),
                            "k_rope": jnp.asarray(kc)}, jnp.asarray(cl))
    _close(y, jy, 1e-5)
    _close(c["c_kv"], jc["c_kv"], 1e-5)
    _close(c["k_rope"], jc["k_rope"], 1e-5)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mla_window_paged_matches(deepseek, use_kernel):
    """The gather fallback and the kernel path (the latent op's plain
    version here; the reference's Pallas kernel in interpret mode)."""
    cfg, jcfg, jparams, params = deepseek
    p, jp = _mla_layer0(params, jparams)
    rng = np.random.default_rng(2)
    B, W, bs, nb = 2, 8, 4, 6
    P = 1 + B * nb
    x = rng.standard_normal((B, W, cfg.d_model)).astype(np.float32)
    cp = rng.standard_normal((P, bs, cfg.kv_lora_rank)).astype(np.float32)
    kp = rng.standard_normal((P, bs, cfg.qk_rope_dim)).astype(np.float32)
    tables = (1 + rng.permutation(B * nb)).reshape(B, nb).astype(np.int32)
    cl = np.array([2, 13], np.int32)
    y, c = MLAttention.window_paged(
        p, _t(x), cfg, {"c_kv": _t(cp), "k_rope": _t(kp)}, _t(tables),
        _t(cl), use_kernel=use_kernel)
    jy, jc = JaxMLA.window_paged(
        jp, jnp.asarray(x), jcfg, {"c_kv": jnp.asarray(cp),
                                   "k_rope": jnp.asarray(kp)},
        jnp.asarray(tables), jnp.asarray(cl), use_kernel=use_kernel,
        interpret=True)
    _close(y, jy, 1e-5)
    # the committed latents are each framework's own projections
    _close(c["c_kv"][1:], np.asarray(jc["c_kv"])[1:], 1e-5)
    _close(c["k_rope"][1:], np.asarray(jc["k_rope"])[1:], 1e-5)


def test_decode_window_logits_match(deepseek):
    cfg, jcfg, jparams, params = deepseek
    rng = np.random.default_rng(3)
    B, L, W = 2, 9, 8
    toks = rng.integers(0, cfg.vocab, size=(B, L + W))
    cache = TransformerLM.init_cache(cfg, B, 32, device=CPU)
    jcache = JaxLM.init_cache(jcfg, B, 32)
    zero = np.zeros(B, np.int32)
    _, _, cache = TransformerLM.decode_window(params, cfg, _t(toks[:, :L]),
                                              cache, _t(zero))
    _, _, jcache = JaxLM.decode_window(jparams, jcfg,
                                       jnp.asarray(toks[:, :L]), jcache,
                                       jnp.asarray(zero))
    cl = np.full(B, L, np.int32)
    logits, h, _ = TransformerLM.decode_window(params, cfg, _t(toks[:, L:]),
                                               cache, _t(cl))
    jlogits, jh, _ = JaxLM.decode_window(jparams, jcfg,
                                         jnp.asarray(toks[:, L:]), jcache,
                                         jnp.asarray(cl))
    assert logits.shape == (B, W, cfg.vocab)
    _close(logits, jlogits, 1e-4)
    _close(h, jh, 1e-4)


@pytest.mark.parametrize("use_forecast_heads", [False, True])
def test_verify_round_row_stats_bitwise(deepseek, use_forecast_heads):
    """Three rounds from the same state under the same (JAX's) noise: the
    packed row stats, accepted tokens and next windows are equal, the
    windows filled by the forecast heads included."""
    cfg, jcfg, jparams, params = deepseek
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, cfg.vocab, size=(3, 6))
    s = PredictiveSampler(cfg, params, window=8, max_len=40,
                          eps_fn=_jax_eps_for_port(cfg.vocab), device=CPU)
    js = JaxSampler(jcfg, jparams, window=8, max_len=40, eps_key=EPS_KEY)
    st = s.init_state(prompts, 3)
    jst = js.init_state(jnp.asarray(prompts, jnp.int32), 3)
    target = np.array([10, 30, 6], np.int64)   # row 2 already done
    for _ in range(3):
        st, stats = verify_round(params, cfg, s.eps_fn, st, _t(target),
                                 use_forecast_heads=use_forecast_heads)
        jst, jstats = jax_verify_round(jparams, jcfg, js.eps_fn, jst,
                                       jnp.asarray(target, jnp.int32),
                                       use_forecast_heads=use_forecast_heads)
        np.testing.assert_array_equal(stats.numpy(), np.asarray(jstats))
        np.testing.assert_array_equal(st.tokens.numpy(),
                                      np.asarray(jst.tokens))
        np.testing.assert_array_equal(st.cand.numpy(), np.asarray(jst.cand))


def _solo(cfg, params, uid, prompt, new, use_forecast_heads):
    s = PredictiveSampler(cfg, params, window=8, max_len=64,
                          eps_key=EPS_SEED,
                          use_forecast_heads=use_forecast_heads, device=CPU)
    t, _ = s.generate(torch.as_tensor(prompt)[None], new,
                      seq_ids=torch.tensor([uid]))
    return t[0, :len(prompt) + new].numpy()


@pytest.mark.parametrize("use_forecast_heads", [False, True])
def test_engine_matches_port_solo_bitwise(deepseek, use_forecast_heads):
    """Ragged prompts, slot reuse, prefix hits and chunked prefill through
    the latent pools (gather fallback): every request equals its solo run
    bit for bit."""
    cfg, _, _, params = deepseek
    eng = ServingEngine(cfg, params, batch=2, window_max=8, max_len=64,
                        eps_key=EPS_SEED, block_size=4,
                        use_forecast_heads=use_forecast_heads, device=CPU)
    assert eng.use_forecast_heads == use_forecast_heads
    assert set(eng.paged["layers"][0]["mixer"]) == {"c_kv", "k_rope"}
    rng = np.random.default_rng(5)
    shared = rng.integers(0, cfg.vocab, size=9)
    traffic = [(0, rng.integers(0, cfg.vocab, size=3), 9),
               (1, np.concatenate([shared, rng.integers(0, cfg.vocab, 4)]),
                7),
               (2, np.concatenate([shared, rng.integers(0, cfg.vocab, 2)]),
                10)]
    for uid, p, n in traffic:
        eng.submit(Request(uid=uid, prompt=p, new_tokens=n))
    done = eng.run()
    assert sorted(r.uid for r in done) == [0, 1, 2]
    for r in done:
        assert r.ok
        ref = _solo(cfg, params, r.uid, r.prompt, r.new_tokens,
                    use_forecast_heads)
        np.testing.assert_array_equal(r.result, ref,
                                      err_msg=f"request {r.uid}")
    assert eng.export_metrics()["prefix_hits"] >= 1
    assert eng.pool.blocks_in_use() == 0
